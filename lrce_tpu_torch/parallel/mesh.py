"""Process groups, the train mesh and the port's spawner.

Counterpart of ``lrce_tpu/parallel/mesh.py``. ``lrce_tpu`` is one
controller over a ``jax.sharding.Mesh`` of every local chip; the port is one
process per card over ``torch.distributed``, as the reference's DDP trainer
is (NCCL on the card, gloo on the CPU):

  - ``init_distributed`` joins the process group: the torchrun contract
    (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``) or the arguments of ``spawn``. It selects the rank's card
    before anything touches it, and a failed rendezvous raises;
  - ``make_train_mesh`` is the ("data", "fsdp", "model") ``DeviceMesh`` over
    every rank; the batch shards over data x fsdp (``batch_ranks``), the
    text / fusion parameters over fsdp (ZeRO-3) and model (Megatron);
  - ``Layout`` holds what a rank needs of the mesh: its batch rank and
    count, the batch group (ranks with the same model index), the
    tensor-parallel group and the FSDP sub-mesh;
  - ``spawn`` runs a function on ``world_size`` fresh processes, one per
    card, over a file-store rendezvous in a temporary directory, and raises
    when any rank raises.
"""

from __future__ import annotations

import datetime
import os
import pickle
import tempfile
from typing import Any, Callable, NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist

AXES = ("data", "fsdp", "model")
DEFAULT_TIMEOUT = datetime.timedelta(minutes=10)
_ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")


def _env_int(name: str) -> Optional[int]:
    value = os.environ.get(name)
    return None if value is None else int(value)


def torchrun_env() -> bool:
    """Whether the torchrun contract's variables are all set."""
    return all(k in os.environ for k in _ENV)


def init_distributed(device=None, *, rank: Optional[int] = None,
                     world_size: Optional[int] = None,
                     local_rank: Optional[int] = None,
                     init_method: Optional[str] = None,
                     backend: Optional[str] = None,
                     timeout: Optional[datetime.timedelta] = None
                     ) -> torch.device:
    """Join the process group and return this rank's device.

    rank / world_size / local_rank / init_method come from the caller (the
    port's spawner, the tests' file store) or else from the torchrun
    environment. Without either, or at world size 1 without an init method,
    nothing is joined and ``device`` is returned as it is. On the card the
    rank's device is ``cuda:<local_rank>``, made current before anything
    else touches the card (the kernels launch on the current device); the
    backend is NCCL there and gloo on the CPU unless ``backend`` says
    otherwise. ``timeout`` (default ``DEFAULT_TIMEOUT``) bounds the
    rendezvous and every collective. A rendezvous that fails raises: a run
    never carries on as separate one-rank runs."""
    device = torch.device("cuda" if device is None else device)
    if rank is None and torchrun_env():
        rank, world_size = _env_int("RANK"), _env_int("WORLD_SIZE")
        local_rank = _env_int("LOCAL_RANK")
        init_method = init_method or "env://"
    if rank is None or world_size is None or (world_size == 1
                                               and init_method is None):
        return device
    local_rank = rank if local_rank is None else local_rank
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a CUDA rank was asked for but CUDA is not "
                               "available")
        if device.index is None:
            device = torch.device("cuda", local_rank)
        torch.cuda.set_device(device)
    if dist.is_initialized():
        if (dist.get_rank(), dist.get_world_size()) != (rank, world_size):
            raise RuntimeError(
                f"a process group of rank {dist.get_rank()} / "
                f"{dist.get_world_size()} is already joined; asked for "
                f"{rank} / {world_size}")
        return device
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    try:
        dist.init_process_group(
            backend, init_method=init_method, rank=rank,
            world_size=world_size, timeout=timeout or DEFAULT_TIMEOUT,
            device_id=device if backend == "nccl" else None)
    except Exception as e:
        raise RuntimeError(
            f"rendezvous of rank {rank} / {world_size} over {init_method!r} "
            f"({backend}) failed; refusing to carry on as a one-rank run"
        ) from e
    return device


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def global_rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def train_mesh_shape(n: int, fsdp: int = 1, model: int = 1) -> dict:
    """{"data": n / (fsdp * model), "fsdp": fsdp, "model": model}; the same
    error as lrce_tpu's make_train_mesh when the product does not divide
    the device count."""
    if fsdp < 1 or model < 1 or n % (fsdp * model) != 0:
        raise ValueError(
            f"--fsdp {fsdp} x --tensor-parallel {model} must divide the "
            f"device count ({n})")
    return {"data": n // (fsdp * model), "fsdp": fsdp, "model": model}


def make_train_mesh(fsdp: int = 1, model: int = 1, device_type: str = "cuda"):
    """The ("data", "fsdp", "model") DeviceMesh over every rank of the
    process group (one rank when none is joined)."""
    from torch.distributed.device_mesh import init_device_mesh

    shape = train_mesh_shape(world_size(), fsdp, model)
    return init_device_mesh(device_type, tuple(shape[a] for a in AXES),
                            mesh_dim_names=AXES)


def batch_ranks(mesh) -> tuple:
    """(this rank's batch shard, the number of batch shards): the batch
    shards over data x fsdp, as lrce_tpu's ``batch_axes``; the ranks of one
    tensor-parallel group take the same shard."""
    fsdp = mesh.size(AXES.index("fsdp"))
    coord = mesh.get_coordinate()
    return (coord[0] * fsdp + coord[1],
            mesh.size(AXES.index("data")) * fsdp)


class Layout(NamedTuple):
    """What a rank needs of the train mesh."""
    mesh: Any                       # the DeviceMesh
    batch_rank: int
    n_batch: int
    batch_group: Any                # ranks with this rank's model index;
                                    # None when one tensor-parallel group
                                    # takes the whole batch
    model_rank: int
    n_model: int
    tp_group: Any                   # None without tensor parallelism
    n_fsdp: int
    fsdp_mesh: Any                  # None without FSDP

    @property
    def world(self) -> int:
        return self.n_batch * self.n_model


def make_layout(fsdp: int = 1, model: int = 1,
                device_type: str = "cuda") -> Layout:
    """The mesh and this rank's groups. Every rank must call it, in the same
    order as every other collective setup."""
    mesh = make_train_mesh(fsdp, model, device_type)
    batch_rank, n_batch = batch_ranks(mesh)
    if model == 1:
        # every rank holds the whole model: DDP or FSDP over all of them,
        # a one-rank group included (its step runs DDP's all-reduce too)
        batch_group = dist.group.WORLD
    elif n_batch == 1:
        batch_group = None
    else:
        batch_group, _ = dist.new_subgroups_by_enumeration(
            [mesh.mesh[:, :, m].flatten().tolist() for m in range(model)])
    coord = mesh.get_coordinate()
    fsdp_mesh = None
    if fsdp > 1:
        fsdp_mesh = (mesh["fsdp"] if mesh.size(0) == 1
                     else mesh["data", "fsdp"])
    return Layout(mesh, batch_rank, n_batch, batch_group, coord[2], model,
                  mesh.get_group("model") if model > 1 else None, fsdp,
                  fsdp_mesh)


# ---------------------------------------------------------------------------
# The spawner
# ---------------------------------------------------------------------------

RESULT_FILE = "rank0_result.pkl"


def _rank_main(rank: int, fn: Callable, world: int, init_method: str,
               device: str, backend: Optional[str], threads: int,
               timeout: datetime.timedelta, tmp: str, args: Sequence) -> None:
    if threads:
        torch.set_num_threads(threads)
    dev = init_distributed(device, rank=rank, world_size=world,
                           local_rank=rank, init_method=init_method,
                           backend=backend, timeout=timeout)
    try:
        out = fn(dev, *args)
        if rank == 0:
            with open(os.path.join(tmp, RESULT_FILE), "wb") as f:
                pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, world: int, args: Sequence = (), *,
          device: str = "cuda", backend: Optional[str] = None,
          threads: int = 0,
          timeout: Optional[datetime.timedelta] = None) -> Any:
    """Run ``fn(rank_device, *args)`` on ``world`` new processes joined in
    one process group and return rank 0's result (which must pickle).

    ``fn`` must be importable from the package (the processes start fresh
    and import it). Each rank's card is ``cuda:<rank>`` unless ``device``
    names one card for all of them (then ``backend`` must be gloo: NCCL
    refuses two ranks on one card); ``threads`` > 0 sets each rank's torch
    threads; ``timeout`` (default ``DEFAULT_TIMEOUT``, read at the call)
    bounds every rank's rendezvous and collectives. An exception in any rank ends the others and is raised here
    (``torch.multiprocessing.ProcessRaisedException``)."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="lrce_spawn_") as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        mp.spawn(_rank_main, args=(fn, world, init, device, backend, threads,
                                   timeout or DEFAULT_TIMEOUT, tmp,
                                   tuple(args)),
                 nprocs=world, join=True)
        with open(os.path.join(tmp, RESULT_FILE), "rb") as f:
            return pickle.load(f)
