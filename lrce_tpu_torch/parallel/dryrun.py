"""One train step and one eval step of the whole model over n ranks.

Counterpart of ``__graft_entry__.dryrun_multichip`` (its
``_dryrun_multichip_impl``): the same tiny configuration, the same mesh by
n (data only; data x model at 4; data x fsdp x model at 8), the global
batch of one question per batch rank, one AgentOE train step and one eval
step with finite losses, and where there is an fsdp axis the ZeRO
evidence: the word embedding and its AdamW moment are stored as shards.
The ranks are processes over gloo on the CPU, or over NCCL with one card
each. The JAX package's re-exec onto n virtual devices has no counterpart
(the spawner starts the n processes), nor its Pallas-on-mesh check (each
rank runs the CUDA kernels on its own clips; ``chip_smoke.py`` drives
them across ranks).
"""

from __future__ import annotations

import argparse
import math

import numpy as np
import torch

from lrce_tpu_torch.models import bert as B
from lrce_tpu_torch.models import e2e as E
from lrce_tpu_torch.models import swin3d as S
from lrce_tpu_torch.parallel import mesh as PM

TINY = E.E2EConfig(
    feature_dim=24, num_classes=11, drop_out_rate=0.1,
    video_feature_res=(4, 4), video_feature_dim=16, frame_sample_size=5,
    temporal_scale=(1, 2), text_seq_len=8, task_type="oe",
    bert=B.BertConfig(vocab_size=64, hidden_size=24, num_layers=2,
                      num_heads=2, intermediate_size=48,
                      max_position_embeddings=16, type_vocab_size=2),
    swin=S.SwinConfig(patch_size=(2, 4, 4), embed_dim=16, depths=(2,),
                      num_heads=(2,), window_size=(2, 3, 3),
                      drop_path_rate=0.1))


def dryrun_args() -> argparse.Namespace:
    """The dry run's training arguments (``_dryrun_multichip_impl``'s)."""
    return argparse.Namespace(
        dataset="dryrun", log_dir="runs/dryrun", ckpt_interval=100,
        batch_size=1, eval_per_epoch=1, epoch=1, drop_out_rate=0.1,
        lr=[1e-4, 1e-4, 1e-4], min_lr=1e-8, temporal_scale=[1, 2],
        lr_decay_factor=0.5, lr_warm_up=0.1, lr_restart_epoch=2,
        lr_restart_mul=1, use_cosine_scheduler=True, reg_strength=0.001,
        num_workers=0, use_hinge_loss=False, debug_mode=True,
        sanity_check=False)


def mesh_for(n: int) -> tuple:
    """(fsdp, model) for n ranks, as the JAX dry run chooses its mesh."""
    if n >= 8 and n % 4 == 0:
        return 2, 2
    if n >= 4 and n % 2 == 0:
        return 1, 2
    return 1, 1


def dryrun_batch(n_batch: int):
    """The global batch: one question per batch rank, from a seed."""
    rng = np.random.RandomState(0)
    return (rng.rand(n_batch, 3, 5, 16, 16, 3).astype(np.float32),
            rng.randint(0, 64, (n_batch, 8)),
            np.ones((n_batch, 8), np.int64),
            np.zeros((n_batch, 8), np.int64),
            rng.randint(0, 11, (n_batch,)).astype(np.int64))


def _rank(device: torch.device, n: int) -> dict:
    from torch.distributed.tensor import DTensor

    from lrce_tpu_torch.train.agent import AgentOE

    fsdp, model_axis = mesh_for(n)
    layout = PM.make_layout(fsdp, model_axis, device.type)
    model = E.LRCEModel(TINY, device=device)
    agent = AgentOE(model, dryrun_args(), log_enabled=False, layout=layout)
    agent.lrs = [1e-4] * 3
    batch = [np.split(b, layout.n_batch)[layout.batch_rank]
             for b in dryrun_batch(layout.n_batch)]
    loss, _, total = agent.step(*batch, is_train=True)
    if not math.isfinite(loss):
        raise RuntimeError(f"non-finite train loss {loss}")
    if total != layout.n_batch:
        raise RuntimeError(f"the global batch counted {total} questions, "
                           f"expected {layout.n_batch}")
    loss_e, _, _ = agent.step(*batch, is_train=False)
    if not math.isfinite(loss_e):
        raise RuntimeError(f"non-finite eval loss {loss_e}")
    out = {"mesh": dict(zip(PM.AXES, layout.mesh.shape)), "loss": loss,
           "eval_loss": loss_e, "total": total}
    if fsdp > 1:
        w = model.text_extractor.bert.embeddings.word_embeddings.weight
        mu = agent.optimizer.state[w]["exp_avg"]
        for what, t in (("word embedding", w), ("its AdamW moment", mu)):
            if not (isinstance(t, DTensor)
                    and t.to_local().numel() < t.numel()):
                raise RuntimeError(f"fsdp axis present but the {what} is "
                                   "not stored as shards")
        out["word_shard"] = (tuple(w.to_local().shape), tuple(w.shape))
    return out


def dryrun_multichip(n: int, device: str = "cpu") -> dict:
    """Run the dry run on n ranks (gloo processes on the CPU, one card each
    on CUDA) and return rank 0's report: the mesh, the losses, the batch
    count and, with an fsdp axis, the word embedding's shard shape."""
    if device == "cuda" and torch.cuda.device_count() < n:
        raise RuntimeError(f"{n} ranks need {n} cards; "
                           f"{torch.cuda.device_count()} visible")
    return PM.spawn(_rank, n, (n,), device=device,
                    threads=1 if device == "cpu" else 0)
