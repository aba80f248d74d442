"""The port's training across ranks (lrce_tpu_torch/parallel, the rank-aware
agent and loader) against lrce_tpu's mesh on the CPU.

The port's ranks are processes over gloo (``parallel/mesh.spawn``, a file
store under a temporary directory, one torch thread each, a 60 s process
group timeout so that a hung rank fails its test); their programs live in
``lrce_tpu_torch.parallel.rank_checks`` so that no rank imports JAX.
lrce_tpu's side runs in this process on the conftest's 8 virtual CPU
devices, its ``AgentOE`` on a ``Mesh`` of the same (data, fsdp, model)
shape, compiled in threads while the port's ranks run. Both start from
lrce_tpu's initial parameters of the dry run's tiny configuration
(``parallel/dryrun.TINY``) with dropout and drop-path 0, through the
port's converter, and take the same global batch of 4.

Tolerances:
  - the step's loss, metric_num and metric_den: the same on every rank
    (an all-reduce gives every rank the same bits); loss and l2 against
    lrce_tpu within 1e-5 relative, the counts equal; the sharded l2_reg
    within 1e-6 of the same regularizer over the gathered parameters on
    one card (the same squares, summed in pieces);
  - the parameters after one train step (f32, lr 1e-4): within 1e-5 of the
    parameter's largest magnitude wherever the one-card gradient is above
    1e-4 of its largest and above 100 eps, and within 2 lr everywhere.
    AdamW's first step is lr g / (|g| + eps): where |g| is not far above
    eps or f32 noise (BERT's key biases, whose gradient is zero in exact
    arithmetic and holds noise of either sign) the order of the sums
    decides the step, on either side;
  - AdamW's moments after the step, (1 - b1) g and (1 - b2) g^2 of the
    global batch's mean gradient, against lrce_tpu's ``mu`` and ``nu``:
    within 1e-4 of each parameter's largest moment (or of 1e-4 of the
    model's largest, where a parameter's gradient is noise about zero).
    This holds the gradient's scale, which the first update's
    lr sign(g) does not show (a sum over the ranks in place of the mean
    would double mu).
  - a process group of one rank: the step bit for bit the step without
    one.
"""

import argparse
import datetime
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lrce_tpu.models import bert as B
from lrce_tpu.models import e2e as E
from lrce_tpu.models import swin3d as S
from lrce_tpu.parallel import mesh as JM
from lrce_tpu.parallel import sharding as JSh
from lrce_tpu.train.agent import AgentOE as JAgentOE
from lrce_tpu.utils import pytree as JP
from lrce_tpu_torch.data import loader as PL
from lrce_tpu_torch.models import e2e as PE
from lrce_tpu_torch.parallel import dryrun as PD
from lrce_tpu_torch.parallel import mesh as PM
from lrce_tpu_torch.parallel import rank_checks as RC
from lrce_tpu_torch.parallel import sharding as PSh
from lrce_tpu_torch.train import agent as PA
from lrce_tpu_torch.utils.convert import state_dict_from_jax
from lrce_tpu_torch.utils.pytree import l2_reg

LR = 1e-4
LOSS_REL = 1e-5
L2_REL = 1e-6
PARAM_REL = 1e-5
MOMENT_REL = 1e-4
ADAM_EPS = 1e-8
RANK_TIMEOUT = datetime.timedelta(seconds=60)

PORT_CFG = PD.TINY._replace(
    drop_out_rate=0.0,
    bert=PD.TINY.bert._replace(hidden_dropout=0.0, attention_dropout=0.0),
    swin=PD.TINY.swin._replace(drop_path_rate=0.0))
JAX_CFG = E.E2EConfig(
    feature_dim=24, num_classes=11, drop_out_rate=0.0,
    video_feature_res=(4, 4), video_feature_dim=16, frame_sample_size=5,
    temporal_scale=(1, 2), text_seq_len=8, task_type="oe",
    bert=B.BertConfig(vocab_size=64, hidden_size=24, num_layers=2,
                      num_heads=2, intermediate_size=48,
                      max_position_embeddings=16, type_vocab_size=2,
                      hidden_dropout=0.0, attention_dropout=0.0),
    swin=S.SwinConfig(patch_size=(2, 4, 4), embed_dim=16, depths=(2,),
                      num_heads=(2,), window_size=(2, 3, 3),
                      drop_path_rate=0.0))


def make_args(**kw):
    return argparse.Namespace(**{**dict(
        lr=[LR] * 3, min_lr=1e-8, lr_decay_factor=0.5, patience=1,
        use_cosine_scheduler=False, reg_strength=0.001,
        use_hinge_loss=False, dataset="dryrun", log_dir="runs"), **kw})


def make_batch(n: int, seed: int):
    rng = np.random.RandomState(seed)
    return (rng.rand(n, 3, 5, 16, 16, 3).astype(np.float32),
            rng.randint(0, 64, (n, 8)), np.ones((n, 8), np.int64),
            np.zeros((n, 8), np.int64),
            rng.randint(0, 11, (n,)).astype(np.int64))


BATCHES = [make_batch(4, 1), make_batch(4, 2)]


@pytest.fixture(scope="module", autouse=True)
def rank_timeout():
    """Every process group of the module's ranks (the spawner's and the
    CLIs') times out after RANK_TIMEOUT: a hung rank fails its test."""
    with pytest.MonkeyPatch.context() as m:
        m.setattr(PM, "DEFAULT_TIMEOUT", RANK_TIMEOUT)
        yield


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def start():
    """lrce_tpu's initial parameters (numpy) and the port's state dict of
    them."""
    params = jax.tree.map(np.asarray,
                          E.e2e_init_jit(jax.random.PRNGKey(0), JAX_CFG))
    return {"jax": params, "state": {k: v.numpy() for k, v in
                                     state_dict_from_jax(params).items()}}


def one_card(state, args=None):
    model = PE.LRCEModel(PORT_CFG, device="cpu")
    model.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in state.items()})
    return PA.AgentOE(model, args or make_args(), log_enabled=False)


@pytest.fixture(scope="module")
def grads(start):
    """The one-card gradient of the agent's loss on batch 0, by name."""
    torch.set_num_threads(1)
    agent = one_card(start["state"])
    batch = [torch.from_numpy(np.asarray(b)) for b in BATCHES[0]]
    agent._loss(agent._forward(*batch[:4], True), batch[4]).backward()
    return {n: p.grad.numpy().copy()
            for n, p in agent.model.named_parameters() if p.grad is not None}


def decided(g: np.ndarray) -> np.ndarray:
    """Where a gradient is far enough above AdamW's eps and f32 noise that
    its first step is lr sign(g) on either side."""
    g = np.abs(g)
    return (g > 1e-4 * g.max()) & (g > 100 * ADAM_EPS)


def assert_params_close(got, want, grads, lr=LR, steps=1):
    assert set(got) == set(want)
    for name, w in want.items():
        d = np.abs(got[name] - w)
        assert d.max() <= 2 * lr * steps * 1.001, (name, d.max())
        mask = decided(grads.get(name, np.zeros_like(w)))
        if mask.any():
            assert d[mask].max() <= PARAM_REL * np.abs(w).max(), (
                name, d[mask].max(), np.abs(w).max())


def l2_one_card(state) -> float:
    agent = one_card(state)
    with torch.no_grad():
        return float(l2_reg(agent.reg_groups))


def assert_same_on_every_rank(seen):
    for rank in seen[1:]:
        assert rank == seen[0]


# ---------------------------------------------------------------------------
# Rules and mesh
# ---------------------------------------------------------------------------

def _encode(shape, spec, axis):
    """An array of ``shape`` that counts 1.. along the dimension ``spec``
    puts on ``axis``, 0 where it puts none."""
    full = list(spec) + [None] * (len(shape) - len(spec))
    for i, a in enumerate(full):
        if a == axis or (isinstance(a, tuple) and axis in a):
            ix = [1] * len(shape)
            ix[i] = shape[i]
            return np.broadcast_to(
                (np.arange(shape[i]) + 1).reshape(ix), shape).astype(np.float32)
    return np.zeros(shape, np.float32)


def _varying_dim(t: np.ndarray):
    """The dimension along which t varies; None for zeros; "layer" for a
    constant above 0 (lrce_tpu split the stacked layer axis)."""
    if not t.any():
        return None
    dims = [d for d in range(t.ndim) if np.ptp(t, axis=d).max() > 0]
    if not dims:
        return "layer"
    assert len(dims) == 1, dims
    return dims[0]


@pytest.mark.parametrize("fsdp,model", [(1, 1), (2, 1), (1, 2), (2, 2)])
def test_sharding_rules_match_lrce_tpu(start, fsdp, model):
    """The port's tensor-parallel and FSDP rules split exactly the
    parameters lrce_tpu's e2e_param_shardings splits, along the same
    dimension, matched by name through the converter."""
    params = start["jax"]
    mesh = JM.make_mesh_3d(8 // (fsdp * model), fsdp, model)
    shardings = JSh.e2e_param_shardings(params, mesh)
    want = {}
    for axis in ("model", "fsdp"):
        enc = jax.tree.map(lambda leaf, sh: _encode(leaf.shape, sh.spec, axis),
                           params, shardings)
        for name, t in state_dict_from_jax(enc).items():
            want.setdefault(name, {})[axis] = _varying_dim(t.numpy())
    specs = PSh.param_specs(PE.LRCEModel(PORT_CFG, device="cpu"), fsdp, model)
    assert set(specs) == set(want)
    split = 0
    for name, spec in specs.items():
        assert (spec.model, spec.fsdp) == (want[name]["model"],
                                           want[name]["fsdp"]), name
        split += spec.model is not None or spec.fsdp is not None
    assert split > 0 if fsdp * model > 1 else split == 0


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_train_mesh_matches_lrce_tpu(monkeypatch, n):
    """The port's mesh shape, and its error, for every (fsdp, model) on n
    devices, against lrce_tpu's make_train_mesh (its absent axes are 1)."""
    devices = jax.devices()[:n]
    monkeypatch.setattr(JM.jax, "devices", lambda: devices)
    for fsdp, model in [(1, 1), (2, 1), (1, 2), (2, 2), (4, 1), (1, 4),
                        (3, 1), (8, 1), (0, 1)]:
        try:
            jm = JM.make_train_mesh(fsdp, model)
        except ValueError as e:
            with pytest.raises(ValueError) as got:
                PM.train_mesh_shape(n, fsdp, model)
            assert str(got.value) == str(e)
            continue
        shape = dict(jm.shape)
        assert PM.train_mesh_shape(n, fsdp, model) == {
            a: shape.get(a, 1) for a in PM.AXES}


# ---------------------------------------------------------------------------
# Loader
# ---------------------------------------------------------------------------

class _Items:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return (np.int64(i),)


@pytest.mark.parametrize("n,batch,replicas,shuffle", [
    (10, 2, 2, True), (11, 3, 2, True), (7, 4, 4, False), (5, 1, 4, True),
    (16, 4, 2, False), (9, 2, 3, True), (3, 2, 8, True)])
def test_rank_batches_concatenate_to_the_global_batch(n, batch, replicas,
                                                      shuffle):
    """Each rank's batches, concatenated in rank order, are
    global_batch_indices' global batches, the ragged last one included."""
    want = PL.global_batch_indices(n, batch, replicas, shuffle, seed=3)
    ranks = [list(PL.DataLoader(_Items(n), batch, num_replicas=replicas,
                                shuffle=shuffle, seed=3, num_workers=1,
                                rank=r)) for r in range(replicas)]
    assert all(len(r) == len(want) for r in ranks)
    for i, w in enumerate(want):
        got = np.concatenate([r[i][0] for r in ranks])
        np.testing.assert_array_equal(got, w)
    whole = list(PL.DataLoader(_Items(n), batch, num_replicas=replicas,
                               shuffle=shuffle, seed=3, num_workers=1))
    assert [b[0].tolist() for b in whole] == [w.tolist() for w in want]
    with pytest.raises(ValueError):
        PL.DataLoader(_Items(n), batch, num_replicas=replicas, rank=replicas)


# ---------------------------------------------------------------------------
# Rendezvous (the counterparts of tests/test_multihost_and_ckpt_errors.py)
# ---------------------------------------------------------------------------

_RDV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK")


def test_init_distributed_does_nothing_without_the_environment(monkeypatch):
    for k in _RDV:
        monkeypatch.delenv(k, raising=False)

    def boom(*a, **k):
        raise AssertionError("no rendezvous without the environment")

    monkeypatch.setattr(PM.dist, "init_process_group", boom)
    assert PM.init_distributed("cpu") == torch.device("cpu")
    assert PM.init_distributed("cpu", rank=0, world_size=1) == torch.device(
        "cpu")
    assert not PM.dist.is_initialized() and PM.world_size() == 1


def test_init_distributed_passes_the_environments_rank_and_world(monkeypatch):
    env = {"MASTER_ADDR": "10.0.0.1", "MASTER_PORT": "1234", "RANK": "3",
           "WORLD_SIZE": "4", "LOCAL_RANK": "1"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    calls = []
    monkeypatch.setattr(PM.dist, "init_process_group",
                        lambda *a, **k: calls.append((a, k)))
    assert PM.init_distributed("cpu") == torch.device("cpu")
    (args, kw), = calls
    assert args == ("gloo",)
    assert (kw["rank"], kw["world_size"], kw["init_method"]) == (3, 4,
                                                                 "env://")


def test_init_distributed_failure_is_loud(monkeypatch, tmp_path):
    def boom(*a, **k):
        raise ConnectionError("rendezvous unreachable")

    with monkeypatch.context() as m:
        m.setattr(PM.dist, "init_process_group", boom)
        with pytest.raises(RuntimeError, match="refusing to carry on"):
            PM.init_distributed("cpu", rank=0, world_size=2,
                                init_method="file:///nonexistent/x")
    # a real rendezvous where the second rank never comes
    with pytest.raises(RuntimeError, match="refusing to carry on"):
        PM.init_distributed("cpu", rank=0, world_size=2,
                            init_method=f"file://{tmp_path}/rdv",
                            timeout=datetime.timedelta(seconds=2))
    assert not PM.dist.is_initialized()


def test_a_failing_rank_fails_the_spawn(start):
    """An exception in the ranks (here: --fsdp 3 does not divide 2 ranks)
    makes the spawner raise."""
    with pytest.raises(Exception, match="must divide the device count"):
        PM.spawn(RC.agent_run, 2, (PORT_CFG, start["state"], BATCHES, 3, 1,
                                   make_args(), [("train", 0)]),
                 device="cpu", threads=1, timeout=RANK_TIMEOUT)


# ---------------------------------------------------------------------------
# One train step and one eval step against lrce_tpu's agent on its mesh
# ---------------------------------------------------------------------------

LAYOUTS = [(2, 1, 1), (2, 2, 1), (2, 1, 2), (4, 1, 2)]
PLAN = [("train", 0), ("eval", 1), ("l2",)]


def _jax_step(start, world, fsdp, model):
    mesh = JM.make_mesh_3d(world // (fsdp * model), fsdp, model)
    agent = JAgentOE(JAX_CFG, jax.tree.map(jnp.asarray, start["jax"]),
                     make_args(), mesh=mesh, log_enabled=False,
                     compute_dtype=jnp.float32)
    seen = [agent.step(*BATCHES[0], is_train=True),
            agent.step(*BATCHES[1], is_train=False),
            float(JP.l2_reg(agent.params))]

    def by_name(tree):
        return {k: v.numpy() for k, v in state_dict_from_jax(
            jax.tree.map(np.asarray, tree)).items()}

    return seen, by_name(agent.params), {"exp_avg": by_name(
        agent.opt_state.mu), "exp_avg_sq": by_name(agent.opt_state.nu)}


@pytest.fixture(scope="module")
def agent_steps(start):
    """{layout: (the port's rank-0 report, lrce_tpu's step)}: lrce_tpu's
    agents compile in threads while the port's ranks run, one spawn for
    each world size (its layouts in turn, each from the start)."""
    torch.set_num_threads(1)
    with ThreadPoolExecutor(len(LAYOUTS)) as pool:
        jax_side = {lay: pool.submit(_jax_step, start, *lay)
                    for lay in LAYOUTS}
        port = {}
        for world in sorted({lay[0] for lay in LAYOUTS}):
            axes = [lay[1:] for lay in LAYOUTS if lay[0] == world]
            reports = PM.spawn(RC.agent_runs, world,
                               (PORT_CFG, start["state"], BATCHES, axes,
                                make_args(), PLAN), device="cpu", threads=1,
                               timeout=RANK_TIMEOUT)
            port.update({(world, *a): r for a, r in zip(axes, reports)})
        return {lay: (port[lay], jax_side[lay].result()) for lay in LAYOUTS}


def assert_moments_close(got, want, names):
    """The port's AdamW moments (by optimizer index) against lrce_tpu's (by
    name)."""
    assert len(got) == len(names)
    for k in ("exp_avg", "exp_avg_sq"):
        top = max(np.abs(w).max() for w in want[k].values())
        for i, name in enumerate(names):
            w = want[k][name]
            scale = max(np.abs(w).max(), 1e-4 * top)
            d = np.abs(got[i][k] - w).max()
            assert d <= MOMENT_REL * scale, (name, k, d, scale)


@pytest.mark.parametrize("world,fsdp,model", LAYOUTS)
def test_agent_step_matches_lrce_tpu_on_its_mesh(start, grads, agent_steps,
                                                 world, fsdp, model):
    """World 2 as data 2, fsdp 2 and model 2, and world 4 as data 2 x
    model 2 (reg_strength 0.001 throughout): every rank reports the global
    loss and counts, which are lrce_tpu's; the parameters and AdamW's
    moments after the step are lrce_tpu's; the sharded l2_reg is the
    one-card value of the gathered parameters."""
    out, (jseen, jstate, jmoments) = agent_steps[(world, fsdp, model)]
    assert (out["layout"].n_fsdp, out["layout"].n_model) == (fsdp, model)
    assert out["layout"].n_batch == world // model
    seen = out["seen"]
    assert len(seen) == world
    assert_same_on_every_rank(seen)
    for got, want in zip(seen[0][:2], jseen[:2]):
        np.testing.assert_allclose(got[0], want[0], rtol=LOSS_REL)
        assert got[1:] == tuple(want[1:]) and got[2] == 4.0
    np.testing.assert_allclose(seen[0][2], jseen[2], rtol=LOSS_REL)
    np.testing.assert_allclose(seen[0][2], l2_one_card(out["state"]),
                               rtol=L2_REL)
    assert_params_close(out["state"], jstate, grads)
    ref = one_card(start["state"])
    assert_moments_close(out["optimizer"], jmoments,
                         PSh.param_names(ref.model, ref.optimizer))


def test_one_rank_group_runs_ddp_and_equals_no_group(start, tmp_path):
    """A process group of one rank (one card's NCCL run) wraps the model in
    DDP, whose all-reduce and the global values' all-reduce then run; the
    step is the step without a group, bit for bit."""
    from torch.nn.parallel import DistributedDataParallel

    want = one_card(start["state"])
    want_out = want.step(*BATCHES[0], is_train=True)
    PM.init_distributed("cpu", rank=0, world_size=1,
                        init_method=f"file://{tmp_path}/rdv",
                        timeout=RANK_TIMEOUT)
    try:
        layout = PM.make_layout(1, 1, "cpu")
        assert layout.batch_group is not None and layout.n_batch == 1
        model = PE.LRCEModel(PORT_CFG, device="cpu")
        model.load_state_dict({k: torch.from_numpy(np.array(v))
                               for k, v in start["state"].items()})
        agent = PA.AgentOE(model, make_args(), log_enabled=False,
                           layout=layout)
        assert isinstance(agent.net, DistributedDataParallel)
        got_out = agent.step(*BATCHES[0], is_train=True)
    finally:
        PM.dist.destroy_process_group()
    assert got_out == want_out
    for name, w in want.model.state_dict().items():
        assert torch.equal(model.state_dict()[name], w), name
