"""The port's training slice (lrce_tpu_torch/train, the grad-enabled
forward, dropout and drop-path, the dense rounding) against lrce_tpu on
the CPU, the same inputs from numpy on both sides.

Tolerances:
  - losses, schedules, l2_reg: 1e-6 relative (the same f32 formulas);
  - AdamW: 1e-6 (the same update, two orders of the same few f32 ops);
  - tiny e2e gradients at f32 with dropout off, every parameter:
    |port - jax| <= 2e-4 * max |jax| + 1e-7 per parameter; each gradient
    chains Swin's 8 blocks, BERT and 12 fusion layers over 3 clips
    backwards in other summation orders (the worst measured: 7.1e-5 of the
    parameter's largest gradient). The absolute term covers BERT's key
    biases, whose gradient is zero in exact arithmetic and holds f32 noise
    of order 1e-12 on both sides;
  - one AgentOE train step: the loss to 1e-4, and every parameter after
    the step within 2% of the step size wherever the JAX gradient is above
    1e-4 of its parameter's largest (Adam's first step is lr * sign(g) for
    every gradient well above its eps, and where a gradient is zero in
    exact arithmetic, as the key bias's is, both sides hold f32 noise of
    either sign).
"""

import math
import os
import subprocess
import sys
import textwrap
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lrce_tpu.models import bert as B
from lrce_tpu.models import e2e as E
from lrce_tpu.models import swin3d as S
from lrce_tpu.ops import nn as JNN
from lrce_tpu.train import agent as JA
from lrce_tpu.train import losses as JL
from lrce_tpu.train import optimizer as JO
from lrce_tpu.train import schedule as JS
from lrce_tpu.utils import pytree as JP
from lrce_tpu_torch.models import bert as PB
from lrce_tpu_torch.models import e2e as PE
from lrce_tpu_torch.models import swin3d as PS
from lrce_tpu_torch.ops import nn as PNN
from lrce_tpu_torch.train import agent as PA
from lrce_tpu_torch.train import losses as PL
from lrce_tpu_torch.train import optimizer as PO
from lrce_tpu_torch.train import schedule as PSch
from lrce_tpu_torch.utils import pytree as PP
from lrce_tpu_torch.utils.convert import state_dict_from_jax

REPO = Path(__file__).resolve().parent.parent


# ---------------------------------------------------------------------------
# dense: one rounding, as lrce_tpu's
# ---------------------------------------------------------------------------

def test_dense_bf16_rounds_once_like_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 96)).astype(np.float32)
    w = (rng.normal(size=(48, 96)) / 10).astype(np.float32)   # (out, in)
    b = rng.normal(size=(48,)).astype(np.float32)
    xb = torch.from_numpy(x).bfloat16()
    wb = torch.from_numpy(w).bfloat16()
    bt = torch.from_numpy(b)
    want = np.asarray(JNN.dense(
        {"w": jnp.asarray(w.T).astype(jnp.bfloat16), "b": jnp.asarray(b)},
        jnp.asarray(x).astype(jnp.bfloat16)).astype(jnp.float32))
    old = (torch.matmul(xb, wb.t()).float() + bt).bfloat16().float().numpy()
    got = PNN.dense(xb, wb, bt)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    ulp = np.abs(want) * 2.0 ** -7          # one bf16 ulp at |want|
    differed = np.abs(old - want) > 0
    assert differed.sum() > 0               # the old double rounding showed
    assert np.all(np.abs(got - want)[differed] <= ulp[differed])
    assert np.all(np.abs(got - want) <= ulp)


def test_matmul_f32_bf16_grads_keep_the_f32_cotangent_like_jax():
    """The f32 product's cotangent is not bf16-exact where the product is
    scaled or added in f32 before any rounding (the Swin blocks' attention
    and MLP branches): JAX's transpose of a dot with
    preferred_element_type=f32 multiplies the f32 cotangent and rounds dx,
    dw once. Tolerance: one bf16 ulp at |jax|, on at most 1% of elements
    (the two sum in other orders); rounding the cotangent first differs on
    far more."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(64, 96)).astype(np.float32)
    w = (rng.normal(size=(48, 96)) / 10).astype(np.float32)   # (out, in)
    c = rng.normal(size=(64, 48)).astype(np.float32)

    def jax_loss(xb, wb):
        return jnp.sum(jnp.dot(xb, wb.T, preferred_element_type=jnp.float32)
                       * c)

    want = jax.grad(jax_loss, argnums=(0, 1))(
        jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(w).astype(jnp.bfloat16))
    xt = torch.from_numpy(x).bfloat16().requires_grad_()
    wt = torch.from_numpy(w).bfloat16().requires_grad_()
    (PNN.matmul_f32(xt, wt) * torch.from_numpy(c)).sum().backward()
    cb = torch.from_numpy(c).bfloat16().float()
    rounded_first = (cb @ torch.from_numpy(w).bfloat16().float()).bfloat16()
    for got, ref in ((xt.grad, want[0]), (wt.grad, want[1])):
        assert got.dtype == torch.bfloat16
        got = got.float().numpy()
        ref = np.asarray(ref.astype(jnp.float32))
        assert np.all(np.abs(got - ref) <= np.abs(ref) * 2.0 ** -7)
        assert (got != ref).mean() <= 0.01
    ref = np.asarray(want[0].astype(jnp.float32))
    assert (rounded_first.float().numpy() != ref).mean() > 0.1


# ---------------------------------------------------------------------------
# losses, optimizer, schedules, l2_reg
# ---------------------------------------------------------------------------

def test_losses_match_jax():
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(6, 11)).astype(np.float32)
    labels = np.array([3, -100, 0, 10, -100, 7])
    np.testing.assert_allclose(
        PL.cross_entropy(torch.from_numpy(logits),
                         torch.from_numpy(labels)).item(),
        float(JL.cross_entropy(jnp.asarray(logits), jnp.asarray(labels))),
        rtol=1e-6)
    assert math.isnan(PL.cross_entropy(torch.from_numpy(logits),
                                       torch.full((6,), -100)).item())
    scores = rng.normal(size=(6, 5)).astype(np.float32)
    gt = np.array([0, 4, 2, 2, 1, 3])
    np.testing.assert_allclose(
        PL.hinge_loss(torch.from_numpy(scores), torch.from_numpy(gt),
                      0.7).item(),
        float(JL.hinge_loss(jnp.asarray(scores), jnp.asarray(gt), 0.7)),
        rtol=1e-6)
    out = rng.normal(size=(6,)).astype(np.float32)
    cnt = rng.integers(0, 9, (6,))
    np.testing.assert_allclose(
        PL.mse(torch.from_numpy(out), torch.from_numpy(cnt)).numpy(),
        np.asarray(JL.mse(jnp.asarray(out), jnp.asarray(cnt))), rtol=1e-6)


class _Toy(torch.nn.Module):
    def __init__(self, leaves):
        super().__init__()
        for name, tree in leaves.items():
            mod = torch.nn.Module()
            for k, v in tree.items():
                setattr(mod, k, torch.nn.Parameter(torch.from_numpy(v.copy())))
            setattr(self, name, mod)


def test_adamw_three_groups_matches_apply_updates():
    rng = np.random.default_rng(2)
    tree = {g: {"a": rng.normal(size=(4, 3)).astype(np.float32),
                "b": rng.normal(size=(5,)).astype(np.float32)}
            for g in JO.GROUPS}
    lrs_per_step = [[1e-2, 2e-2, 3e-2], [5e-3, 1e-2, 2e-2], [4e-2, 1e-3, 1e-2]]
    grads = [{g: {k: rng.normal(size=v.shape).astype(np.float32)
                  for k, v in t.items()} for g, t in tree.items()}
             for _ in lrs_per_step]
    params = jax.tree.map(jnp.asarray, tree)
    adam = JO.make_optimizer()
    state = adam.init(params)
    labels = JO.group_index_tree(params)
    toy = _Toy(tree)
    opt = PO.make_optimizer(toy, lrs_per_step[0])
    assert [g["name"] for g in opt.param_groups] == list(PO.GROUPS)
    for lrs, gr in zip(lrs_per_step, grads):
        params, state = JO.apply_updates(params, jax.tree.map(jnp.asarray, gr),
                                         state, adam, labels,
                                         jnp.asarray(lrs, jnp.float32))
        for g, t in gr.items():
            for k, v in t.items():
                getattr(getattr(toy, g), k).grad = torch.from_numpy(v)
        PO.set_lrs(opt, lrs)
        opt.step()
    for g, t in params.items():
        for k, v in t.items():
            np.testing.assert_allclose(getattr(getattr(toy, g), k).detach(),
                                       np.asarray(v), rtol=1e-6, atol=1e-6)


def test_schedules_match_jax():
    grid = [i / 7 for i in range(0, 60)]
    for kw in (dict(first_cycle_steps=2, cycle_mult=1.0, max_lr=1e-4,
                    min_lr=1e-8, warmup_steps=0.1, gamma=0.5),
               dict(first_cycle_steps=1.5, cycle_mult=2.0, max_lr=3e-4,
                    min_lr=1e-6, warmup_steps=0.3, gamma=0.7)):
        ours = PSch.CosineWarmupRestarts(3, **kw)
        ref = JS.CosineWarmupRestarts(3, **kw)
        assert ours.lrs == ref.lrs
        for t in grid:
            a, b = ours.step(t), ref.step(t)
            assert len(set(a)) == 1 and len(a) == 3   # every group the same
            np.testing.assert_allclose(a, b, rtol=1e-12)
    metrics = [0.1, 0.2, 0.2, 0.19, 0.2, 0.21, 0.21, 0.2, 0.1, 0.3]
    for mode, sign in (("max", 1), ("min", -1)):
        ours = PSch.ReduceLROnPlateau([1e-3, 2e-3, 3e-3], mode=mode,
                                      factor=0.5, patience=1, min_lr=2e-4)
        ref = JS.ReduceLROnPlateau([1e-3, 2e-3, 3e-3], mode=mode, factor=0.5,
                                   patience=1, min_lr=2e-4)
        for m in metrics:
            assert ours.step(sign * m) == ref.step(sign * m)
        assert ours.state_dict() == ref.state_dict()


def test_l2_reg_matches_jax_leaves():
    """Value and gradient, a zero leaf included (zero subgradient)."""
    rng = np.random.default_rng(3)
    leaves = [rng.normal(size=(3, 4)).astype(np.float32),
              np.zeros((5,), np.float32),
              rng.normal(size=(2, 2, 2)).astype(np.float32)]
    want, jgrads = jax.value_and_grad(JP.l2_reg)([jnp.asarray(v)
                                                  for v in leaves])
    ts = [torch.from_numpy(v).requires_grad_() for v in leaves]
    got = PP.l2_reg([[t] for t in ts])
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    for t, g in zip(ts, jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=1e-6,
                                   atol=1e-7)


# ---------------------------------------------------------------------------
# dropout and drop-path
# ---------------------------------------------------------------------------

def test_dropout_statistics_and_determinism():
    x = torch.ones((400, 500))
    a = PNN.dropout(x, 0.1, True, torch.Generator().manual_seed(5))
    b = PNN.dropout(x, 0.1, True, torch.Generator().manual_seed(5))
    c = PNN.dropout(x, 0.1, True, torch.Generator().manual_seed(6))
    assert torch.equal(a, b) and not torch.equal(a, c)
    kept = (a != 0).float().mean().item()
    assert abs(kept - 0.9) < 0.005          # 200k draws: sd 6.7e-4
    assert torch.allclose(a[a != 0], torch.full_like(a[a != 0], 1 / 0.9))
    assert torch.equal(PNN.dropout(x, 0.1, False), x)
    dp = PS.drop_path_multipliers(100_000, 0.2, torch.Generator().manual_seed(7),
                                  "cpu")
    assert abs((dp > 0).float().mean().item() - 0.8) < 0.006
    assert torch.allclose(dp[dp > 0], torch.full_like(dp[dp > 0], 1 / 0.8))
    y = torch.randn(4, 2, 3)
    assert torch.allclose(PS.drop_path(y, torch.tensor([0.0, 1.25, 1.25, 0.0])),
                          y * torch.tensor([0.0, 1.25, 1.25, 0.0])[:, None, None])


# ---------------------------------------------------------------------------
# the tiny end-to-end model (tests/test_torch_e2e.py's) in training
# ---------------------------------------------------------------------------

def tiny_configs(task: str, rate: float = 0.0, frames: int = 5):
    kw = dict(feature_dim=36, num_classes=1 if task == "mc" else 11,
              video_feature_res=(7, 7), video_feature_dim=64,
              frame_sample_size=frames, temporal_scale=(3,), text_seq_len=8,
              task_type=task, drop_out_rate=rate)
    bert = dict(hidden_size=36, num_layers=2, num_heads=2,
                intermediate_size=72, hidden_dropout=rate,
                attention_dropout=rate)
    swin = dict(embed_dim=8, depths=(2, 2, 2, 2), num_heads=(2, 2, 2, 2),
                drop_path_rate=rate)
    return (E.E2EConfig(**kw, bert=B.BertConfig(**bert),
                        swin=S.SwinConfig(**swin)),
            PE.E2EConfig(**kw, bert=PB.BertConfig(**bert),
                         swin=PS.SwinConfig(**swin)))


def tiny_batch(task: str, seed: int = 0, frames: int = 5, b: int = 2):
    rng = np.random.default_rng(seed)
    m = 3
    clips = rng.integers(0, 256, (b, 3, frames, 224, 224, 3), dtype=np.uint8)
    tshape = (b, m, 8) if task == "mc" else (b, 8)
    ids = rng.integers(0, 1000, tshape)
    mask = np.ones(tshape, np.int64)
    mask[..., 6:] = 0
    types = np.zeros(tshape, np.int64)
    gt = {"oe": rng.integers(0, 11, (b,)), "mc": rng.integers(0, m, (b,)),
          "count": rng.integers(0, 5, (b,)).astype(np.float32)}[task]
    return clips, ids, mask, types, gt


def _args(**kw):
    return SimpleNamespace(**{**dict(
        lr=[1e-3, 2e-3, 3e-3], min_lr=1e-8, lr_decay_factor=0.5, patience=1,
        use_cosine_scheduler=False, reg_strength=0.001, use_hinge_loss=False,
        margin=1.0), **kw})


def _jax_agent(task, jcfg, params, args):
    cls = JA.agent_factory(task)
    return cls(jcfg, params, args, log_enabled=False,
               compute_dtype=jnp.float32)


def _port_model(pcfg, params):
    model = PE.LRCEModel(pcfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(params))
    return model


def _jax_batch(batch):
    clips, ids, mask, types, gt = batch
    return (jnp.asarray(clips), jnp.asarray(ids.astype(np.int32)),
            jnp.asarray(mask.astype(np.int32)),
            jnp.asarray(types.astype(np.int32)), jnp.asarray(gt))


@pytest.mark.parametrize("task", ["oe", "mc", "count"])
def test_e2e_gradients_match_jax_agent_loss(task):
    """Every parameter's gradient of the agent's loss (task loss + 0.001 *
    l2_reg), dropout and drop-path rates 0, the kernel route (the
    autograd.Functions with their plain versions inside)."""
    jcfg, pcfg = tiny_configs(task)
    params = jax.tree.map(np.asarray, E.e2e_init(jax.random.PRNGKey(0), jcfg))
    args = _args(use_hinge_loss=task == "mc", margin=0.5)
    jagent = _jax_agent(task, jcfg, params, args)
    batch = tiny_batch(task)
    jb = _jax_batch(batch)

    def loss_fn(p):
        logits = jagent._forward(p, *jb[:4], False, jax.random.PRNGKey(1))
        return (jagent._task_loss(logits, jb[4])
                + args.reg_strength * JP.l2_reg(p))

    jloss, jgrads = jax.value_and_grad(loss_fn)(jax.tree.map(jnp.asarray,
                                                             params))
    want = state_dict_from_jax(jax.tree.map(np.asarray, jgrads))

    model = _port_model(pcfg, params)
    agent = PA.agent_factory(task)(model, args, log_enabled=False)
    pb = [torch.from_numpy(np.asarray(a)) for a in batch]
    loss = agent._loss(agent._forward(*pb[:4], True), pb[4])
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4)
    named = dict(model.named_parameters())
    assert set(named) == set(want)
    for name, p in named.items():
        w = want[name].numpy()
        assert p.grad is not None, name
        err = np.abs(p.grad.numpy() - w).max()
        assert err <= 2e-4 * np.abs(w).max() + 1e-7, (name, err,
                                                      np.abs(w).max())


def agent_oe_step_matches_jax(frames: int, questions: int):
    """One AgentOE step (forward, loss, backward, AdamW) against lrce_tpu's
    agent from the same parameters and batch: the loss to 1e-4, every
    parameter whose gradient is decided (above 1e-4 of its largest) within
    0.02 x lr of lrce_tpu's update."""
    task = "oe"
    jcfg, pcfg = tiny_configs(task, frames=frames)
    params = jax.tree.map(np.asarray, E.e2e_init(jax.random.PRNGKey(3), jcfg))
    args = _args()
    batch = tiny_batch(task, seed=4, frames=frames, b=questions)
    jb = _jax_batch(batch)
    jagent = _jax_agent(task, jcfg, jax.tree.map(jnp.asarray, params), args)

    grads = jax.grad(lambda p: jagent._task_loss(
        jagent._forward(p, *jb[:4], False, jax.random.PRNGKey(1)), jb[4])
        + args.reg_strength * JP.l2_reg(p))(jax.tree.map(jnp.asarray, params))
    gabs = state_dict_from_jax(jax.tree.map(np.asarray, grads))
    jloss, _, _ = jagent.step(*jb, is_train=True)
    want = state_dict_from_jax(jax.tree.map(np.asarray, jagent.params))

    model = _port_model(pcfg, params)
    agent = PA.AgentOE(model, args, log_enabled=False)
    loss, m0, m1 = agent.step(*batch, is_train=True)
    np.testing.assert_allclose(loss, jloss, rtol=1e-4)
    assert m1 == questions
    start = state_dict_from_jax(params)
    lr = {"fusion_model": 1e-3, "text_extractor": 2e-3,
          "video_extractor": 3e-3}
    moved = 0
    for name, p in model.named_parameters():
        g = np.abs(gabs[name].numpy())
        decided = g > 1e-4 * g.max()
        step = lr[name.split(".")[0]]
        got = p.detach().numpy()
        np.testing.assert_array_less(
            np.abs(got - want[name].numpy())[decided], 0.02 * step,
            err_msg=name)
        moved += int((np.abs(got - start[name].numpy()) > 0.5 * step).any())
    assert moved > 0.9 * len(list(model.parameters()))


def test_agent_oe_train_step_matches_jax():
    agent_oe_step_matches_jax(5, 2)


def test_e2e_training_forward_is_seeded():
    """Dropout and drop-path on: the same generator seed gives the same
    logits, another seed other logits; eval mode draws nothing."""
    _, pcfg = tiny_configs("oe", rate=0.3)
    model = PE.LRCEModel(pcfg, device="cpu")
    batch = [torch.from_numpy(np.asarray(a)) for a in tiny_batch("oe")[:4]]

    def run(seed):
        with torch.no_grad():
            return PE.e2e_apply(model, *batch, training=True,
                                generator=torch.Generator().manual_seed(seed))

    a, b, c = run(1), run(1), run(2)
    assert torch.equal(a, b) and not torch.allclose(a, c)
    ev = PE.e2e_forward(model, *batch)
    assert torch.equal(ev, PE.e2e_forward(model, *batch))
    with pytest.raises(ValueError, match="Generator"):
        PE.e2e_apply(model, *batch, training=True)


def test_process_data_reads_one_step_behind():
    """process_data enqueues step i+1 before it reads step i's metrics."""
    _, pcfg = tiny_configs("oe")
    model = PE.LRCEModel(pcfg, device="cpu")
    agent = PA.AgentOE(model, _args(), log_enabled=False)
    order = []
    real_dispatch = agent.dispatch

    class Out:
        def __init__(self, i, t):
            self.i, self.t = i, t

        def tolist(self):
            order.append(("read", self.i))
            return self.t.tolist()

    def dispatch(*batch, is_train):
        i = sum(1 for o in order if o[0] == "dispatch")
        order.append(("dispatch", i))
        return Out(i, real_dispatch(*batch, is_train=is_train))

    agent.dispatch = dispatch
    dl = [tiny_batch("oe", seed=s) for s in range(3)]
    steps = list(agent.process_data(dl, True, 0))
    assert steps == [0, 1, 2, -1]
    assert order == [("dispatch", 0), ("dispatch", 1), ("read", 0),
                     ("dispatch", 2), ("read", 1), ("read", 2)]
    assert agent.counter == 3 and math.isfinite(agent.last_train_loss)


def test_train_slice_never_imports_jax():
    code = textwrap.dedent("""
        import sys
        import numpy as np
        import torch
        from lrce_tpu_torch.models import bert, e2e, swin3d
        from lrce_tpu_torch.train import agent, losses, optimizer, schedule
        from lrce_tpu_torch.utils import pytree
        cfg = e2e.E2EConfig(
            feature_dim=36, num_classes=5, video_feature_dim=64,
            text_seq_len=8,
            bert=bert.BertConfig(hidden_size=36, num_layers=1, num_heads=2,
                                 intermediate_size=72),
            swin=swin3d.SwinConfig(embed_dim=8, depths=(2, 2, 2, 2),
                                   num_heads=(2, 2, 2, 2)))
        model = e2e.LRCEModel(cfg, device="cpu")
        ag = agent.AgentOE(model, agent.default_args(lr=[1e-3] * 3),
                            log_enabled=False)
        clips = np.random.randint(0, 256, (1, 3, 5, 224, 224, 3), np.uint8)
        ids = np.random.randint(0, 1000, (1, 8))
        loss, m0, m1 = ag.step(clips, ids, np.ones_like(ids),
                               np.zeros_like(ids), np.array([2]),
                               is_train=True)
        assert np.isfinite(loss) and m1 == 1.0
        jax_mods = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
                    or m == "lrce_tpu" or m.startswith("lrce_tpu.")]
        assert not jax_mods, jax_mods
        print("no-jax-ok")
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr
    assert "no-jax-ok" in proc.stdout
