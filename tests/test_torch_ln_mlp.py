"""K7 (``fused_ln_mlp``) and K8 (``fused_mlp``) of the port against the JAX
Pallas kernels they replace, in interpret mode on the CPU, f32, the same
numpy-seeded inputs on both sides:

  - ``ln_mlp_plain`` against ``_ln_mlp_fwd_impl`` with 1, 2 and 4 FF
    chunks, with and without dp2;
  - ``fused_ln_mlp`` (the autograd.Function: backward K5 + the LN2 input
    backward) forward and every gradient against ``jax.grad`` of the JAX
    ``fused_ln_mlp`` (backward ``_mlp_bwd_impl`` in interpret mode);
  - ``fused_mlp_plain`` and ``fused_mlp``'s gradients against the JAX
    ``fused_mlp`` (Pallas forward in interpret mode, XLA-equivalent VJP);
  - the K7 kernel's work list (``ln_mlp_plan``), its fc2 slices summed in
    order against ``ln_mlp_plain``, and K8's route by width;
  - the port's copy of the reference's rational erf (the kernels' GELU)
    against ``_erf_f32`` and ``torch.erf``;
  - a (W-MSA, SW-MSA) pair of Swin blocks on the port's C >
    ``BLOCK_KERNEL_MAX_C`` route with ``ln_mlp=True`` against
    ``lrce_tpu.models.swin3d.swin_block(use_pallas="hsplit")`` with
    ``LRCE_TPU_LNMLP`` set, forward and parameter gradients.

On the CPU the wrappers run their plain versions inside the same
``autograd.Function``s as on the card, so the tests hold the rounding
points and the custom backward's structure to the JAX kernels.

Tolerances: 1e-4 (rtol and atol) per kernel output and gradient: the same
f32 math in other summation orders, and the GELU's erf (XLA's rational
approximation in the Pallas kernels, libm's here); 5e-4 for the two-block
route, which chains K2, K4, K5 and K7 twice.
"""

import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lrce_tpu.models import swin3d as S
from lrce_tpu.ops import pallas_mlp as PM
from lrce_tpu.ops import pallas_swin_block as PB
from lrce_tpu_torch.models import swin3d as PS
from lrce_tpu_torch.ops import cuda_lib
from lrce_tpu_torch.ops import mlp as M
from lrce_tpu_torch.ops import nn as NN
from lrce_tpu_torch.ops import swin_block as SB
from lrce_tpu_torch.utils.convert import swin_state_dict

TOL = dict(rtol=1e-4, atol=1e-4)
ROUTE_TOL = dict(rtol=5e-4, atol=5e-4)
SHAPES = {"c64": ((2, 3, 7, 7, 64), 256), "c32": ((2, 2, 8, 8, 32), 128)}
NAMES = ("h1", "ln2s", "ln2b", "w1", "b1", "w2", "b2")


def _case(shape, ff, seed, with_dp):
    """(h1, [ln2s, ln2b, w1, b1, w2, b2] in the JAX layout, dp2 (B,) or
    None, output cotangent), numpy f32."""
    rng = np.random.default_rng(seed)
    c = shape[-1]
    f32 = lambda a: a.astype(np.float32)  # noqa: E731
    h1 = f32(rng.normal(size=shape))
    a = [f32(rng.random(c) + 0.5), f32(rng.normal(size=c) * 0.1),
         f32(rng.normal(size=(c, ff)) / np.sqrt(c)),
         f32(rng.normal(size=ff) * 0.02),
         f32(rng.normal(size=(ff, c)) / np.sqrt(ff)),
         f32(rng.normal(size=c) * 0.02)]
    dp2 = f32(rng.binomial(1, 0.6, shape[0]) / 0.6) if with_dp else None
    if with_dp:
        dp2[0], dp2[-1] = 0.0, 1.0 / 0.6     # one dropped, one kept sample
    g = f32(rng.normal(size=shape))
    return h1, a, dp2, g


def _jax_dp(dp2):
    return jnp.asarray(np.ones((1, 1), np.float32) if dp2 is None
                       else dp2[:, None])


def _port_args(a):
    """The weights in the port's layout: (out, in) matrices."""
    ln2s, ln2b, w1, b1, w2, b2 = a
    t = lambda v: torch.from_numpy(np.ascontiguousarray(v))  # noqa: E731
    return [t(ln2s), t(ln2b), t(w1.T), t(b1), t(w2.T), t(b2)]


def _to_jax_layout(name, g):
    return g.T if name in ("w1", "w2") else g


@pytest.mark.parametrize("with_dp", [False, True], ids=["no-dp", "dp"])
@pytest.mark.parametrize("ffc", [1, 2, 4])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_ln_mlp_plain_matches_pallas_forward(shape, ffc, with_dp):
    dims, ff = SHAPES[shape]
    h1, a, dp2, _ = _case(dims, ff, 30, with_dp)
    want = PB._ln_mlp_fwd_impl(jnp.asarray(h1), *(jnp.asarray(v) for v in a),
                               _jax_dp(dp2), ln_eps=1e-5, interpret=True,
                               ff_chunks=ffc)
    got = SB.ln_mlp_plain(torch.from_numpy(h1), *_port_args(a),
                          None if dp2 is None else torch.from_numpy(dp2),
                          1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("with_dp", [False, True], ids=["no-dp", "dp"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_fused_ln_mlp_forward_and_grads_match_jax(shape, with_dp):
    dims, ff = SHAPES[shape]
    h1, a, dp2, g = _case(dims, ff, 31, with_dp)

    def jax_fn(h, *w):
        return PB.fused_ln_mlp(h, *w, _jax_dp(dp2), 1e-5, True)

    out, vjp = jax.vjp(jax_fn, jnp.asarray(h1), *(jnp.asarray(v) for v in a))
    want = vjp(jnp.asarray(g))

    ht = torch.from_numpy(h1).requires_grad_()
    leaves = [t.requires_grad_() for t in _port_args(a)]
    before = SB.fused_ln_mlp.launches
    # dp2 as (B, 1), the JAX convention, and as (B,) both work
    dpt = None if dp2 is None else torch.from_numpy(dp2[:, None])
    got = SB.fused_ln_mlp(ht, *leaves, dpt, 1e-5)
    assert SB.fused_ln_mlp.launches == before      # CPU: plain version
    assert got.grad_fn is not None
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), **TOL)
    got.backward(torch.from_numpy(g))
    for name, t, w in zip(NAMES, [ht] + leaves, want):
        np.testing.assert_allclose(_to_jax_layout(name, t.grad.numpy()),
                                   np.asarray(w), err_msg=name, **TOL)
    with torch.no_grad():
        again = SB.fused_ln_mlp(ht, *leaves, dpt, 1e-5)
    assert again.grad_fn is None and torch.equal(again, got.detach())


@pytest.mark.parametrize("shape", list(SHAPES))
def test_fused_mlp_matches_jax(shape):
    dims, ff = SHAPES[shape]
    x, a, _, g = _case(dims, ff, 32, False)

    def jax_fn(xx, *w):
        return PM.fused_mlp(xx, *w, 1e-5, True)

    out, vjp = jax.vjp(jax_fn, jnp.asarray(x), *(jnp.asarray(v) for v in a))
    want = vjp(jnp.asarray(g))

    xt = torch.from_numpy(x).requires_grad_()
    leaves = [t.requires_grad_() for t in _port_args(a)]
    plain = M.fused_mlp_plain(xt.detach(), *(t.detach() for t in leaves), 1e-5)
    np.testing.assert_allclose(plain.numpy(), np.asarray(out), **TOL)
    before = M.fused_mlp.launches
    got = M.fused_mlp(xt, *leaves, 1e-5)
    assert M.fused_mlp.launches == before
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), **TOL)
    got.backward(torch.from_numpy(g))
    for name, t, w in zip(NAMES, [xt] + leaves, want):
        np.testing.assert_allclose(_to_jax_layout(name, t.grad.numpy()),
                                   np.asarray(w), err_msg=name, **TOL)
    with torch.no_grad():
        assert torch.equal(M.fused_mlp(xt, *leaves, 1e-5), got.detach())


# ---------------------------------------------------------------------------
# The K7 kernel's work list and K8's route, as the CUDA wrappers pass them
# ---------------------------------------------------------------------------

H100_SMS = 132


@pytest.mark.parametrize("t,c,ff", [(882, 1024, 4096), (7056, 1024, 4096),
                                    (441, 1024, 4096), (108, 64, 256),
                                    (294, 512, 2048)])
def test_ln_mlp_plan_orders_every_task_after_its_inputs(t, c, ff):
    """The ticket order: an fc2 task after every fc1 tile of its row block
    and of the ``lag`` row blocks after it; every fc1 tile and fc2 slice
    exactly once (the LayerNorm's jobs are not in the list)."""
    plan = SB.ln_mlp_plan(t, c, ff, H100_SMS)
    tasks = SB.ln_mlp_tasks(plan)
    assert len(tasks) == plan.tasks
    assert plan.row_blocks == -(-t // 128) and plan.grid <= H100_SMS
    seen_fc1 = {}
    for kind, rb, i, s in tasks:
        assert 0 <= rb < plan.row_blocks
        if kind == "fc1":
            seen_fc1[rb] = seen_fc1.get(rb, 0) + 1
        else:
            assert kind == "fc2" and seen_fc1.get(rb) == plan.fc1_tiles
    # a row block's fc2 comes lag row blocks of fc1 after its own fc1
    first_fc2 = {}
    for pos, (kind, rb, i, s) in enumerate(tasks):
        if kind == "fc2":
            first_fc2.setdefault(rb, pos)
    for rb, pos in first_fc2.items():
        ahead = min(rb + plan.lag, plan.row_blocks) - 1
        assert ("fc1", ahead, plan.fc1_tiles - 1, 0) in tasks[:pos]
    assert sorted(i for kind, rb, i, s in tasks if kind == "fc1") == sorted(
        list(range(plan.fc1_tiles)) * plan.row_blocks)
    fc2 = [(rb, i, s) for kind, rb, i, s in tasks if kind == "fc2"]
    assert sorted(fc2) == [(rb, i, s) for rb in range(plan.row_blocks)
                           for i in range(plan.fc2_tiles)
                           for s in range(plan.splits)]
    assert plan.counters == 3 + plan.row_blocks * (1 + plan.fc2_tiles)


@pytest.mark.parametrize("t,splits", [(882, 4), (7056, 1), (441, 8)])
def test_ln_mlp_plan_splits_fc2_to_fill_the_consumers(t, splits):
    """S fills the 2 x 132 consumer warpgroups: one request (7 x 8 fc2
    tiles) splits FF in four, a 48-clip step (56 x 8) not at all."""
    plan = SB.ln_mlp_plan(t, 1024, 4096, H100_SMS)
    assert plan.splits == splits
    tiles = plan.row_blocks * plan.fc2_tiles
    assert plan.splits == 1 or tiles * plan.splits <= 2 * H100_SMS
    assert (plan.splits == SB.LN_MLP_MAX_SPLITS
            or tiles * 2 * plan.splits > 2 * H100_SMS)
    assert (4096 // 64) % plan.splits == 0


def _ln_mlp_by_plan(h1, ln2s, ln2b, w1, b1, w2, b2, dp2, plan, eps=1e-5):
    """The kernel's arithmetic in its order, f32: LN and fc1 per row block,
    fc2 per slice of FF, the slices' partials summed in slice order, then
    + b2, x the row's sample dp, + h1."""
    c = h1.shape[-1]
    x = h1.reshape(-1, c)
    t = x.shape[0]
    tokens = t // h1.shape[0]
    rows = torch.arange(t)
    dp = torch.ones(t) if dp2 is None else dp2[rows // tokens]
    ff = w1.shape[0]
    width = ff // plan.splits
    out = torch.empty_like(x)
    for rb in range(plan.row_blocks):
        r = slice(128 * rb, min(t, 128 * rb + 128))
        z = SB.layer_norm(x[r], ln2s, ln2b, eps)
        hid = SB.gelu(z @ w1.T + b1)
        acc = None
        for s in range(plan.splits):
            k = slice(s * width, (s + 1) * width)
            part = hid[:, k] @ w2[:, k].T
            acc = part if acc is None else acc + part
        out[r] = x[r] + (acc + b2) * dp[r, None]
    return out.reshape(h1.shape)


@pytest.mark.parametrize("with_dp", [False, True], ids=["no-dp", "dp"])
def test_ln_mlp_slices_summed_in_order_match_the_plain_version(with_dp):
    """At f32 the work list's arithmetic (fc2 in S = 4 slices summed in
    order, dp2 by each row's own sample) equals ``ln_mlp_plain`` within
    1e-6 of the output's largest magnitude (f32 sums of 256 products in
    another order; a slice left out or a row given another sample's dp2
    would be off by order 1): a ragged row count (T = 5 x 63 = 315), an
    odd sample count."""
    dims, ff = (5, 1, 7, 9, 64), 256
    h1, a, dp2, _ = _case(dims, ff, 34, with_dp)
    plan = SB.ln_mlp_plan(315, 64, ff, H100_SMS)._replace(splits=4)
    args = [torch.from_numpy(h1), *_port_args(a),
            None if dp2 is None else torch.from_numpy(dp2)]
    got = _ln_mlp_by_plan(*args, plan).numpy()
    want = SB.ln_mlp_plain(*args, 1e-5).numpy()
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


@pytest.mark.parametrize("c,ff,route", [(128, 512, "core"), (256, 1024, "core"),
                                        (64, 256, "ln_mlp"),
                                        (512, 2048, "ln_mlp"),
                                        (1024, 4096, "ln_mlp"),
                                        (128, 256, "ln_mlp"),
                                        (32, 128, "none"), (96, 384, "none"),
                                        (1024, 4000, "none")])
def test_fused_mlp_routes_by_width(c, ff, route):
    """K8's kernel by width: the back half's one-CTA core at C = 128 / 256
    with FF = 4 C, K7's kernel at the other widths it takes, else none (the
    wrapper raises before any launch)."""
    assert M.mlp_route(c, ff) == route
    assert SB.ln_mlp_supported(c, ff) == (route == "ln_mlp" or c in (128, 256))


def test_erf_rational_is_the_references_erf():
    """The port's copy of XLA's rational erf (``ops/nn.erf_rational``, the
    GELU's erf in the CUDA kernels) over [-5, 5]: within 2 ulp of
    ``_erf_f32`` of the Pallas kernels (bit-identical here: the same f32
    steps), within 4.2e-7 (7 ulp near |erf| = 1) of ``torch.erf``; and the
    CUDA header holds the same coefficients in the same order."""
    x = np.linspace(-5.0, 5.0, 400001, dtype=np.float32)
    ours = NN.erf_rational(torch.from_numpy(x)).numpy()
    ref = np.asarray(PM._erf_f32(jnp.asarray(x)))
    ulp = np.spacing(np.abs(ref))
    assert (np.abs(ours - ref) <= 2 * ulp).all()
    assert np.abs(ours - torch.erf(torch.from_numpy(x)).numpy()).max() <= 4.2e-7
    header = (cuda_lib.CSRC / "swin_common.cuh").read_text()
    body = header[header.index("float erf_xla("):header.index("float gelu_erf(")]
    coeffs = [float(v) for v in re.findall(r"(-?\d\.\d+e-\d+)f", body)]
    assert coeffs == list(NN.ERF_ALPHA + NN.ERF_BETA)


# ---------------------------------------------------------------------------
# The route: stage-3-style blocks (K2 + K7) at a narrow width
# ---------------------------------------------------------------------------

def test_swin_blocks_ln_mlp_route_matches_jax_hsplit_lnmlp(monkeypatch):
    monkeypatch.setenv("LRCE_TPU_LNMLP", "1")
    monkeypatch.setattr(PS, "BLOCK_KERNEL_MAX_C", 32)
    c, heads, window = 64, 4, (2, 3, 3)
    dims = (2, 6, 9)
    jcfg = S.SwinConfig(embed_dim=c, depths=(2, 2), num_heads=(heads, heads),
                        window_size=window, drop_path_rate=0.0)
    params = jax.tree.map(np.asarray, S.swin_init(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(33)
    params = jax.tree.map(
        lambda a: a + rng.normal(0, 0.05, a.shape).astype(a.dtype), params)
    x = rng.normal(size=(2, *dims, c)).astype(np.float32)
    g = rng.normal(size=x.shape).astype(np.float32)
    rel_index = jnp.asarray(S.relative_position_index(window))
    # the stage's own clamp: no shift along an axis one window deep
    _, shift = S.get_window_size(dims, window, tuple(s // 2 for s in window))
    assert shift == (0, 1, 1)
    mask = jnp.asarray(S.compute_shift_mask(dims, window, shift))

    calls = []
    orig = PB.fused_ln_mlp
    monkeypatch.setattr(PB, "fused_ln_mlp",
                        lambda *a, **k: (calls.append(1), orig(*a, **k))[1])

    def jax_blocks(p, xx):
        blocks = p["stages"][0]["blocks"]
        kw = dict(num_heads=heads, window=window, rel_index=rel_index,
                  dp_rate=0.0, deterministic=True, rng=None, interpret=True,
                  use_pallas="hsplit")
        y = S.swin_block(jax.tree.map(lambda t: t[0], blocks), xx,
                         shift=(0, 0, 0), mask=None, **kw)
        return S.swin_block(jax.tree.map(lambda t: t[1], blocks), y,
                            shift=shift, mask=mask, **kw)

    jparams = jax.tree.map(jnp.asarray, params)
    want, vjp = jax.vjp(jax_blocks, jparams, jnp.asarray(x))
    gp, gx = vjp(jnp.asarray(g))
    assert len(calls) == 2, "the JAX blocks did not route through fused_ln_mlp"
    want_grads = swin_state_dict(jax.tree.map(np.asarray, gp), "")

    pcfg = PS.SwinConfig(embed_dim=c, depths=(2, 2), num_heads=(heads, heads),
                         window_size=window)
    model = PS.SwinTransformer3D(pcfg, generator=torch.Generator().manual_seed(0),
                                 ln_mlp=True)
    model.load_state_dict(swin_state_dict(params, ""))
    layer = model.layers[0]
    layer.downsample = None             # the blocks only, as on the JAX side
    routed = []
    real = PS.fused_ln_mlp
    monkeypatch.setattr(PS, "fused_ln_mlp",
                        lambda *a, **k: (routed.append(1), real(*a, **k))[1])
    xt = torch.from_numpy(x).requires_grad_()
    got = layer(xt, True, model.consts, None, None, model.ln_mlp)
    assert len(routed) == 2, "the port's blocks did not route through K7"
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **ROUTE_TOL)
    got.backward(torch.from_numpy(g))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), **ROUTE_TOL)
    checked = 0
    for name, p in layer.blocks.named_parameters():
        w = want_grads[f"layers.0.blocks.{name}"].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, err_msg=name,
                                   **ROUTE_TOL)
        checked += 1
    assert checked == 2 * 13

    # the default route leaves LN2 + MLP to the plain ops: same output
    routed.clear()
    with torch.no_grad():
        plain = layer(xt, True, model.consts, None, None, False)
    assert not routed
    np.testing.assert_allclose(plain.numpy(), np.asarray(want), **ROUTE_TOL)
