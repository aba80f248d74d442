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

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lrce_tpu.models import swin3d as S
from lrce_tpu.ops import pallas_mlp as PM
from lrce_tpu.ops import pallas_swin_block as PB
from lrce_tpu_torch.models import swin3d as PS
from lrce_tpu_torch.ops import mlp as M
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


def test_slab_rows_hold_whole_samples_and_bound_the_workspace():
    """The row slabs of the CUDA entry: within the byte budget, whole
    samples when dp2 indexes them, never more than T."""
    budget = SB.HIDDEN_SLAB_BYTES
    for t, ff, tokens, with_dp in [(882, 4096, 147, True),
                                   (7056, 4096, 147, True),
                                   (7056, 4096, 147, False),
                                   (451584, 512, 9408, False),
                                   (56448, 512, 9408, True), (294, 256, 147, True)]:
        rows = SB.mlp_slab_rows(t, ff, tokens, with_dp)
        assert 1 <= rows <= t
        if with_dp:
            assert rows % tokens == 0
            assert rows == tokens or rows * ff * 2 <= budget
        else:
            assert rows == t or (rows % 128 == 0 and rows * ff * 2 <= budget)


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
