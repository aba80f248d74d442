"""The port's training kernels against the JAX Pallas kernels they replace,
run in interpret mode on the CPU as tests/test_pallas_window_attn.py and
tests/test_pallas_swin_block.py run them:

  - K4 (``window_attention_bwd``, plain version) + the LN1 input backward
    against ``_pallas_bwd_impl`` with two head chunks, with and without the
    mask, and its in-addressing shift against a roll around it;
  - K5 (``mlp_bwd``, plain version) + the LN2 input backward against
    ``_mlp_bwd_impl``, with and without dp2;
  - K6 (``fused_window_attention``, plain version) against the Pallas
    forward, and its shift against a roll around it;
  - the K1, K3 and K2 ``autograd.Function`` gradients against ``jax.vjp``
    of ``fused_swin_block``, ``fused_swin_pair`` and
    ``fused_window_attention_hsplit``.

On the CPU each wrapper runs its plain version inside the same
``autograd.Function`` as on the card, so these tests hold the custom
backward's structure (recompute, K5, K4, LN input backwards, dp scaling)
to the JAX VJPs. Inputs come from numpy with a seed and go to both.

Tolerances. f32: 1e-4 (rtol and atol) for the kernels' outputs, as for the
forward kernels (tests/test_torch_swin_kernels.py): the same f32 math in
other summation orders, and the GELU's erf (XLA's rational approximation
in the Pallas kernel, libm's here). The block gradients chain K6, K5 and
K4 and reduce over every token, and hold to the same 1e-4 (tighter than
the 1e-3 asked of them). bf16: both sides round at the same
points, but an intermediate that lands near a rounding boundary (pb, dS,
dq/dk/dv, dpre, the recomputed h1, dy) can round the other way, and the
JAX forward's softmax denominator is a bf16 lane-sum that the port does
not copy; relative L2 4e-2 per gradient.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lrce_tpu.ops import pallas_swin_block as PSB
from lrce_tpu.ops import pallas_swin_pair as PSP
from lrce_tpu.ops import pallas_window_attn as PWA
from lrce_tpu_torch.models.swin3d import compute_shift_mask
from lrce_tpu_torch.ops import swin_block as SB
from lrce_tpu_torch.ops import window_attn as WA
from lrce_tpu_torch.ops.nn import layer_norm_input_bwd

TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_REL_L2 = 4e-2
B, D, H, W, C, HEADS = 2, 2, 6, 9, 64, 4
WINDOW = (2, 3, 3)
SHIFT = (1, 1, 1)
N = WINDOW[0] * WINDOW[1] * WINDOW[2]
NWIN = (D // WINDOW[0], H // WINDOW[1], W // WINDOW[2])
SENTINEL = np.zeros((1,) * 5, np.float32)
ATTN = ("ln1s", "ln1b", "qkv_w", "qkv_b", "proj_w", "proj_b", "rel_bias")
MLP = ("ln2s", "ln2b", "w1", "b1", "w2", "b2")
MATS = ("qkv_w", "proj_w", "w1", "w2")


def _weights(rng, k=None):
    """Block weights in the JAX layout ((in, out) matrices), numpy f32."""
    lead = () if k is None else (k,)

    def mat(i, o):
        return (rng.normal(size=lead + (i, o)) / np.sqrt(i)).astype(np.float32)

    def vec(m, scale, base=0.0):
        return (base + scale * rng.normal(size=lead + (m,))).astype(np.float32)

    return dict(ln1s=vec(C, 0.2, 1.0), ln1b=vec(C, 0.1), qkv_w=mat(C, 3 * C),
                qkv_b=vec(3 * C, 0.02), proj_w=mat(C, C), proj_b=vec(C, 0.02),
                rel_bias=rng.normal(size=lead + (HEADS, N, N)).astype(np.float32),
                ln2s=vec(C, 0.2, 1.0), ln2b=vec(C, 0.1), w1=mat(C, 4 * C),
                b1=vec(4 * C, 0.02), w2=mat(4 * C, C), b2=vec(C, 0.02))


def _port(p, key, dtype=torch.float32):
    """One weight in the port's layout: nn.Linear (out, in) matrices in
    ``dtype``, everything else f32."""
    v = p[key]
    if key in MATS:
        return torch.from_numpy(np.ascontiguousarray(
            np.swapaxes(v, -1, -2))).to(dtype)
    return torch.from_numpy(np.ascontiguousarray(v))


def _to_jax_layout(key, g):
    """A port gradient (numpy) in the JAX layout."""
    return np.swapaxes(g, -1, -2) if key in MATS else g


def _mask():
    return compute_shift_mask((D, H, W), WINDOW, SHIFT).reshape(*NWIN, N, N)


def _dp(rng, shape):
    return (rng.binomial(1, 0.7, shape) / 0.7).astype(np.float32)


def _close(got, want, tol=TOL, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **tol,
                               err_msg=what)


# ---------------------------------------------------------------------------
# K4
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_k4_plain_matches_pallas_bwd(masked):
    rng = np.random.default_rng(20)
    x = rng.normal(size=(B, D, H, W, C)).astype(np.float32)
    g = rng.normal(size=x.shape).astype(np.float32)
    p = _weights(rng)
    mask = _mask() if masked else None
    want = PWA._pallas_bwd_impl(
        jnp.asarray(x), *(jnp.asarray(p[k]) for k in ATTN),
        jnp.asarray(SENTINEL if mask is None else mask), jnp.asarray(g),
        window=WINDOW, num_heads=HEADS, ln_eps=1e-5, interpret=True,
        chunks=2)
    before = WA.window_attention_bwd.launches
    got = WA.attention_vjp(
        torch.from_numpy(x), torch.from_numpy(g),
        *(_port(p, k) for k in ("ln1s", "ln1b", "qkv_w", "qkv_b", "proj_w",
                                "rel_bias")),
        None if mask is None else torch.from_numpy(mask), WINDOW, HEADS,
        1e-5, WA.NO_SHIFT)
    assert WA.window_attention_bwd.launches == before   # CPU: plain version
    names = ("x", "ln1s", "ln1b", "qkv_w", "qkv_b", "proj_w", "proj_b",
             "rel_bias")
    for name, a, b in zip(names, got, want):
        _close(_to_jax_layout(name, a.numpy()), b, what=name)


def test_k4_shift_equals_roll_around_it():
    """K4's in-addressing shift on an unrolled x and g is the JAX model's
    roll(-s) / backward / roll(+s)."""
    rng = np.random.default_rng(21)
    x = rng.normal(size=(B, D, H, W, C)).astype(np.float32)
    g = rng.normal(size=x.shape).astype(np.float32)
    p = _weights(rng)
    mask = _mask()
    roll = lambda t, s: np.roll(t, s, axis=(1, 2, 3))  # noqa: E731
    neg = tuple(-s for s in SHIFT)
    want = PWA._pallas_bwd_impl(
        jnp.asarray(roll(x, neg)), *(jnp.asarray(p[k]) for k in ATTN),
        jnp.asarray(mask), jnp.asarray(roll(g, neg)), window=WINDOW,
        num_heads=HEADS, ln_eps=1e-5, interpret=True)
    got = WA.attention_vjp(
        torch.from_numpy(x), torch.from_numpy(g),
        *(_port(p, k) for k in ("ln1s", "ln1b", "qkv_w", "qkv_b", "proj_w",
                                "rel_bias")),
        torch.from_numpy(mask), WINDOW, HEADS, 1e-5, SHIFT)
    _close(got[0].numpy(), roll(np.asarray(want[0]), SHIFT), what="dx")
    for name, a, b in zip(("ln1s", "ln1b", "qkv_w", "qkv_b", "proj_w",
                           "proj_b", "rel_bias"), got[1:], want[1:]):
        _close(_to_jax_layout(name, a.numpy()), b, what=name)


# ---------------------------------------------------------------------------
# K5
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_dp", [False, True], ids=["no-dp", "dp"])
def test_k5_plain_matches_pallas_mlp_bwd(with_dp):
    rng = np.random.default_rng(22)
    h1 = rng.normal(size=(B, D, H, W, C)).astype(np.float32)
    g = rng.normal(size=h1.shape).astype(np.float32)
    p = _weights(rng)
    dp2 = _dp(rng, (B,)) if with_dp else None
    want = PSB._mlp_bwd_impl(
        jnp.asarray(h1), jnp.asarray(g), *(jnp.asarray(p[k]) for k in MLP),
        jnp.asarray(np.ones((1, 1), np.float32) if dp2 is None
                    else dp2[:, None]),
        ln_eps=1e-5, interpret=True, ff_chunks=2)
    ht = torch.from_numpy(h1)
    before = SB.mlp_bwd.launches
    dz, dw1, db1, dw2, db2 = SB.mlp_bwd(
        ht, torch.from_numpy(g), *(_port(p, k) for k in ("ln2s", "ln2b", "w1",
                                                          "b1", "w2")),
        None if dp2 is None else torch.from_numpy(dp2), 1e-5)
    assert SB.mlp_bwd.launches == before
    dh1, dls, dlb = layer_norm_input_bwd(ht, dz, _port(p, "ln2s"), 1e-5)
    for name, a, b in zip(("h1", "ln2s", "ln2b", "w1", "b1", "w2", "b2"),
                          (dh1, dls, dlb, dw1, db1, dw2, db2), want):
        _close(_to_jax_layout(name, a.numpy()), b, what=name)


# ---------------------------------------------------------------------------
# K6
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shifted", [False, True], ids=["unshifted", "shifted"])
def test_k6_plain_matches_pallas_fused_attention(shifted):
    """Unshifted: K6 on x against the Pallas kernel on x. Shifted: K6 with
    the shift in its addressing on an unrolled x against the Pallas kernel
    on the rolled x, rolled back."""
    rng = np.random.default_rng(23)
    x = rng.normal(size=(B, D, H, W, C)).astype(np.float32)
    p = _weights(rng)
    mask = _mask() if shifted else None
    shift = SHIFT if shifted else WA.NO_SHIFT
    xin = np.roll(x, tuple(-s for s in shift), axis=(1, 2, 3))
    want = np.roll(np.asarray(PWA.fused_window_attention(
        jnp.asarray(xin), *(jnp.asarray(p[k]) for k in ATTN),
        jnp.asarray(SENTINEL if mask is None else mask), WINDOW, HEADS, 1e-5,
        True)), shift, axis=(1, 2, 3))
    before = WA.fused_window_attention.launches
    got = WA.fused_window_attention(
        torch.from_numpy(x), *(_port(p, k) for k in ATTN),
        None if mask is None else torch.from_numpy(mask), WINDOW, HEADS, 1e-5,
        shift)
    assert WA.fused_window_attention.launches == before
    _close(got.numpy(), want)


# ---------------------------------------------------------------------------
# The K1 / K3 / K2 autograd.Functions against jax.vjp of the Pallas ops
# ---------------------------------------------------------------------------

def _jax_block_args(p, mask, dp1, dp2, dt):
    cast = lambda k: jnp.asarray(p[k]).astype(dt) if k in MATS else jnp.asarray(p[k])  # noqa: E731
    return ([cast(k) for k in ATTN] + [jnp.asarray(mask)]
            + [cast(k) for k in MLP] + [jnp.asarray(dp1), jnp.asarray(dp2)])


def _port_grads(fn, x, p, keys, g, dtype):
    xt = torch.from_numpy(x).to(dtype).requires_grad_()
    leaves = {k: _port(p, k, dtype).requires_grad_() for k in keys}
    out = fn(xt, leaves)
    out.backward(torch.from_numpy(g).to(out.dtype))
    return [xt.grad] + [leaves[k].grad for k in keys]


def _check_grads(got, want, names, bf16):
    for name, a, b in zip(names, got, want):
        a = _to_jax_layout(name, a.float().numpy())
        b = np.asarray(jnp.asarray(b).astype(jnp.float32))
        if bf16:
            rel = np.linalg.norm(a - b) / np.linalg.norm(b)
            assert rel < BF16_REL_L2, (name, rel)
        else:
            _close(a, b, GRAD_TOL, what=name)


@pytest.mark.parametrize("case", ["unshifted", "masked-dp", "bf16"])
def test_k1_function_grads_match_jax_vjp(case):
    rng = np.random.default_rng(24)
    bf16 = case == "bf16"
    tdt, jdt = ((torch.bfloat16, jnp.bfloat16) if bf16
                else (torch.float32, jnp.float32))
    x = rng.normal(size=(B, D, H, W, C)).astype(np.float32)
    g = rng.normal(size=x.shape).astype(np.float32)
    p = _weights(rng)
    masked = case == "masked-dp"
    mask = _mask() if masked else None
    dp1, dp2 = (_dp(rng, (B,)), _dp(rng, (B,))) if masked else (None, None)
    keys = ATTN + MLP

    def jax_fn(xx, *w):
        ws = list(w)
        jargs = ws[:7] + [jnp.asarray(SENTINEL if mask is None else mask)] \
            + ws[7:] + [jnp.asarray(np.ones((1, 1), np.float32) if dp1 is None
                                    else dp1[:, None]),
                        jnp.asarray(np.ones((1, 1), np.float32) if dp2 is None
                                    else dp2[:, None])]
        return PSB.fused_swin_block(xx, *jargs, WINDOW, HEADS, 1e-5, True)

    jw = _jax_block_args(p, SENTINEL, SENTINEL, SENTINEL, jdt)
    jw = jw[:7] + jw[8:14]
    out, vjp = jax.vjp(jax_fn, jnp.asarray(x).astype(jdt), *jw)
    want = vjp(jnp.asarray(g).astype(out.dtype))

    opt = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731

    def port_fn(xt, w):
        return SB.fused_swin_block(xt, *(w[k] for k in ATTN), opt(mask),
                                   *(w[k] for k in MLP), opt(dp1), opt(dp2),
                                   WINDOW, HEADS, 1e-5)

    got = _port_grads(port_fn, x, p, keys, g, tdt)
    _check_grads(got, want, ("x",) + keys, bf16)


@pytest.mark.parametrize("shifts,with_dp", [
    ((SHIFT,), False), ((SHIFT,), True), (((0, 0, 0), SHIFT), True),
], ids=["k1-shifted", "k1-shifted-dp", "k2-pair-dp"])
def test_k3_function_grads_match_jax_vjp(shifts, with_dp):
    rng = np.random.default_rng(25)
    k = len(shifts)
    x = rng.normal(size=(B, D, H, W, C)).astype(np.float32)
    g = rng.normal(size=x.shape).astype(np.float32)
    p = _weights(rng, k)
    mask = _mask()
    dp1, dp2 = ((_dp(rng, (k, B)), _dp(rng, (k, B))) if with_dp
                else (None, None))
    keys = ATTN + MLP
    ones = np.ones((1, 1), np.float32)

    def jax_fn(xx, *w):
        ws = list(w)
        return PSP.fused_swin_pair(
            xx, *ws[:7], jnp.asarray(mask), *ws[7:],
            jnp.asarray(ones if dp1 is None else dp1),
            jnp.asarray(ones if dp2 is None else dp2), WINDOW, HEADS, shifts,
            1e-5, True, with_dp)

    jw = [jnp.asarray(p[kk]) for kk in keys]
    _, vjp = jax.vjp(jax_fn, jnp.asarray(x), *jw)
    want = vjp(jnp.asarray(g))

    opt = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731

    def port_fn(xt, w):
        return SB.fused_swin_pair(xt, *(w[kk] for kk in ATTN),
                                  torch.from_numpy(mask),
                                  *(w[kk] for kk in MLP), opt(dp1), opt(dp2),
                                  WINDOW, HEADS, shifts, 1e-5)

    got = _port_grads(port_fn, x, p, keys, g, torch.float32)
    _check_grads(got, want, ("x",) + keys, False)


@pytest.mark.parametrize("case", ["unmasked", "masked", "bf16"])
def test_k2_function_grads_match_jax_vjp(case):
    rng = np.random.default_rng(26)
    bf16 = case == "bf16"
    tdt, jdt = ((torch.bfloat16, jnp.bfloat16) if bf16
                else (torch.float32, jnp.float32))
    x = rng.normal(size=(B, D, H, W, C)).astype(np.float32)
    g = rng.normal(size=x.shape).astype(np.float32)
    p = _weights(rng)
    mask = _mask() if case == "masked" else None

    def jax_fn(xx, *w):
        return PWA.fused_window_attention_hsplit(
            xx, *w, jnp.asarray(SENTINEL if mask is None else mask), WINDOW,
            HEADS, 1e-5, True)

    jw = _jax_block_args(p, SENTINEL, SENTINEL, SENTINEL, jdt)[:7]
    out, vjp = jax.vjp(jax_fn, jnp.asarray(x).astype(jdt), *jw)
    want = vjp(jnp.asarray(g).astype(out.dtype))

    def port_fn(xt, w):
        return WA.fused_window_attention_hsplit(
            xt, *(w[k] for k in ATTN),
            None if mask is None else torch.from_numpy(mask), WINDOW, HEADS,
            1e-5)

    got = _port_grads(port_fn, x, p, ATTN, g, tdt)
    _check_grads(got, want, ("x",) + ATTN, bf16)


@pytest.mark.parametrize("kind", ["k1-masked-dp", "k3-pair-dp"])
def test_block_wrappers_without_grad_match_the_function(kind):
    """With grad mode off, K1 and K3 run their blocks without the
    autograd.Function; the output is the Function's, bit for bit."""
    rng = np.random.default_rng(27)
    k = 2 if kind.startswith("k3") else 1
    x = torch.from_numpy(rng.normal(size=(B, D, H, W, C)).astype(np.float32))
    p = _weights(rng, None if k == 1 else k)
    w = {key: _port(p, key) for key in ATTN + MLP}
    mask = torch.from_numpy(_mask())
    dp1, dp2 = (torch.from_numpy(_dp(rng, (B,) if k == 1 else (k, B)))
                for _ in range(2))
    if k == 1:
        def run():
            return SB.fused_swin_block(x, *(w[kk] for kk in ATTN), mask,
                                       *(w[kk] for kk in MLP), dp1, dp2,
                                       WINDOW, HEADS)
    else:
        def run():
            return SB.fused_swin_pair(x, *(w[kk] for kk in ATTN), mask,
                                      *(w[kk] for kk in MLP), dp1, dp2,
                                      WINDOW, HEADS, ((0, 0, 0), SHIFT))
    for t in w.values():
        t.requires_grad_()
    with_grad = run()
    assert with_grad.grad_fn is not None
    with torch.no_grad():
        without = run()
    assert without.grad_fn is None
    assert torch.equal(with_grad.detach(), without)
