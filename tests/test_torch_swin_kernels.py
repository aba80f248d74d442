"""The port's Swin kernel modules (lrce_tpu_torch/ops/swin_block.py: K1, K3;
ops/window_attn.py: K2) against the JAX Pallas kernels they replace, run in
interpret mode on the CPU as tests/test_pallas_swin_block.py runs them.

On the CPU each wrapper runs its plain PyTorch version, so these tests hold
the plain versions to the JAX kernels; chip_smoke.py and
tests/test_torch_cuda_kernels.py hold the CUDA kernels to the plain
versions on the card. Inputs come from numpy and go to both.

Tolerance 1e-4 (rtol and atol), f32: both sides compute the same f32
expressions (LayerNorm, softmax, exact GELU, f32 products) and differ in
summation order and in the GELU's erf (XLA's rational approximation in the
Pallas kernel, libm's erf here), a few f32 ulps on outputs of order 1.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lrce_tpu.ops import pallas_swin_block as PSB
from lrce_tpu.ops import pallas_swin_pair as PSP
from lrce_tpu.ops import pallas_window_attn as PWA
from lrce_tpu_torch.models.swin3d import compute_shift_mask
from lrce_tpu_torch.ops import swin_block as SB
from lrce_tpu_torch.ops import window_attn as WA

TOL = dict(rtol=1e-4, atol=1e-4)
B, D, H, W, C, HEADS = 2, 2, 6, 9, 64, 4
WINDOW = (2, 3, 3)
SHIFT = (1, 1, 1)
N = WINDOW[0] * WINDOW[1] * WINDOW[2]
NWIN = (D // WINDOW[0], H // WINDOW[1], W // WINDOW[2])


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


_MATS = ("qkv_w", "proj_w", "w1", "w2")
_ORDER = ("ln1s", "ln1b", "qkv_w", "qkv_b", "proj_w", "proj_b", "rel_bias")
_MLP = ("ln2s", "ln2b", "w1", "b1", "w2", "b2")


def _jax_args(p, mask, dp1, dp2):
    """Positional arguments of the JAX kernels (x excluded)."""
    sentinel = np.zeros((1,) * 5, np.float32)
    ones = np.ones((1, 1), np.float32)
    return ([jnp.asarray(p[k]) for k in _ORDER]
            + [jnp.asarray(sentinel if mask is None else mask)]
            + [jnp.asarray(p[k]) for k in _MLP]
            + [jnp.asarray(ones if dp1 is None else dp1),
               jnp.asarray(ones if dp2 is None else dp2)])


def _port_args(p, mask, dp1, dp2):
    """Positional arguments of the port's wrappers (x excluded): nn.Linear
    layout, None for no mask / no drop path."""
    def t(k):
        v = p[k]
        if k in _MATS:
            v = np.swapaxes(v, -1, -2)
        return torch.from_numpy(np.ascontiguousarray(v))

    opt = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    return ([t(k) for k in _ORDER] + [opt(mask)] + [t(k) for k in _MLP]
            + [opt(dp1), opt(dp2)])


def _mask():
    return compute_shift_mask((D, H, W), WINDOW, SHIFT).reshape(*NWIN, N, N)


def _dp(rng, shape):
    return (rng.binomial(1, 0.7, shape) / 0.7).astype(np.float32)


@pytest.mark.parametrize("masked,with_dp", [(False, False), (True, False),
                                            (True, True), (False, True)],
                         ids=["unshifted", "shifted", "shifted-dp",
                              "unshifted-dp"])
def test_k1_matches_pallas_block(masked, with_dp):
    rng = np.random.default_rng(10)
    x = rng.normal(size=(B, D, H, W, C)).astype(np.float32)
    p = _weights(rng)
    mask = _mask() if masked else None
    dp1, dp2 = (_dp(rng, (B, 1)), _dp(rng, (B, 1))) if with_dp else (None, None)
    want = PSB.fused_swin_block(jnp.asarray(x), *_jax_args(p, mask, dp1, dp2),
                                WINDOW, HEADS, 1e-5, True)
    before = SB.fused_swin_block.launches
    got = SB.fused_swin_block(torch.from_numpy(x), *_port_args(p, mask, dp1, dp2),
                              WINDOW, HEADS, 1e-5)
    assert SB.fused_swin_block.launches == before   # CPU: plain version
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("shifts,with_dp", [
    ((SHIFT,), False),
    (((0, 0, 0), SHIFT), False),
    (((0, 0, 0), SHIFT), True),
], ids=["k1-shifted", "k2-pair", "k2-pair-dp"])
def test_k3_matches_pallas_pair(shifts, with_dp):
    rng = np.random.default_rng(11)
    k = len(shifts)
    x = rng.normal(size=(B, D, H, W, C)).astype(np.float32)
    p = _weights(rng, k)
    mask = _mask()
    dp1, dp2 = (_dp(rng, (k, B)), _dp(rng, (k, B))) if with_dp else (None, None)
    want = PSP.fused_swin_pair(jnp.asarray(x), *_jax_args(p, mask, dp1, dp2),
                               WINDOW, HEADS, shifts, 1e-5, True, with_dp)
    before = SB.fused_swin_pair.launches
    got = SB.fused_swin_pair(torch.from_numpy(x), *_port_args(p, mask, dp1, dp2),
                             WINDOW, HEADS, shifts, 1e-5)
    assert SB.fused_swin_pair.launches == before
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("masked", [False, True], ids=["unshifted", "shifted"])
def test_k2_matches_pallas_hsplit(masked):
    rng = np.random.default_rng(12)
    x = rng.normal(size=(B, D, H, W, C)).astype(np.float32)
    p = _weights(rng)
    mask = _mask() if masked else None
    jargs = _jax_args(p, mask, None, None)[:8]
    want = PWA.fused_window_attention_hsplit(jnp.asarray(x), *jargs, WINDOW,
                                             HEADS, 1e-5, True)
    before = WA.fused_window_attention_hsplit.launches
    got = WA.fused_window_attention_hsplit(
        torch.from_numpy(x), *_port_args(p, mask, None, None)[:8], WINDOW,
        HEADS, 1e-5)
    assert WA.fused_window_attention_hsplit.launches == before
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_k3_shift_equals_roll_around_k1():
    """K3's in-kernel shift is the JAX model's roll(-s) / block / roll(+s)
    around K1 (swin3d.swin_block's "full" route)."""
    rng = np.random.default_rng(13)
    x = rng.normal(size=(B, D, H, W, C)).astype(np.float32)
    p = _weights(rng)
    mask = _mask()
    rolled = np.roll(x, tuple(-s for s in SHIFT), axis=(1, 2, 3))
    want = np.roll(np.asarray(PSB.fused_swin_block(
        jnp.asarray(rolled), *_jax_args(p, mask, None, None), WINDOW, HEADS,
        1e-5, True)), SHIFT, axis=(1, 2, 3))
    stacked = [t.unsqueeze(0) if t is not None and i != 7 else t
               for i, t in enumerate(_port_args(p, mask, None, None))]
    got = SB.fused_swin_pair(torch.from_numpy(x), *stacked, WINDOW, HEADS,
                             (SHIFT,), 1e-5)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("fn", ["block", "pair", "hsplit"])
def test_wrappers_refuse_non_cuda_devices(fn):
    """Only a CPU tensor takes the plain version; any other device must
    reach the kernel or raise, never fall back."""
    x = torch.empty((B, D, H, W, C), device="meta")
    args = [torch.empty(1, device="meta")] * 16
    with pytest.raises(ValueError, match="CPU or CUDA"):
        if fn == "block":
            SB.fused_swin_block(x, *args, WINDOW, HEADS)
        elif fn == "pair":
            SB.fused_swin_pair(x, *args, WINDOW, HEADS, (SHIFT,))
        else:
            WA.fused_window_attention_hsplit(x, *args[:8], WINDOW, HEADS)
