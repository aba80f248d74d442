"""The one-launch back half of K1 / K3 (lrce_tpu_torch/ops/swin_block.py
``swin_back_half``, csrc/back_half.cu) and the Swin stage's choice of route
by the attention kernels' shape rule (ops/window_attn.attn_supported), on
the CPU.

On the CPU ``swin_back_half`` runs its plain version, ``back_half_plain``.
Composed with the plain front half (LN1 + window gather, qkv, the attention
core) it must give the block:
  - against ``swin_block_plain`` / ``swin_pair_plain`` at f32: the same
    expressions in another grouping (the proj and the residual before or
    after the scatter), 1e-5 (rtol and atol) on outputs of order 1;
  - against lrce_tpu's ``fused_swin_block`` / ``fused_swin_pair`` in
    interpret mode: 1e-4, the tolerance of tests/test_torch_swin_kernels.py
    (summation order and XLA's erf against libm's).
T = 216 rows at (2, 2, 6, 9) is not a multiple of the kernel's 128-row tile.
The kernel itself is held to this plain version on the card by
tests/test_torch_cuda_kernels.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lrce_tpu.ops import pallas_swin_block as PSB
from lrce_tpu.ops import pallas_swin_pair as PSP
from lrce_tpu_torch.models import swin3d as PS
from lrce_tpu_torch.models.swin3d import compute_shift_mask
from lrce_tpu_torch.ops import gemm as G
from lrce_tpu_torch.ops import swin_block as SB
from lrce_tpu_torch.ops import window_attn as WA

TOL_F32 = dict(rtol=1e-5, atol=1e-5)
TOL_JAX = dict(rtol=1e-4, atol=1e-4)
B, D, H, W = 2, 2, 6, 9
WINDOW = (2, 3, 3)
SHIFT = (1, 1, 1)
N = WINDOW[0] * WINDOW[1] * WINDOW[2]
NWIN = (D // WINDOW[0], H // WINDOW[1], W // WINDOW[2])
WIDTHS = [(64, 2), (128, 4)]          # (C, heads): head_dim 32


def _weights(rng, c, heads):
    """Block weights in the JAX layout ((in, out) matrices), numpy f32."""
    def mat(i, o):
        return (rng.normal(size=(i, o)) / np.sqrt(i)).astype(np.float32)

    def vec(m, scale, base=0.0):
        return (base + scale * rng.normal(size=(m,))).astype(np.float32)

    return dict(ln1s=vec(c, 0.2, 1.0), ln1b=vec(c, 0.1), qkv_w=mat(c, 3 * c),
                qkv_b=vec(3 * c, 0.02), proj_w=mat(c, c), proj_b=vec(c, 0.02),
                rel_bias=rng.normal(size=(heads, N, N)).astype(np.float32),
                ln2s=vec(c, 0.2, 1.0), ln2b=vec(c, 0.1), w1=mat(c, 4 * c),
                b1=vec(4 * c, 0.02), w2=mat(4 * c, c), b2=vec(c, 0.02))


def _port(p):
    """torch tensors, matrices in nn.Linear layout."""
    return {k: torch.from_numpy(np.ascontiguousarray(
        v.T if k in ("qkv_w", "proj_w", "w1", "w2") else v))
        for k, v in p.items()}


def _mask():
    return compute_shift_mask((D, H, W), WINDOW, SHIFT).reshape(*NWIN, N, N)


def _front(x, t, mask, heads, shift):
    """The plain front half: LN1 + gather, qkv + bias, the attention core:
    ctx (T, C) in window order."""
    c = x.shape[-1]
    y = G.ln_rows_plain(x, t["ln1s"], t["ln1b"], WINDOW, shift, 1e-5,
                        gather=True)
    qkv = G.gemm_bf16_plain(y, t["qkv_w"], G.EPI_BIAS, bias=t["qkv_b"])
    ctx = WA.window_attention_core_plain(qkv.reshape(-1, N, 3 * c),
                                         t["rel_bias"], mask, heads)
    return ctx.reshape(-1, c)


def _back(ctx, x, t, dp1, dp2, shift, entry=SB.back_half_plain):
    return entry(ctx, x, t["proj_w"], t["proj_b"], t["ln2s"], t["ln2b"],
                 t["w1"], t["b1"], t["w2"], t["b2"], dp1, dp2, WINDOW, shift)


def _case(seed, c, heads, shifted, with_dp):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, D, H, W, c)).astype(np.float32)
    p = _weights(rng, c, heads)
    dp = [(rng.binomial(1, 0.7, (B,)) / 0.7).astype(np.float32)
          if with_dp else None for _ in range(2)]
    mask = _mask() if shifted else None
    return x, p, dp, mask


CASES = [(False, False), (True, False), (False, True), (True, True)]
IDS = ["unshifted", "shifted", "unshifted-dp", "shifted-dp"]


@pytest.mark.parametrize("c,heads", WIDTHS, ids=["c64", "c128"])
@pytest.mark.parametrize("shifted,with_dp", CASES, ids=IDS)
def test_back_half_composes_to_the_plain_block(c, heads, shifted, with_dp):
    x, p, dp, mask = _case(20, c, heads, shifted, with_dp)
    t = _port(p)
    xt = torch.from_numpy(x)
    dpt = [None if d is None else torch.from_numpy(d) for d in dp]
    shift = SHIFT if shifted else (0, 0, 0)
    mt = None if mask is None else torch.from_numpy(mask)
    got = _back(_front(xt, t, mt, heads, shift), xt, t, *dpt, shift)
    wts = [t[k] for k in ("ln1s", "ln1b", "qkv_w", "qkv_b", "proj_w",
                          "proj_b", "rel_bias")]
    mlp = [t[k] for k in ("ln2s", "ln2b", "w1", "b1", "w2", "b2")]
    if shifted:
        one = lambda v: None if v is None else v[None]  # noqa: E731
        want = SB.swin_pair_plain(xt, *(v[None] for v in wts), mt,
                                  *(v[None] for v in mlp), one(dpt[0]),
                                  one(dpt[1]), WINDOW, heads, (SHIFT,))
    else:
        want = SB.swin_block_plain(xt, *wts, None, *mlp, *dpt, WINDOW, heads)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL_F32)


def _jax_args(p, mask, dp1, dp2, lead):
    """Positional arguments of the JAX kernels (x excluded); lead: stack
    on a leading axis of 1 (the pair kernel)."""
    order = ("ln1s", "ln1b", "qkv_w", "qkv_b", "proj_w", "proj_b",
             "rel_bias")
    mlp = ("ln2s", "ln2b", "w1", "b1", "w2", "b2")
    st = (lambda a: a[None]) if lead else (lambda a: a)
    sentinel = np.zeros((1,) * 5, np.float32)
    ones = np.ones((1, 1), np.float32)
    dps = [ones if d is None else (d[None] if lead else d[:, None])
           for d in (dp1, dp2)]
    return ([jnp.asarray(st(p[k])) for k in order]
            + [jnp.asarray(sentinel if mask is None else mask)]
            + [jnp.asarray(st(p[k])) for k in mlp]
            + [jnp.asarray(d) for d in dps])


@pytest.mark.parametrize("c,heads", WIDTHS, ids=["c64", "c128"])
@pytest.mark.parametrize("shifted,with_dp", CASES, ids=IDS)
def test_back_half_composes_to_the_pallas_block(c, heads, shifted, with_dp):
    x, p, dp, mask = _case(21, c, heads, shifted, with_dp)
    t = _port(p)
    xt = torch.from_numpy(x)
    dpt = [None if d is None else torch.from_numpy(d) for d in dp]
    shift = SHIFT if shifted else (0, 0, 0)
    mt = None if mask is None else torch.from_numpy(mask)
    before = SB.swin_back_half.launches
    got = _back(_front(xt, t, mt, heads, shift), xt, t, *dpt, shift,
                entry=SB.swin_back_half)
    assert SB.swin_back_half.launches == before        # CPU: plain version
    if shifted:
        want = PSP.fused_swin_pair(jnp.asarray(x),
                                   *_jax_args(p, mask, *dp, True), WINDOW,
                                   heads, (SHIFT,), 1e-5, True, with_dp)
    else:
        want = PSB.fused_swin_block(jnp.asarray(x),
                                    *_jax_args(p, None, *dp, False), WINDOW,
                                    heads, 1e-5, True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL_JAX)


def test_back_half_widths():
    assert SB.back_half_supported(128, 512) and SB.back_half_supported(256, 1024)
    assert not SB.back_half_supported(512, 2048)      # stage 2: four launches
    assert not SB.back_half_supported(128, 256)       # FF must be 4 C
    assert not SB.back_half_supported(64, 256)


def test_back_half_refuses_other_devices():
    x = torch.empty((B, D, H, W, 128), device="meta")
    args = [torch.empty(1, device="meta")] * 11
    with pytest.raises(ValueError, match="CPU or CUDA"):
        SB.swin_back_half(args[0], x, *args[1:], WINDOW)


# ---------------------------------------------------------------------------
# K4's shape rule and the stage's route
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,hd,ok", [(147, 32, True), (160, 16, True),
                                     (392, 32, True), (147, 64, False),
                                     (161, 32, True), (432, 32, True),
                                     (448, 16, True), (449, 32, False),
                                     (1152, 32, False)])
def test_attn_bwd_supported(n, hd, ok):
    assert WA.attn_supported(n, hd) is ok


def _routes(monkeypatch):
    seen = []
    for name in ("swin_block", "fused_swin_block", "fused_swin_pair"):
        real = getattr(PS, name)

        def spy(*a, _real=real, _name=name, **k):
            seen.append(_name)
            return _real(*a, **k)

        monkeypatch.setattr(PS, name, spy)
    return seen


@pytest.mark.parametrize("frames,grad,route", [
    (8, True, "fused_swin_block"),      # N = 392: K4's rows / columns pair
    (8, False, "fused_swin_block"),     # no backward: the kernels
    (3, True, "fused_swin_block"),      # N = 147: the kernels
], ids=["n392-grad", "n392-nograd", "n147-grad"])
def test_stage_route_by_k4_shape(monkeypatch, frames, grad, route):
    cfg = PS.SwinConfig(embed_dim=64, depths=(2,), num_heads=(2,),
                        window_size=(8, 7, 7))
    layer = PS.BasicLayer(64, 2, 2, cfg, False, torch.float32,
                          torch.Generator().manual_seed(0))
    x = torch.randn((1, frames, 7, 7, 64),
                    generator=torch.Generator().manual_seed(1))
    seen = _routes(monkeypatch)
    with torch.set_grad_enabled(grad):
        out = layer(x, True, PS.DeviceConstants())
    assert out.shape == x.shape and torch.isfinite(out).all()
    assert seen[0] == route and len(seen) == 2


def test_stage_takes_the_plain_block_where_k4_refuses(monkeypatch):
    """head_dim 64 (one head at C = 64), which no attention kernel takes:
    both blocks run the plain block, with grad mode on and off alike."""
    cfg = PS.SwinConfig(embed_dim=64, depths=(2,), num_heads=(1,),
                        window_size=(8, 7, 7))
    layer = PS.BasicLayer(64, 2, 1, cfg, False, torch.float32,
                          torch.Generator().manual_seed(0))
    x = torch.randn((1, 3, 7, 7, 64),
                    generator=torch.Generator().manual_seed(1))
    seen = _routes(monkeypatch)
    out = layer(x, True, PS.DeviceConstants())
    assert torch.isfinite(out).all() and seen == ["swin_block"] * 2
    seen.clear()
    with torch.no_grad():
        layer(x, True, PS.DeviceConstants())
    assert seen == ["swin_block"] * 2
