"""K1 and K3: the whole Swin block (LN1 + window attention + proj + residual
+ LN2 + MLP + residual) as one call, and its shifted form.

``fused_swin_block`` (K1) replaces ``lrce_tpu/ops/pallas_swin_block.py``
(``fused_swin_block`` / ``_block_kernel``): x comes pre-rolled, as in JAX.
``fused_swin_pair`` (K3) replaces ``lrce_tpu/ops/pallas_swin_pair.py``
(``fused_swin_pair`` / ``_pair_kernel`` / ``_one_block``): k = 1 or 2
consecutive blocks on an unrolled x, each with its cyclic shift. Both run
``csrc/swin_block.cu``, where the shift is index arithmetic in the LN1
gather and the proj scatter, so a shifted block costs no roll passes. On
the model's path K1 runs the unshifted blocks of stages 0-2 and K3 (k = 1)
the shifted ones.

A tensor on the CPU goes through the plain PyTorch versions in this module,
which have the kernel's rounding points; a CUDA tensor launches the kernel
or raises. Nothing falls back.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from lrce_tpu_torch.ops import cuda_lib
from lrce_tpu_torch.ops.nn import gelu, layer_norm
from lrce_tpu_torch.ops.window_attn import (Window, attention_proj_f32,
                                            check_attention_shapes,
                                            check_kernel_args, expect_shape,
                                            window_partition, window_reverse)

Shift = Tuple[int, int, int]


def swin_block_plain(x, ln1s, ln1b, qkv_w, qkv_b, proj_w, proj_b, rel_bias,
                     mask, ln2s, ln2b, w1, b1, w2, b2,
                     dp1: Optional[torch.Tensor], dp2: Optional[torch.Tensor],
                     window: Window, num_heads: int,
                     ln_eps: float = 1e-5) -> torch.Tensor:
    """Plain version of K1 on a pre-rolled, window-aligned x."""
    b, d, h, w, c = x.shape
    dt = x.dtype
    y = layer_norm(x, ln1s, ln1b, ln_eps)
    a = attention_proj_f32(window_partition(y, window), qkv_w, qkv_b, proj_w,
                           proj_b, rel_bias, mask, num_heads)
    if dp1 is not None:
        a = (a.reshape(b, -1, c) * dp1.reshape(b, 1, 1).float()).reshape(a.shape)
    h1 = x + window_reverse(a.to(dt), window, b, d, h, w)
    z = layer_norm(h1, ln2s, ln2b, ln_eps)
    hmid = gelu(torch.matmul(z, w1.t()).float() + b1.float()).to(dt)
    out = torch.matmul(hmid, w2.t()).float() + b2.float()
    if dp2 is not None:
        out = out * dp2.reshape(b, 1, 1, 1, 1).float()
    return (h1.float() + out).to(dt)


def swin_pair_plain(x, ln1s, ln1b, qkv_w, qkv_b, proj_w, proj_b, rel_bias,
                    mask, ln2s, ln2b, w1, b1, w2, b2, dp1, dp2,
                    window: Window, num_heads: int, shifts: Sequence[Shift],
                    ln_eps: float = 1e-5) -> torch.Tensor:
    """Plain version of K3: roll by -s, the block, roll by +s, per block."""
    dims = (1, 2, 3)
    for blk, s in enumerate(shifts):
        shifted = any(v != 0 for v in s)
        if shifted:
            x = torch.roll(x, tuple(-v for v in s), dims)
        x = swin_block_plain(
            x, ln1s[blk], ln1b[blk], qkv_w[blk], qkv_b[blk], proj_w[blk],
            proj_b[blk], rel_bias[blk], mask if shifted else None, ln2s[blk],
            ln2b[blk], w1[blk], b1[blk], w2[blk], b2[blk],
            None if dp1 is None else dp1[blk],
            None if dp2 is None else dp2[blk], window, num_heads, ln_eps)
        if shifted:
            x = torch.roll(x, tuple(s), dims)
    return x


def _launch_block(name, x, out, shift, ln1s, ln1b, qkv_w, qkv_b, proj_w,
                  proj_b, rel_bias, mask, ln2s, ln2b, w1, b1, w2, b2, dp1, dp2,
                  window, num_heads, ln_eps, ws) -> None:
    b, d, h, w, c = x.shape
    ff = w1.shape[0]
    check_attention_shapes(name, x, window, num_heads, qkv_w, qkv_b, proj_w,
                           proj_b, rel_bias, mask)
    for t in (ln1s, ln1b, ln2s, ln2b, b2):
        expect_shape(name, t, (c,))
    expect_shape(name, w1, (ff, c))
    expect_shape(name, b1, (ff,))
    expect_shape(name, w2, (c, ff))
    expect_shape(name, dp1, (b,))
    expect_shape(name, dp2, (b,))
    if ff % 8:
        raise ValueError(f"{name}: MLP width {ff} is not a multiple of 8")
    if not all(0 <= v < n for v, n in zip(shift, (d, h, w))):
        raise ValueError(f"{name}: shift {shift} outside dims {(d, h, w)}")
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    rc = cuda_lib.library().lib.lrce_swin_block_fwd(
        x.data_ptr(), out.data_ptr(), b, d, h, w, c, *window, *shift,
        num_heads, ff, ln_eps, *(ptr(t) for t in (
            ln1s, ln1b, qkv_w, qkv_b, proj_w, proj_b, rel_bias, mask, ln2s,
            ln2b, w1, b1, w2, b2, dp1, dp2)),
        *(t.data_ptr() for t in ws),
        torch.cuda.current_stream(x.device).cuda_stream)
    cuda_lib.check(name, rc)


def _workspace(x: torch.Tensor, ff: int):
    b, d, h, w, c = x.shape
    t = b * d * h * w
    return (torch.empty((t, c), dtype=x.dtype, device=x.device),
            torch.empty((t, max(3 * c, ff)), dtype=x.dtype, device=x.device),
            torch.empty((t, c), dtype=x.dtype, device=x.device))


def fused_swin_block(x, ln1s, ln1b, qkv_w, qkv_b, proj_w, proj_b, rel_bias,
                     mask, ln2s, ln2b, w1, b1, w2, b2, dp1, dp2,
                     window: Window, num_heads: int,
                     ln_eps: float = 1e-5) -> torch.Tensor:
    """Whole Swin block on a pre-rolled, window-aligned (B, D, H, W, C) x.

    Weights in nn.Linear layout: qkv_w (3C, C), proj_w (C, C), w1 (FF, C),
    w2 (C, FF); LN parameters and biases f32. rel_bias (nH, N, N) f32. mask
    (nd, nh, nw, N, N) f32, or None for an unshifted block. dp1, dp2: (B, 1)
    f32 per-sample stochastic-depth multipliers, or None when inactive.
    """
    if x.device.type == "cpu":
        return swin_block_plain(x, ln1s, ln1b, qkv_w, qkv_b, proj_w, proj_b,
                                rel_bias, mask, ln2s, ln2b, w1, b1, w2, b2,
                                dp1, dp2, window, num_heads, ln_eps)
    name = "fused_swin_block"
    check_kernel_args(name, x, window, num_heads, (qkv_w, proj_w, w1, w2),
                      (ln1s, ln1b, qkv_b, proj_b, rel_bias, mask, ln2s, ln2b,
                       b1, b2, dp1, dp2))
    out = torch.empty_like(x)
    flat = lambda t: None if t is None else t.reshape(-1)  # noqa: E731
    _launch_block(name, x, out, (0, 0, 0), ln1s, ln1b, qkv_w, qkv_b, proj_w,
                  proj_b, rel_bias, mask, ln2s, ln2b, w1, b1, w2, b2,
                  flat(dp1), flat(dp2), window, num_heads, ln_eps,
                  _workspace(x, w1.shape[0]))
    fused_swin_block.launches += 1
    return out


fused_swin_block.launches = 0


def fused_swin_pair(x, ln1s, ln1b, qkv_w, qkv_b, proj_w, proj_b, rel_bias,
                    mask, ln2s, ln2b, w1, b1, w2, b2, dp1, dp2,
                    window: Window, num_heads: int, shifts: Sequence[Shift],
                    ln_eps: float = 1e-5) -> torch.Tensor:
    """k = len(shifts) consecutive whole blocks on an unrolled,
    window-aligned (B, D, H, W, C) x, the cyclic shifts done in the kernel's
    addressing.

    Per-block weights are stacked on a leading k axis: ln1s (k, C), qkv_w
    (k, 3C, C), ..., rel_bias (k, nH, N, N). mask: (nd, nh, nw, N, N) f32,
    applied to the shifted blocks. dp1, dp2: (k, B) f32 or None. shifts:
    (0, 0, 0) for W-MSA, the stage's shift for SW-MSA.
    """
    if x.device.type == "cpu":
        return swin_pair_plain(x, ln1s, ln1b, qkv_w, qkv_b, proj_w, proj_b,
                               rel_bias, mask, ln2s, ln2b, w1, b1, w2, b2,
                               dp1, dp2, window, num_heads, shifts, ln_eps)
    name = "fused_swin_pair"
    check_kernel_args(name, x, window, num_heads, (qkv_w, proj_w, w1, w2),
                      (ln1s, ln1b, qkv_b, proj_b, rel_bias, mask, ln2s, ln2b,
                       b1, b2, dp1, dp2))
    k = len(shifts)
    if k not in (1, 2) or any(t.shape[0] != k for t in (
            ln1s, ln1b, qkv_w, qkv_b, proj_w, proj_b, rel_bias, ln2s, ln2b,
            w1, b1, w2, b2)):
        raise ValueError(f"{name}: k = {k} shifts need weights stacked on a "
                         "leading axis of k, and k must be 1 or 2")
    ws = _workspace(x, w1.shape[1])
    for blk, s in enumerate(shifts):
        shifted = any(v != 0 for v in s)
        out = torch.empty_like(x)
        _launch_block(name, x, out, tuple(s), ln1s[blk], ln1b[blk], qkv_w[blk],
                      qkv_b[blk], proj_w[blk], proj_b[blk], rel_bias[blk],
                      mask if shifted else None, ln2s[blk], ln2b[blk],
                      w1[blk], b1[blk], w2[blk], b2[blk],
                      None if dp1 is None else dp1[blk],
                      None if dp2 is None else dp2[blk], window, num_heads,
                      ln_eps, ws)
        x = out
    fused_swin_pair.launches += 1
    return x


fused_swin_pair.launches = 0
