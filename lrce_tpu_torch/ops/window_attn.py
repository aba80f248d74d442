"""Window attention kernels: K6 and K2 (forward), K4 (backward), and the
window-attention pieces the Swin kernels share.

- ``fused_window_attention`` (K6) replaces the TPU kernel of the same name
  (``lrce_tpu/ops/pallas_window_attn.py``: ``_kernel`` /
  ``_fused_fwd_impl``): LN1 + window partition + qkv + attention with
  rel_bias [+ mask] + proj + window reverse, no residual. The port adds the
  cyclic shift to its addressing (``csrc/window_attn.cu``), so a shifted
  block needs no roll. It is the forward that the K1/K3 backward recomputes.
- ``fused_window_attention_hsplit`` (K2) replaces ``_hsplit_kernel`` /
  ``_hsplit_fwd_impl``. On the TPU the heads are split into groups only to
  fit VMEM; the CUDA kernel keeps all of C in one pass. On the model's path
  it runs both stage-3 blocks.
- ``window_attention_bwd`` (K4) replaces ``_bwd_chunk_kernel`` /
  ``_pallas_bwd_impl``: it recomputes LN1, qkv and the softmax from the
  block input and returns the LN1-output cotangent dy and the gradients of
  qkv_w, qkv_b, proj_w and rel_bias (``csrc/attn_bwd.cu``). The head chunks
  exist on the TPU only to fit VMEM and do not come across.

K6 and K2 are ``torch.autograd.Function``s whose backward is K4 followed by
the f32 LN1 input backward, as ``_bwd`` / ``_hsplit_bwd`` are.

A tensor on the CPU goes through the plain PyTorch versions in this module,
which have the kernels' rounding points; a CUDA tensor launches the kernel
or raises. Nothing falls back.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Sequence, Tuple

import torch

from lrce_tpu_torch.ops import cuda_lib
from lrce_tpu_torch.ops.nn import (dense, layer_norm, layer_norm_input_bwd,
                                   matmul_f32)

Window = Tuple[int, int, int]
Shift = Tuple[int, int, int]
NO_SHIFT: Shift = (0, 0, 0)


def window_partition(x: torch.Tensor, window: Window) -> torch.Tensor:
    """(B, D, H, W, C) -> (B*nW, N, C)."""
    b, d, h, w, c = x.shape
    x = x.reshape(b, d // window[0], window[0], h // window[1], window[1],
                  w // window[2], window[2], c)
    x = x.permute(0, 1, 3, 5, 2, 4, 6, 7)
    return x.reshape(-1, window[0] * window[1] * window[2], c)


def window_reverse(windows: torch.Tensor, window: Window, b: int, d: int,
                   h: int, w: int) -> torch.Tensor:
    """(B*nW, N, C) -> (B, D, H, W, C)."""
    c = windows.shape[-1]
    x = windows.reshape(b, d // window[0], h // window[1], w // window[2],
                        window[0], window[1], window[2], c)
    x = x.permute(0, 1, 4, 2, 5, 3, 6, 7)
    return x.reshape(b, d, h, w, c)


def roll_shift(x: torch.Tensor, shift: Shift, sign: int) -> torch.Tensor:
    """x rolled by sign * shift over (D, H, W); x itself for no shift."""
    if not any(shift):
        return x
    return torch.roll(x, tuple(sign * s for s in shift), (1, 2, 3))


def _logits_add(logits, rel_bias, mask, num_heads):
    """logits (nb, nH, N, N) + rel_bias (nH, N, N) [+ mask (nd, nh, nw, N, N),
    windows in partition order]."""
    nb, _, n, _ = logits.shape
    if mask is None:
        return logits + rel_bias[None]
    nw = mask.shape[0] * mask.shape[1] * mask.shape[2]
    add = rel_bias[None, None] + mask.reshape(nw, n, n)[None, :, None]
    return (logits.reshape(nb // nw, nw, num_heads, n, n)
            + add).reshape(nb, num_heads, n, n)


def _softmax_f32(logits):
    """Exact f32 softmax with the kernels' reciprocal multiply."""
    e = torch.exp(logits - logits.amax(-1, keepdim=True))
    return e * (1.0 / e.sum(-1, keepdim=True))


def _qkv_heads(win, qkv_w, qkv_b, num_heads):
    """qkv + bias rounded to the activation dtype, q scaled on that value:
    three (nb, nH, N, hd) tensors."""
    nb, n, c = win.shape
    hd = c // num_heads
    dt = win.dtype
    qkv = dense(win, qkv_w, qkv_b).reshape(nb, n, 3, num_heads, hd)
    qkv = qkv.permute(2, 0, 3, 1, 4)                     # (3, nb, nH, N, hd)
    q = (qkv[0].float() * (1.0 / math.sqrt(hd))).to(dt)
    return q, qkv[1], qkv[2]


def _merge_heads(t):
    """(nb, nH, N, hd) -> (nb, N, nH * hd)."""
    nb, nh, n, hd = t.shape
    return t.transpose(1, 2).reshape(nb, n, nh * hd)


def attention_proj_f32(win: torch.Tensor, qkv_w, qkv_b, proj_w, proj_b,
                       rel_bias: torch.Tensor, mask: Optional[torch.Tensor],
                       num_heads: int) -> torch.Tensor:
    """Window attention and proj at the kernels' rounding points.

    win: (B*nW, N, C) normalized tokens; rel_bias: (nH, N, N) f32; mask:
    (nd, nh, nw, N, N) additive or None. Returns proj + bias in f32:
    qkv + bias rounds to the activation dtype, q is scaled on that value,
    logits and softmax are f32, the weights round before P.V, ctx rounds.
    """
    dt = win.dtype
    q, k, v = _qkv_heads(win, qkv_w, qkv_b, num_heads)
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
    weights = _softmax_f32(_logits_add(logits, rel_bias, mask, num_heads))
    ctx = torch.matmul(weights.to(dt).float(), v.float()).to(dt)
    return matmul_f32(_merge_heads(ctx), proj_w) + proj_b.float()


def window_attention_plain(x, ln_scale, ln_bias, qkv_w, qkv_b, proj_w, proj_b,
                           rel_bias, mask, window: Window, num_heads: int,
                           ln_eps: float = 1e-5,
                           shift: Shift = NO_SHIFT) -> torch.Tensor:
    """Plain version of K2 and K6: roll by -shift, LN1 -> partition ->
    attention -> proj -> reverse, roll by +shift."""
    b, d, h, w, _ = x.shape
    y = layer_norm(roll_shift(x, shift, -1), ln_scale, ln_bias, ln_eps)
    out = attention_proj_f32(window_partition(y, window), qkv_w, qkv_b, proj_w,
                             proj_b, rel_bias, mask, num_heads).to(x.dtype)
    return roll_shift(window_reverse(out, window, b, d, h, w), shift, 1)


def window_attention_bwd_plain(x, g, ln_scale, ln_bias, qkv_w, qkv_b, proj_w,
                               rel_bias, mask, window: Window, num_heads: int,
                               ln_eps: float = 1e-5, shift: Shift = NO_SHIFT):
    """Plain version of K4, with ``_bwd_chunk_kernel``'s rounding points.

    x: the block input (B, D, H, W, C); g: the cotangent of the attention
    output, both unrolled. Returns (dy, dqkv_w, dqkv_b, dproj_w, drel): dy
    is the cotangent of the LN1 output in x's layout, summed in f32 and
    rounded once to x's dtype; the others are f32 in the port's layouts
    (qkv_w (3C, C), proj_w (C, C), rel_bias (nH, N, N)).
    """
    b, d, h, w, c = x.shape
    dt = x.dtype
    hd = c // num_heads
    scale = 1.0 / math.sqrt(hd)
    y = layer_norm(roll_shift(x, shift, -1), ln_scale, ln_bias, ln_eps)
    y = window_partition(y, window)                               # (nb, N, C)
    gw = window_partition(roll_shift(g.to(dt), shift, -1), window)
    nb, n, _ = y.shape
    q, k, v = _qkv_heads(y, qkv_w, qkv_b, num_heads)
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
    p = _softmax_f32(_logits_add(logits, rel_bias, mask, num_heads))
    pb = p.to(dt).float()
    ctx = _merge_heads(torch.matmul(pb, v.float()).to(dt))
    # proj backward: dctx = g . proj_w, rounded; dWproj = g^T ctx
    dctx = torch.matmul(gw.float(), proj_w.float()).to(dt)
    dctx = dctx.reshape(nb, n, num_heads, hd).transpose(1, 2).float()
    dproj_w = torch.matmul(gw.reshape(-1, c).float().t(),
                           ctx.reshape(-1, c).float())
    dp = torch.matmul(dctx, v.float().transpose(-1, -2))
    dv = torch.matmul(pb.transpose(-1, -2), dctx)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    drel = ds.sum(0)
    dsb = ds.to(dt).float()
    dq = torch.matmul(dsb, k.float()) * scale
    dk = torch.matmul(dsb.transpose(-1, -2), q.float())
    dqkv = torch.cat([_merge_heads(t) for t in (dq, dk, dv)], -1)  # f32
    dqkv_b = dqkv.sum((0, 1))
    dqkv = dqkv.to(dt).float().reshape(-1, 3 * c)
    dqkv_w = torch.matmul(dqkv.t(), y.reshape(-1, c).float())
    dy = torch.matmul(dqkv, qkv_w.float()).to(dt)
    dy = roll_shift(window_reverse(dy.reshape(nb, n, c), window, b, d, h, w),
               shift, 1)
    return dy, dqkv_w, dqkv_b, dproj_w, drel


def check_kernel_args(name: str, x: torch.Tensor, window: Window,
                      num_heads: int, bf16_args: Sequence[torch.Tensor],
                      f32_args: Sequence[Optional[torch.Tensor]]) -> None:
    """What the CUDA kernels take; anything else raises."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: takes CPU or CUDA tensors, got {x.device}")
    for t in (x, *bf16_args):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name}: activations and weight matrices must "
                            f"be bfloat16, got {t.dtype}")
    for t in f32_args:
        if t is not None and t.dtype != torch.float32:
            raise TypeError(f"{name}: LayerNorm parameters, biases, rel_bias, "
                            f"mask and dp must be float32, got {t.dtype}")
    for t in (x, *bf16_args, *f32_args):
        if t is not None and (t.device != x.device or not t.is_contiguous()):
            raise ValueError(f"{name}: every tensor must be contiguous and on "
                             f"{x.device}")
    b, d, h, w, c = x.shape
    if d % window[0] or h % window[1] or w % window[2]:
        raise ValueError(f"{name}: (D, H, W) = {(d, h, w)} is not a multiple "
                         f"of the window {window}")
    if c % num_heads or (c // num_heads) % 16 or c % 32 or c > 1024:
        raise ValueError(f"{name}: C = {c} with {num_heads} heads; the kernel "
                         "takes C % 32 == 0, C <= 1024, head_dim % 16 == 0")


def expect_shape(name: str, t: Optional[torch.Tensor], shape) -> None:
    if t is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")


def check_shift(name: str, x: torch.Tensor, shift: Shift) -> None:
    if not all(0 <= v < n for v, n in zip(shift, x.shape[1:4])):
        raise ValueError(f"{name}: shift {shift} outside dims "
                         f"{tuple(x.shape[1:4])}")


def check_attention_shapes(name, x, window, num_heads, qkv_w, qkv_b, proj_w,
                           proj_b, rel_bias, mask) -> None:
    _, d, h, w, c = x.shape
    n = window[0] * window[1] * window[2]
    nwin = (d // window[0], h // window[1], w // window[2])
    expect_shape(name, qkv_w, (3 * c, c))
    expect_shape(name, qkv_b, (3 * c,))
    expect_shape(name, proj_w, (c, c))
    expect_shape(name, proj_b, (c,))
    expect_shape(name, rel_bias, (num_heads, n, n))
    expect_shape(name, mask, (*nwin, n, n))


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _attention_fwd_kernel(name, x, ln_scale, ln_bias, qkv_w, qkv_b, proj_w,
                          proj_b, rel_bias, mask, window, num_heads, ln_eps,
                          shift) -> torch.Tensor:
    """Launch K6 (``fused_window_attention``) or K2 (the same kernel with no
    shift) on CUDA tensors."""
    check_kernel_args(name, x, window, num_heads, (qkv_w, proj_w),
                      (ln_scale, ln_bias, qkv_b, proj_b, rel_bias, mask))
    b, d, h, w, c = x.shape
    check_attention_shapes(name, x, window, num_heads, qkv_w, qkv_b, proj_w,
                           proj_b, rel_bias, mask)
    expect_shape(name, ln_scale, (c,))
    expect_shape(name, ln_bias, (c,))
    check_shift(name, x, shift)
    t = b * d * h * w
    out = torch.empty_like(x)
    ws_tc = torch.empty((t, c), dtype=x.dtype, device=x.device)
    ws_qkv = torch.empty((t, 3 * c), dtype=x.dtype, device=x.device)
    rc = cuda_lib.library().lib.lrce_window_attn_fwd(
        x.data_ptr(), out.data_ptr(), b, d, h, w, c, *window, *shift,
        num_heads, ln_eps, ln_scale.data_ptr(), ln_bias.data_ptr(),
        qkv_w.data_ptr(), qkv_b.data_ptr(), proj_w.data_ptr(),
        proj_b.data_ptr(), rel_bias.data_ptr(), _ptr(mask), ws_tc.data_ptr(),
        ws_qkv.data_ptr(), _stream(x))
    cuda_lib.check(name, rc)
    return out


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(x: torch.Tensor) -> int:
    """Streaming multiprocessors of the card that holds the CUDA tensor x."""
    index = x.device.index
    return _sm_count(torch.cuda.current_device() if index is None else index)


def attn_bwd_groups(nwin_total: int, num_heads: int, sms: int) -> int:
    """Window groups of K4's grid: each CTA (group, head) walks its windows
    and owns one f32 partial of drel and of the qkv-bias gradient, summed
    afterwards in a fixed order. About two CTAs per SM of ``sms``."""
    return max(1, min(nwin_total, -(-2 * sms // num_heads)))


def splitk_splits(m: int, n: int, k: int, sms: int) -> int:
    """Splits of the reduction (m rows) of a weight-gradient GEMM with an
    (n, k) output of 64 x 64 tiles: about two CTAs per SM of ``sms``, at
    least 256 rows each."""
    tiles = -(-n // 64) * -(-k // 64)
    return max(1, min(-(-2 * sms // tiles), m // 256))


def _window_attention_bwd_kernel(x, g, ln_scale, ln_bias, qkv_w, qkv_b,
                                 proj_w, rel_bias, mask, window, num_heads,
                                 ln_eps, shift):
    name = "window_attention_bwd"
    check_kernel_args(name, x, window, num_heads, (g, qkv_w, proj_w),
                      (ln_scale, ln_bias, qkv_b, rel_bias, mask))
    b, d, h, w, c = x.shape
    check_attention_shapes(name, x, window, num_heads, qkv_w, qkv_b, proj_w,
                           None, rel_bias, mask)
    expect_shape(name, g, x.shape)
    check_shift(name, x, shift)
    n = window[0] * window[1] * window[2]
    t = b * d * h * w
    sms = sm_count(x)
    groups = attn_bwd_groups(t // n, num_heads, sms)
    splits = splitk_splits(t, 3 * c, c, sms)
    dev = x.device

    def bf(*shape):
        return torch.empty(shape, dtype=torch.bfloat16, device=dev)

    def f32(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    dy = torch.empty_like(x)
    dqkv_w, dqkv_b, dproj_w = f32(3 * c, c), f32(3 * c), f32(c, c)
    drel = f32(num_heads, n, n)
    qkv_wt = qkv_w.t().contiguous()          # (C, 3C): dy = dqkv . qkv_w
    proj_wt = proj_w.t().contiguous()        # (C, C): dctx = g . proj_w
    ws = (bf(t, c), bf(t, 3 * c), bf(t, c), bf(t, c), bf(t, c),
          bf(t, 3 * c), f32(groups, num_heads, n, n), f32(groups, 3 * c),
          f32(splits, 3 * c, c))
    rc = cuda_lib.library().lib.lrce_attn_bwd(
        x.data_ptr(), g.data_ptr(), b, d, h, w, c, *window, *shift,
        num_heads, ln_eps, ln_scale.data_ptr(), ln_bias.data_ptr(),
        qkv_w.data_ptr(), qkv_b.data_ptr(), qkv_wt.data_ptr(),
        proj_wt.data_ptr(), rel_bias.data_ptr(), _ptr(mask),
        dy.data_ptr(), dqkv_w.data_ptr(), dqkv_b.data_ptr(),
        dproj_w.data_ptr(), drel.data_ptr(), *(t_.data_ptr() for t_ in ws),
        groups, splits, _stream(x))
    cuda_lib.check(name, rc)
    window_attention_bwd.launches += 1
    return dy, dqkv_w, dqkv_b, dproj_w, drel


def window_attention_bwd(x, g, ln_scale, ln_bias, qkv_w, qkv_b, proj_w,
                         rel_bias, mask, window: Window, num_heads: int,
                         ln_eps: float = 1e-5, shift: Shift = NO_SHIFT):
    """K4: the backward of K6 / K2 up to the LN1 output.

    x: the block input, g: the cotangent of the attention output, both
    (B, D, H, W, C) and unrolled; shift: the block's cyclic shift, done in
    the kernel's gathers and scatter. Returns (dy, dqkv_w, dqkv_b, dproj_w,
    drel): dy in x's dtype and layout, the rest f32 (see
    ``window_attention_bwd_plain``). On CUDA: x, g, qkv_w, proj_w bf16; LN
    parameters, qkv_b, rel_bias and mask f32.
    """
    if x.device.type == "cpu":
        return window_attention_bwd_plain(x, g, ln_scale, ln_bias, qkv_w,
                                          qkv_b, proj_w, rel_bias, mask,
                                          window, num_heads, ln_eps, shift)
    return _window_attention_bwd_kernel(x, g, ln_scale, ln_bias, qkv_w, qkv_b,
                                        proj_w, rel_bias, mask, window,
                                        num_heads, ln_eps, shift)


window_attention_bwd.launches = 0


def attention_vjp(x, g, ln_scale, ln_bias, qkv_w, qkv_b, proj_w, rel_bias,
                  mask, window, num_heads, ln_eps, shift):
    """Gradients of K6 / K2 for the output cotangent g, as ``_bwd`` forms
    them: K4, then the f32 LN1 input backward and d proj_b = sum g. Weight
    gradients leave in their parameters' dtypes (a bf16 matrix's gradient is
    rounded to bf16 before the cast's backward lifts it to an f32 master)."""
    dy, dqkv_w, dqkv_b, dproj_w, drel = window_attention_bwd(
        x, g, ln_scale, ln_bias, qkv_w, qkv_b, proj_w, rel_bias, mask, window,
        num_heads, ln_eps, shift)
    dx, dls, dlb = layer_norm_input_bwd(x, dy, ln_scale, ln_eps)
    dproj_b = g.float().sum((0, 1, 2, 3))
    return (dx.to(x.dtype), dls.to(ln_scale.dtype), dlb.to(ln_bias.dtype),
            dqkv_w.to(qkv_w.dtype), dqkv_b.to(qkv_b.dtype),
            dproj_w.to(proj_w.dtype), dproj_b, drel.to(rel_bias.dtype))


def _attention_forward(counted, x, ln_scale, ln_bias, qkv_w, qkv_b, proj_w,
                       proj_b, rel_bias, mask, window, num_heads, ln_eps,
                       shift):
    """The plain version on the CPU; on CUDA the kernel of ``counted``
    (``fused_window_attention`` or ``fused_window_attention_hsplit``),
    counted on it."""
    if x.device.type == "cpu":
        return window_attention_plain(x, ln_scale, ln_bias, qkv_w, qkv_b,
                                      proj_w, proj_b, rel_bias, mask, window,
                                      num_heads, ln_eps, shift)
    out = _attention_fwd_kernel(counted.__name__, x, ln_scale, ln_bias, qkv_w,
                                qkv_b, proj_w, proj_b, rel_bias, mask, window,
                                num_heads, ln_eps, shift)
    counted.launches += 1
    return out


class _WindowAttentionFn(torch.autograd.Function):
    """K6 or K2 forward; backward K4 + the LN1 input backward. Saves only
    the inputs, as ``_fwd`` / ``_hsplit_fwd`` do."""

    @staticmethod
    def forward(ctx, counted, x, ln_scale, ln_bias, qkv_w, qkv_b, proj_w,
                proj_b, rel_bias, mask, window, num_heads, ln_eps, shift):
        ctx.save_for_backward(x, ln_scale, ln_bias, qkv_w, qkv_b, proj_w,
                              rel_bias, mask)
        ctx.cfg = (window, num_heads, ln_eps, shift)
        return _attention_forward(counted, x, ln_scale, ln_bias, qkv_w, qkv_b,
                                  proj_w, proj_b, rel_bias, mask, window,
                                  num_heads, ln_eps, shift)

    @staticmethod
    def backward(ctx, g):
        x, ln_scale, ln_bias, qkv_w, qkv_b, proj_w, rel_bias, mask = (
            ctx.saved_tensors)
        grads = attention_vjp(x, g.contiguous(), ln_scale, ln_bias, qkv_w,
                              qkv_b, proj_w, rel_bias, mask, *ctx.cfg)
        return (None, *grads, None, None, None, None, None)


def fused_window_attention(x, ln_scale, ln_bias, qkv_w, qkv_b, proj_w, proj_b,
                           rel_bias, mask, window: Window, num_heads: int,
                           ln_eps: float = 1e-5,
                           shift: Shift = NO_SHIFT) -> torch.Tensor:
    """K6: LN1 + window attention + proj + window reverse, no residual, on
    an unrolled, window-aligned (B, D, H, W, C) x, with the cyclic shift
    in the kernel's addressing (C <= 512 on the model's path).

    Arguments as ``fused_window_attention_hsplit``; shift: the block's
    cyclic shift, (0, 0, 0) for W-MSA. Differentiable: the backward is K4.
    """
    return _WindowAttentionFn.apply(fused_window_attention, x, ln_scale,
                                    ln_bias, qkv_w, qkv_b, proj_w, proj_b,
                                    rel_bias, mask, window, num_heads, ln_eps,
                                    tuple(shift))


fused_window_attention.launches = 0


def fused_window_attention_hsplit(x, ln_scale, ln_bias, qkv_w, qkv_b, proj_w,
                                  proj_b, rel_bias, mask, window: Window,
                                  num_heads: int,
                                  ln_eps: float = 1e-5) -> torch.Tensor:
    """K2: LN1 + window attention + proj + window reverse, no residual.

    x: (B, D, H, W, C), pre-rolled and window-aligned. Weights in nn.Linear
    layout: qkv_w (3C, C), proj_w (C, C); biases and LN parameters (C,) or
    (3C,) f32; rel_bias (nH, N, N) f32; mask (nd, nh, nw, N, N) f32 or None
    for unshifted blocks. On CUDA everything is contiguous, x and the weight
    matrices bf16. Differentiable: the backward is K4.
    """
    return _WindowAttentionFn.apply(fused_window_attention_hsplit, x,
                                    ln_scale, ln_bias, qkv_w, qkv_b, proj_w,
                                    proj_b, rel_bias, mask, window, num_heads,
                                    ln_eps, NO_SHIFT)


fused_window_attention_hsplit.launches = 0
