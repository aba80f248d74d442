"""K2: fused LN1 + window attention + proj on a pre-rolled, window-aligned
(B, D, H, W, C) activation, and the window-attention pieces the Swin
kernels share.

``fused_window_attention_hsplit`` replaces the TPU kernel of the same name
(``lrce_tpu/ops/pallas_window_attn.py``: ``_hsplit_kernel`` /
``_hsplit_fwd_impl``). On the TPU the heads are split into groups only to
fit VMEM; the CUDA kernel (``csrc/window_attn.cu``) keeps all of C in one
pass and needs no split. On the model's path it runs both stage-3 blocks.

A tensor on the CPU goes through the plain PyTorch version in this module,
which has the kernel's rounding points; a CUDA tensor launches the kernel or
raises. Nothing falls back.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch

from lrce_tpu_torch.ops import cuda_lib
from lrce_tpu_torch.ops.nn import dense, layer_norm

Window = Tuple[int, int, int]


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


def attention_proj_f32(win: torch.Tensor, qkv_w, qkv_b, proj_w, proj_b,
                       rel_bias: torch.Tensor, mask: Optional[torch.Tensor],
                       num_heads: int) -> torch.Tensor:
    """Window attention and proj at the kernels' rounding points.

    win: (B*nW, N, C) normalized tokens; rel_bias: (nH, N, N) f32; mask:
    (nd, nh, nw, N, N) additive or None. Returns proj + bias in f32:
    qkv + bias rounds to the activation dtype, q is scaled on that value,
    logits and softmax are f32, the weights round before P.V, ctx rounds.
    """
    nb, n, c = win.shape
    hd = c // num_heads
    dt = win.dtype
    qkv = dense(win, qkv_w, qkv_b).reshape(nb, n, 3, num_heads, hd)
    qkv = qkv.permute(2, 0, 3, 1, 4)                     # (3, nb, nH, N, hd)
    q = (qkv[0].float() * (1.0 / math.sqrt(hd))).to(dt)
    logits = torch.matmul(q.float(), qkv[1].float().transpose(-1, -2))
    if mask is None:
        logits = logits + rel_bias[None]
    else:
        nw = mask.shape[0] * mask.shape[1] * mask.shape[2]
        add = rel_bias[None, None] + mask.reshape(nw, n, n)[None, :, None]
        logits = (logits.reshape(nb // nw, nw, num_heads, n, n)
                  + add).reshape(nb, num_heads, n, n)
    e = torch.exp(logits - logits.amax(-1, keepdim=True))
    weights = (e * (1.0 / e.sum(-1, keepdim=True))).to(dt)
    ctx = torch.matmul(weights.float(), qkv[2].float()).to(dt)
    ctx = ctx.transpose(1, 2).reshape(nb, n, c)
    return torch.matmul(ctx, proj_w.t()).float() + proj_b.float()


def window_attention_plain(x, ln_scale, ln_bias, qkv_w, qkv_b, proj_w, proj_b,
                           rel_bias, mask, window: Window, num_heads: int,
                           ln_eps: float = 1e-5) -> torch.Tensor:
    """Plain version of K2: LN1 -> partition -> attention -> proj -> reverse."""
    b, d, h, w, _ = x.shape
    y = layer_norm(x, ln_scale, ln_bias, ln_eps)
    out = attention_proj_f32(window_partition(y, window), qkv_w, qkv_b, proj_w,
                             proj_b, rel_bias, mask, num_heads).to(x.dtype)
    return window_reverse(out, window, b, d, h, w)


def check_kernel_args(name: str, x: torch.Tensor, window: Window,
                      num_heads: int, bf16_args: Sequence[torch.Tensor],
                      f32_args: Sequence[Optional[torch.Tensor]]) -> None:
    """What the CUDA kernels take; anything else raises."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: takes CPU or CUDA tensors, got {x.device}")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, *bf16_args, *f32_args)):
        raise RuntimeError(f"{name}: the CUDA kernel is forward-only; "
                           "call it under torch.no_grad()")
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


def fused_window_attention_hsplit(x, ln_scale, ln_bias, qkv_w, qkv_b, proj_w,
                                  proj_b, rel_bias, mask, window: Window,
                                  num_heads: int,
                                  ln_eps: float = 1e-5) -> torch.Tensor:
    """LN1 + window attention + proj + window reverse, no residual.

    x: (B, D, H, W, C), pre-rolled and window-aligned. Weights in nn.Linear
    layout: qkv_w (3C, C), proj_w (C, C); biases and LN parameters (C,) or
    (3C,) f32; rel_bias (nH, N, N) f32; mask (nd, nh, nw, N, N) f32 or None
    for unshifted blocks. On CUDA everything is contiguous, x and the weight
    matrices bf16.
    """
    if x.device.type == "cpu":
        return window_attention_plain(x, ln_scale, ln_bias, qkv_w, qkv_b,
                                      proj_w, proj_b, rel_bias, mask, window,
                                      num_heads, ln_eps)
    name = "fused_window_attention_hsplit"
    check_kernel_args(name, x, window, num_heads, (qkv_w, proj_w),
                      (ln_scale, ln_bias, qkv_b, proj_b, rel_bias, mask))
    b, d, h, w, c = x.shape
    check_attention_shapes(name, x, window, num_heads, qkv_w, qkv_b, proj_w,
                           proj_b, rel_bias, mask)
    expect_shape(name, ln_scale, (c,))
    expect_shape(name, ln_bias, (c,))
    t = b * d * h * w
    out = torch.empty_like(x)
    ws_tc = torch.empty((t, c), dtype=x.dtype, device=x.device)
    ws_qkv = torch.empty((t, 3 * c), dtype=x.dtype, device=x.device)
    rc = cuda_lib.library().lib.lrce_window_attn_fwd(
        x.data_ptr(), out.data_ptr(), b, d, h, w, c, *window, num_heads,
        ln_eps, ln_scale.data_ptr(), ln_bias.data_ptr(), qkv_w.data_ptr(),
        qkv_b.data_ptr(), proj_w.data_ptr(), proj_b.data_ptr(),
        rel_bias.data_ptr(), None if mask is None else mask.data_ptr(),
        ws_tc.data_ptr(), ws_qkv.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream)
    cuda_lib.check(name, rc)
    fused_window_attention_hsplit.launches += 1
    return out


fused_window_attention_hsplit.launches = 0
