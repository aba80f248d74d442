"""K8: LayerNorm + MLP + residual of one transformer block, eval forward,
C <= 128 on the shapes it was written for (Swin stage 0: (B, 3, 56, 56, 128)).

``fused_mlp`` replaces the TPU kernel ``_kernel`` / ``_fwd_impl`` of
``lrce_tpu/ops/pallas_mlp.py``: out = x + fc2(gelu(fc1(LN(x)))). It is a
public op that no model routes, reached through this entry point. Like
``_kernel``, which keeps a (sample, depth slice) in VMEM, its kernel keeps
a tile of 128 rows on chip from LN to the residual: at C = 128 and 256
with FF = 4 C it is the core of K1 / K3's back half (``csrc/back_half.cu``
without proj and without the window scatter), one launch a call; at the
other widths K7's kernel (``csrc/ln_mlp.cu``) without dp2 runs it, also
one launch. ``mlp_route`` is that rule. The backward differentiates the
plain version on the saved inputs, as ``_bwd`` does with the XLA
equivalent.

A tensor on the CPU goes through the plain version; a CUDA tensor launches
the kernel or raises.
"""

from __future__ import annotations

import torch

from lrce_tpu_torch.ops import cuda_lib
from lrce_tpu_torch.ops.swin_block import (back_half_supported,
                                           ln_mlp_forward, ln_mlp_plain,
                                           ln_mlp_supported)
from lrce_tpu_torch.ops.window_attn import check_kernel_args, expect_shape


def fused_mlp_plain(x, ln_scale, ln_bias, w1, b1, w2, b2,
                    ln_eps: float = 1e-5) -> torch.Tensor:
    """Plain version of K8, with ``_kernel``'s rounding points: K7's plain
    version without dp2."""
    return ln_mlp_plain(x, ln_scale, ln_bias, w1, b1, w2, b2, None, ln_eps)


def mlp_route(c: int, ff: int) -> str:
    """The kernel K8 runs at this width, decided before any launch:
    "core" (the back half's one-CTA core) at C = 128 or 256 with FF = 4 C,
    "ln_mlp" (K7's kernel) at the other widths that kernel takes, else
    "none" (the wrapper raises)."""
    if back_half_supported(c, ff):
        return "core"
    return "ln_mlp" if ln_mlp_supported(c, ff) else "none"


def _forward(x, ln_scale, ln_bias, w1, b1, w2, b2, ln_eps):
    if x.device.type == "cpu":
        return fused_mlp_plain(x, ln_scale, ln_bias, w1, b1, w2, b2, ln_eps)
    c, ff = x.shape[-1], w1.shape[0]
    route = mlp_route(c, ff)
    if route == "ln_mlp":
        return ln_mlp_forward(fused_mlp, x, ln_scale, ln_bias, w1, b1, w2,
                              b2, None, ln_eps)
    name = "fused_mlp"
    if route == "none":
        raise ValueError(f"{name}: takes C = 128 or 256 with FF = 4 C, or C "
                         f"a multiple of 64 up to 1024 and FF a multiple of "
                         f"128, got C = {c}, FF = {ff}")
    check_kernel_args(name, x, (1, 1, 1), 1, (w1, w2),
                      (ln_scale, ln_bias, b1, b2))
    for t in (ln_scale, ln_bias, b2):
        expect_shape(name, t, (c,))
    expect_shape(name, w1, (ff, c))
    expect_shape(name, b1, (ff,))
    expect_shape(name, w2, (c, ff))
    out = torch.empty_like(x)
    rc = cuda_lib.library().lib.lrce_fused_mlp(
        x.data_ptr(), out.data_ptr(), x.numel() // c, c, ln_eps,
        ln_scale.data_ptr(), ln_bias.data_ptr(), w1.data_ptr(),
        b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream)
    cuda_lib.check(name, rc)
    fused_mlp.launches += 1
    return out


class _FusedMlpFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ln_scale, ln_bias, w1, b1, w2, b2, ln_eps):
        ctx.save_for_backward(x, ln_scale, ln_bias, w1, b1, w2, b2)
        ctx.ln_eps = ln_eps
        return _forward(x, ln_scale, ln_bias, w1, b1, w2, b2, ln_eps)

    @staticmethod
    def backward(ctx, g):
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in ctx.saved_tensors]
            out = fused_mlp_plain(*leaves, ctx.ln_eps)
        return (*torch.autograd.grad(out, leaves, g.to(out.dtype)), None)


def fused_mlp(x, ln_scale, ln_bias, w1, b1, w2, b2,
              ln_eps: float = 1e-5) -> torch.Tensor:
    """K8: x + fc2(gelu(fc1(LN(x)))) on (B, D, H, W, C).

    w1 (FF, C), w2 (C, FF) in nn.Linear layout, in x's dtype; LN parameters
    and biases f32. On CUDA: x, w1, w2 bf16 and contiguous, the width one
    ``mlp_route`` takes. Differentiable through the plain version; with
    grad mode off the kernel runs without the autograd.Function."""
    if not torch.is_grad_enabled():
        return _forward(x, ln_scale, ln_bias, w1, b1, w2, b2, ln_eps)
    return _FusedMlpFn.apply(x, ln_scale, ln_bias, w1, b1, w2, b2, ln_eps)


fused_mlp.launches = 0
