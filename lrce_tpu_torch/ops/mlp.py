"""K8: LayerNorm + MLP + residual of one transformer block, eval forward,
C <= 128 on the shapes it was written for (Swin stage 0: (B, 3, 56, 56, 128)).

``fused_mlp`` replaces the TPU kernel ``_kernel`` / ``_fwd_impl`` of
``lrce_tpu/ops/pallas_mlp.py``: out = x + fc2(gelu(fc1(LN(x)))). It is a
public op that no model routes, reached through this entry point. Its
kernel is ``csrc/ln_mlp.cu``, the entry K7 (``ops.swin_block.fused_ln_mlp``)
runs, called without the per-sample multiplier. The backward
differentiates the plain version on the saved inputs, as ``_bwd`` does
with the XLA equivalent.

A tensor on the CPU goes through the plain version; a CUDA tensor launches
the kernel or raises.
"""

from __future__ import annotations

import torch

from lrce_tpu_torch.ops.swin_block import ln_mlp_forward, ln_mlp_plain


def fused_mlp_plain(x, ln_scale, ln_bias, w1, b1, w2, b2,
                    ln_eps: float = 1e-5) -> torch.Tensor:
    """Plain version of K8, with ``_kernel``'s rounding points: K7's plain
    version without dp2."""
    return ln_mlp_plain(x, ln_scale, ln_bias, w1, b1, w2, b2, None, ln_eps)


class _FusedMlpFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ln_scale, ln_bias, w1, b1, w2, b2, ln_eps):
        ctx.save_for_backward(x, ln_scale, ln_bias, w1, b1, w2, b2)
        ctx.ln_eps = ln_eps
        return ln_mlp_forward(fused_mlp, x, ln_scale, ln_bias, w1, b1, w2,
                              b2, None, ln_eps)

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
    and biases f32. On CUDA: x, w1, w2 bf16 and contiguous. Differentiable
    through the plain version; with grad mode off the kernel runs without
    the autograd.Function."""
    if not torch.is_grad_enabled():
        return ln_mlp_forward(fused_mlp, x, ln_scale, ln_bias, w1, b1, w2, b2,
                              None, ln_eps)
    return _FusedMlpFn.apply(x, ln_scale, ln_bias, w1, b1, w2, b2, ln_eps)


fused_mlp.launches = 0
