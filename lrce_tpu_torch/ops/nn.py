"""Plain tensor primitives and the small modules built on them.

Counterpart of ``lrce_tpu/ops/nn.py`` with the same numerics:
  - weights use PyTorch's ``nn.Linear`` layout (out, in), so a module's
    ``state_dict`` is a reference checkpoint;
  - a matrix product runs in the activation dtype and its bias is added in
    f32 before the one cast back (on the CPU in f32 this is exactly the JAX
    ``dense``; in bf16 on the GPU the product is rounded once more, before
    the bias);
  - LayerNorm and softmax compute in f32 whatever the activation dtype;
  - GELU is the exact erf form, in f32;
  - ``mha`` has ``torch.nn.MultiheadAttention`` semantics with a packed
    in-projection, written out so that its rounding points are the JAX ones.

Matrix weights are stored in the model's compute dtype (the JAX package
casts them at each use, which rounds the same way); LayerNorm parameters,
biases and embeddings stay f32.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU, computed in f32."""
    xf = x.float()
    return (xf * 0.5 * (1.0 + torch.erf(xf / math.sqrt(2.0)))).to(x.dtype)


def dense(x: torch.Tensor, weight: torch.Tensor,
          bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x @ weight.T (+ bias in f32), result in x's dtype; weight is (out, in)."""
    y = torch.matmul(x, weight.to(x.dtype).t())
    if bias is None:
        return y
    return (y.float() + bias.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """LayerNorm over the last axis in f32, result in x's dtype. eps is the
    model's own: 1e-5 in Swin, 1e-12 in BERT and the fusion."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    d = xf - mean
    var = (d * d).mean(-1, keepdim=True)
    y = d * torch.rsqrt(var + eps)
    return (y * weight.float() + bias.float()).to(x.dtype)


def dropout(x: torch.Tensor, rate: float, training: bool,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Inverted dropout; the identity in eval or at rate 0."""
    if not training or rate == 0.0:
        return x
    keep = 1.0 - rate
    draw = torch.rand(x.shape, generator=generator, device=x.device)
    return torch.where(draw < keep, x / keep, torch.zeros_like(x))


def _split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    b, s, d = x.shape
    return x.reshape(b, s, num_heads, d // num_heads).transpose(1, 2)


def mha(query: torch.Tensor, key: torch.Tensor, value: torch.Tensor,
        in_proj_weight: torch.Tensor, in_proj_bias: torch.Tensor,
        out_weight: torch.Tensor, out_bias: torch.Tensor, num_heads: int,
        mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Batch-first multi-head attention (B, S, D).

    in_proj_weight: (3D, D) packed [q; k; v] rows, as in
    torch.nn.MultiheadAttention. mask: additive, broadcastable to
    (B, H, Sq, Sk), or a boolean (B, Sk) key mask (True = keep).
    """
    dim = query.shape[-1]
    hd = dim // num_heads
    w = in_proj_weight
    q = _split_heads(dense(query, w[:dim], in_proj_bias[:dim]), num_heads)
    k = _split_heads(dense(key, w[dim:2 * dim], in_proj_bias[dim:2 * dim]),
                     num_heads)
    v = _split_heads(dense(value, w[2 * dim:], in_proj_bias[2 * dim:]),
                     num_heads)
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
    logits = logits * (1.0 / math.sqrt(hd))
    if mask is not None:
        if mask.dtype == torch.bool:
            neg = torch.finfo(torch.float32).min
            logits = logits.masked_fill(~mask[:, None, None, :], neg)
        else:
            logits = logits + mask.float()
    weights = torch.softmax(logits, dim=-1)
    ctx = torch.matmul(weights.to(q.dtype).float(), v.float()).to(q.dtype)
    b, h, s, _ = ctx.shape
    ctx = ctx.transpose(1, 2).reshape(b, s, h * hd)
    return dense(ctx, out_weight, out_bias)


# ---------------------------------------------------------------------------
# Modules with reference parameter names
# ---------------------------------------------------------------------------

def trunc_normal(shape, std: float, generator: torch.Generator) -> torch.Tensor:
    """N(0, std^2) folded into [-2 std, 2 std] (timm's trunc_normal_ range)."""
    return torch.fmod(torch.randn(shape, generator=generator), 2.0) * std


def uniform(shape, bound: float, generator: torch.Generator) -> torch.Tensor:
    return (torch.rand(shape, generator=generator) * 2.0 - 1.0) * bound


class Linear(nn.Module):
    """``weight`` (out, in) in the compute dtype, ``bias`` f32.

    init: "torch_linear" (kaiming-uniform, like nn.Linear) or
    "trunc_normal" (std 0.02, zero bias), as lrce_tpu's dense_init."""

    def __init__(self, in_dim: int, out_dim: int, *, bias: bool = True,
                 dtype=torch.float32, init: str = "torch_linear",
                 generator: torch.Generator):
        super().__init__()
        if init == "torch_linear":
            bound = 1.0 / math.sqrt(in_dim)
            w = uniform((out_dim, in_dim), bound, generator)
            b = uniform((out_dim,), bound, generator)
        elif init == "trunc_normal":
            w = trunc_normal((out_dim, in_dim), 0.02, generator)
            b = torch.zeros(out_dim)
        else:
            raise ValueError(init)
        self.weight = nn.Parameter(w.to(dtype))
        self.bias = nn.Parameter(b) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense(x, self.weight, self.bias)


class LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.eps)


class MultiheadAttention(nn.Module):
    """torch.nn.MultiheadAttention's parameter names (in_proj_weight,
    in_proj_bias, out_proj), xavier-uniform in-projection, zero biases."""

    def __init__(self, dim: int, num_heads: int, *, dtype=torch.float32,
                 generator: torch.Generator):
        super().__init__()
        self.num_heads = num_heads
        bound = math.sqrt(6.0 / (3 * dim + dim))
        self.in_proj_weight = nn.Parameter(
            uniform((3 * dim, dim), bound, generator).to(dtype))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.out_proj = Linear(dim, dim, dtype=dtype, generator=generator)
        nn.init.zeros_(self.out_proj.bias)

    def forward(self, query, key, value, mask=None):
        return mha(query, key, value, self.in_proj_weight, self.in_proj_bias,
                   self.out_proj.weight, self.out_proj.bias, self.num_heads,
                   mask=mask)
