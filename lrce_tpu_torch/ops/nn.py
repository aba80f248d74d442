"""Plain tensor primitives and the small modules built on them.

Counterpart of ``lrce_tpu/ops/nn.py`` with the same numerics:
  - weights use PyTorch's ``nn.Linear`` layout (out, in), so a module's
    ``state_dict`` is a reference checkpoint;
  - a matrix product accumulates in f32, its bias is added in f32 and the
    sum is rounded once to the activation dtype, as the JAX ``dense``
    (``preferred_element_type=f32``) does;
  - LayerNorm and softmax compute in f32 whatever the activation dtype;
  - GELU is the exact erf form, in f32;
  - ``mha`` has ``torch.nn.MultiheadAttention`` semantics with a packed
    in-projection, written out so that its rounding points are the JAX ones.

Matrix weights are stored in the model's parameter dtype and cast to the
activation dtype at each use, as the JAX package does; LayerNorm
parameters, biases and embeddings stay f32.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn


# XLA's f32 erf, the rational approximation the reference kernels compute
# (``_erf_f32`` of lrce_tpu/ops/pallas_mlp.py): the port's own copy of the
# coefficients, which the CUDA kernels' GELU (``erf_xla`` in
# csrc/swin_common.cuh) also holds. P in x^2 from the highest power down,
# then Q.
ERF_ALPHA = (-2.72614225801306e-10, 2.77068142495902e-08,
             -2.10102402082508e-06, -5.69250639462346e-05,
             -7.34990630326855e-04, -2.95459980854025e-03,
             -1.60960333262415e-02)
ERF_BETA = (-1.45660718464996e-05, -2.13374055278905e-04,
            -1.68282697438203e-03, -7.37332916720468e-03,
            -1.42647390514189e-02)


def erf_rational(x: torch.Tensor) -> torch.Tensor:
    """erf in f32 as the CUDA kernels compute it: x clamped to [-4, 4], x
    P(x^2) / Q(x^2), clamped to [-1, 1] (the kernels fuse each step of the
    polynomials into one FMA and divide approximately)."""
    x = x.float().clamp(-4.0, 4.0)
    x2 = x * x
    p = torch.full_like(x, ERF_ALPHA[0])
    for a in ERF_ALPHA[1:]:
        p = p * x2 + a
    q = torch.full_like(x, ERF_BETA[0])
    for b in ERF_BETA[1:]:
        q = q * x2 + b
    return (x * p / q).clamp(-1.0, 1.0)


def _gelu_f32(x: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    return (xf * 0.5 * (1.0 + torch.erf(xf / math.sqrt(2.0)))).to(x.dtype)


class _GeluSavingInput(torch.autograd.Function):
    """``gelu`` of a bf16 x that needs a gradient: the same forward, but the
    backward keeps x itself (2 bytes an element) where autograd through the
    f32 ops keeps three f32 intermediates (12 bytes), and computes
    g (Phi(x) + x phi(x)) in f32, rounded once to x's dtype. The plain MLP
    of Video Swin-L's stages 2-3 (FF = 3072 / 6144 over 1,728 / 432 tokens
    a clip) kept most of a training step's activations in them."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return _gelu_f32(x)

    @staticmethod
    def backward(ctx, g):
        x, = ctx.saved_tensors
        xf = x.float()
        cdf = 0.5 * (1.0 + torch.erf(xf / math.sqrt(2.0)))
        pdf = torch.exp(-0.5 * xf * xf) / math.sqrt(2.0 * math.pi)
        return (g.float() * (cdf + xf * pdf)).to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU, computed in f32; a narrower x that needs a gradient
    saves only itself for the backward (``_GeluSavingInput``)."""
    if (x.dtype != torch.float32 and torch.is_grad_enabled()
            and x.requires_grad):
        return _GeluSavingInput.apply(x)
    return _gelu_f32(x)


class _MatmulF32(torch.autograd.Function):
    """x2 (M, K) @ w (N, K).T -> (M, N) f32 for bf16 CUDA operands:
    ``torch.mm(..., out_dtype=torch.float32)`` (``aten::mm.dtype``), which
    has no derivative of its own. The backward keeps the f32 cotangent
    unrounded, multiplies it with the upcast operands in f32 and rounds dx
    and dw once to the operands' dtype, as JAX's transpose of a dot with
    ``preferred_element_type=f32`` does."""

    @staticmethod
    def forward(ctx, x2, w):
        ctx.save_for_backward(x2, w)
        return torch.mm(x2, w.t(), out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x2, w = ctx.saved_tensors
        g = g.float()
        return (torch.mm(g, w.float()).to(x2.dtype),
                torch.mm(g.t(), x2.float()).to(w.dtype))


def matmul_f32(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """x @ weight.T accumulated and returned in f32, the product unrounded.

    bf16 on CUDA: ``aten::mm.dtype``, through ``_MatmulF32`` when a
    gradient is wanted; bf16 on the CPU, where ``aten::mm.dtype`` has no
    kernel: the bf16 values upcast, whose products f32 holds exactly. f32:
    a plain matmul."""
    w = weight.to(x.dtype)
    if x.dtype == torch.float32:
        return torch.matmul(x, w.t())
    x2 = x.reshape(-1, x.shape[-1])
    if not x.is_cuda:
        y = torch.mm(x2.float(), w.float().t())
    elif torch.is_grad_enabled() and (x2.requires_grad or w.requires_grad):
        y = _MatmulF32.apply(x2, w)
    else:
        y = torch.mm(x2, w.t(), out_dtype=torch.float32)
    return y.reshape(*x.shape[:-1], w.shape[0])


def dense(x: torch.Tensor, weight: torch.Tensor,
          bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x @ weight.T (+ bias) in f32, rounded once to x's dtype; weight is
    (out, in)."""
    y = matmul_f32(x, weight)
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


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


def layer_norm_input_bwd(x: torch.Tensor, dy: torch.Tensor,
                         weight: torch.Tensor, eps: float):
    """Backward of ``layer_norm`` in f32, as the JAX kernels' VJPs run it
    outside the Pallas call: (dx f32, dweight f32, dbias f32) for the
    cotangent dy of the normalized output."""
    xf = x.float()
    dyf = dy.float()
    mean = xf.mean(-1, keepdim=True)
    d = xf - mean
    inv = torch.rsqrt((d * d).mean(-1, keepdim=True) + eps)
    xn = d * inv
    dims = tuple(range(x.ndim - 1))
    dweight = (dyf * xn).sum(dims)
    dbias = dyf.sum(dims)
    dxn = dyf * weight.float()
    dx = inv * (dxn - dxn.mean(-1, keepdim=True)
                - xn * (dxn * xn).mean(-1, keepdim=True))
    return dx, dweight, dbias


def _split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    b, s, d = x.shape
    return x.reshape(b, s, num_heads, d // num_heads).transpose(1, 2)


def mha(query: torch.Tensor, key: torch.Tensor, value: torch.Tensor,
        in_proj_weight: torch.Tensor, in_proj_bias: torch.Tensor,
        out_weight: torch.Tensor, out_bias: torch.Tensor, num_heads: int,
        mask: Optional[torch.Tensor] = None, dropout_rate: float = 0.0,
        training: bool = False,
        generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Batch-first multi-head attention (B, S, D): ``mha_heads`` and the
    output projection (out_weight (D, D), out_bias (D,)).

    in_proj_weight: (3D, D) packed [q; k; v] rows, as in
    torch.nn.MultiheadAttention. mask: additive, broadcastable to
    (B, H, Sq, Sk), or a boolean (B, Sk) key mask (True = keep). In
    training the f32 attention weights take dropout, as in the JAX ``mha``.
    """
    return dense(mha_heads(query, key, value, in_proj_weight, in_proj_bias,
                           num_heads, mask, dropout_rate, training,
                           generator), out_weight, out_bias)


def mha_heads(query: torch.Tensor, key: torch.Tensor, value: torch.Tensor,
              in_proj_weight: torch.Tensor, in_proj_bias: torch.Tensor,
              num_heads: int, mask: Optional[torch.Tensor] = None,
              dropout_rate: float = 0.0, training: bool = False,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """``mha`` up to the output projection: the ``num_heads`` heads of
    ``in_proj_weight`` ((3 D', D) packed rows) side by side, (B, Sq, D')."""
    dim = in_proj_weight.shape[0] // 3
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
    weights = dropout(torch.softmax(logits, dim=-1), dropout_rate, training,
                      generator)
    ctx = torch.matmul(weights.to(q.dtype).float(), v.float()).to(q.dtype)
    b, h, s, _ = ctx.shape
    return ctx.transpose(1, 2).reshape(b, s, h * hd)


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

    def forward(self, query, key, value, mask=None, dropout_rate=0.0,
                training=False, generator=None):
        return self.out_proj(mha_heads(query, key, value, self.in_proj_weight,
                                       self.in_proj_bias, self.num_heads,
                                       mask, dropout_rate, training,
                                       generator))
