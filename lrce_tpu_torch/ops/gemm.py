"""The two GEMMs and the LayerNorm that every Swin kernel of the port shares,
on their own.

``gemm_bf16`` is ``launch_gemm`` of ``csrc/swin_common.cu``: a bf16 product
with f32 accumulation and one of four epilogues applied before the single
rounding to bf16. ``gemm_tn`` is ``launch_gemm_tn``: the weight-gradient
product ``g^T . a`` in f32, split over the rows into partials that are
summed in a fixed order. ``ln_rows`` is ``launch_ln``: LayerNorm over C in
f32, rounded to bf16, its rows in token order (a block's LN2) or gathered
into window order under the block's cyclic shift (its LN1). K1-K8 call all
three from C; these wrappers exist so that tests and ``chip_smoke.py`` can
hold each against its plain version and time it at the shapes the kernels
give it. On CPU tensors they compute the plain versions.
"""

from __future__ import annotations

from typing import Optional

import torch

from lrce_tpu_torch.ops import cuda_lib
from lrce_tpu_torch.ops.nn import gelu, layer_norm
from lrce_tpu_torch.ops.window_attn import (NO_SHIFT, Shift, Window,
                                            check_kernel_args, check_shift,
                                            expect_shape, roll_shift, sm_count,
                                            splitk_splits, window_partition)

# EpiMode of csrc/swin_common.cuh
EPI_BIAS, EPI_BIAS_GELU, EPI_ATTN_OUT, EPI_MLP_OUT = 0, 1, 2, 3
EPI_MODES = (EPI_BIAS, EPI_BIAS_GELU, EPI_ATTN_OUT, EPI_MLP_OUT)


def _rows(dp: torch.Tensor, dp_rows: int, m: int) -> torch.Tensor:
    return dp.float().repeat_interleave(dp_rows)[:m, None]


def gemm_bf16_plain(a, b, mode: int = EPI_BIAS, bias=None, dp=None,
                    dp_rows: int = 1, res=None, b_kn: bool = False):
    """Plain version of ``gemm_bf16``: the product in f32, the epilogue's
    rounding points as the kernel's."""
    acc = a.float() @ (b.float() if b_kn else b.float().t())
    if bias is not None:
        acc = acc + bias.float()
    if mode == EPI_BIAS:
        return acc.to(a.dtype)
    if mode == EPI_BIAS_GELU:
        return gelu(acc).to(a.dtype)
    if dp is not None:
        acc = acc * _rows(dp, dp_rows, a.shape[0])
    if mode == EPI_ATTN_OUT:
        out = acc.to(a.dtype)
        return out if res is None else (out.float() + res.float()).to(a.dtype)
    if mode == EPI_MLP_OUT:
        return (res.float() + acc).to(a.dtype)
    raise ValueError(f"gemm_bf16: unknown epilogue mode {mode}")


def gemm_bf16(a: torch.Tensor, b: torch.Tensor, mode: int = EPI_BIAS,
              bias: Optional[torch.Tensor] = None,
              dp: Optional[torch.Tensor] = None, dp_rows: int = 1,
              res: Optional[torch.Tensor] = None,
              b_kn: bool = False) -> torch.Tensor:
    """out (M, N) = epilogue(a (M, K) . b^T) with b (N, K), or with ``b_kn``
    (mode ``EPI_ATTN_OUT`` only) epilogue(a . b) with b (K, N).

    Modes: ``EPI_BIAS`` bf16(acc + bias); ``EPI_BIAS_GELU`` bf16(gelu(acc +
    bias)); ``EPI_ATTN_OUT`` bf16(res + bf16((acc + bias) * dp));
    ``EPI_MLP_OUT`` bf16(res + (acc + bias) * dp). dp: f32 multipliers, one
    per ``dp_rows`` rows. On CUDA: a, b, res bf16 and contiguous, bias and
    dp f32, K and N multiples of 8.
    """
    if a.device.type == "cpu":
        return gemm_bf16_plain(a, b, mode, bias, dp, dp_rows, res, b_kn)
    name = "gemm_bf16"
    m, k = a.shape
    n = b.shape[1] if b_kn else b.shape[0]
    if a.device.type != "cuda":
        raise ValueError(f"{name}: takes CPU or CUDA tensors, got {a.device}")
    if tuple(b.shape) != ((k, n) if b_kn else (n, k)):
        raise ValueError(f"{name}: b {tuple(b.shape)} does not fit a "
                         f"{tuple(a.shape)}")
    if mode not in EPI_MODES or (b_kn and mode != EPI_ATTN_OUT) or (
            mode == EPI_MLP_OUT and res is None):
        raise ValueError(f"{name}: mode {mode} with b_kn={b_kn}, "
                         f"res={'given' if res is not None else None}")
    if k % 8 or n % 8:
        raise ValueError(f"{name}: K = {k} and N = {n} must be multiples of 8")
    for t_ in (a, b, res):
        if t_ is not None and (t_.dtype != torch.bfloat16
                               or not t_.is_contiguous()
                               or t_.device != a.device):
            raise TypeError(f"{name}: a, b and res must be contiguous "
                            f"bfloat16 on {a.device}")
    for t_ in (bias, dp):
        if t_ is not None and (t_.dtype != torch.float32
                               or not t_.is_contiguous()
                               or t_.device != a.device):
            raise TypeError(f"{name}: bias and dp must be contiguous float32 "
                            f"on {a.device}")
    if res is not None and tuple(res.shape) != (m, n):
        raise ValueError(f"{name}: res {tuple(res.shape)}, expected {(m, n)}")
    if dp is not None and dp.numel() * dp_rows < m:
        raise ValueError(f"{name}: {dp.numel()} multipliers of {dp_rows} rows "
                         f"do not cover {m} rows")
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)

    def ptr(t_):
        return None if t_ is None else t_.data_ptr()

    rc = cuda_lib.library().lib.lrce_gemm(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k, mode, int(b_kn),
        ptr(bias), ptr(dp), dp_rows, ptr(res),
        cuda_lib.stream(a))
    cuda_lib.check(name, rc)
    gemm_bf16.launches += 1
    return out


gemm_bf16.launches = 0


def gemm_tn_plain(g: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """Plain version of ``gemm_tn``: g^T . a in f32."""
    return g.float().t() @ a.float()


def gemm_tn(g: torch.Tensor, a: torch.Tensor,
            splits: Optional[int] = None) -> torch.Tensor:
    """out (N, K) f32 = g^T . a for g (M, N) and a (M, K): the reduction
    runs over the rows, split into ``splits`` chunks (``splitk_splits`` by
    default) whose f32 partials are summed in a fixed order. On CUDA: bf16,
    contiguous, N and K multiples of 8."""
    if g.device.type == "cpu":
        return gemm_tn_plain(g, a)
    name = "gemm_tn"
    m, n = g.shape
    k = a.shape[1]
    if g.device.type != "cuda":
        raise ValueError(f"{name}: takes CPU or CUDA tensors, got {g.device}")
    if a.shape[0] != m or n % 8 or k % 8:
        raise ValueError(f"{name}: g {tuple(g.shape)}, a {tuple(a.shape)}; "
                         "equal row counts, N and K multiples of 8")
    for t_ in (g, a):
        if (t_.dtype != torch.bfloat16 or not t_.is_contiguous()
                or t_.device != g.device):
            raise TypeError(f"{name}: g and a must be contiguous bfloat16 on "
                            f"{g.device}")
    if splits is None:
        splits = splitk_splits(m, n, k, sm_count(g))
    out = torch.empty((n, k), dtype=torch.float32, device=g.device)
    ws = torch.empty((splits, n * k), dtype=torch.float32, device=g.device)
    rc = cuda_lib.library().lib.lrce_gemm_tn(
        g.data_ptr(), a.data_ptr(), out.data_ptr(), m, n, k, splits,
        ws.data_ptr(), cuda_lib.stream(g))
    cuda_lib.check(name, rc)
    gemm_tn.launches += 1
    return out


gemm_tn.launches = 0


def ln_rows_plain(x, gamma, beta, window: Window = (1, 1, 1),
                  shift: Shift = NO_SHIFT, eps: float = 1e-5,
                  gather: bool = False) -> torch.Tensor:
    """Plain version of ``ln_rows``."""
    y = layer_norm(x, gamma, beta, eps)
    if gather:
        y = window_partition(roll_shift(y, shift, -1), window)
    return y.reshape(-1, x.shape[-1])


def ln_rows(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
            window: Window = (1, 1, 1), shift: Shift = NO_SHIFT,
            eps: float = 1e-5, gather: bool = False) -> torch.Tensor:
    """(T, C) = LayerNorm over C of x (B, D, H, W, C), f32 math, rounded to
    x's dtype. ``gather``: the rows in window order (``window_partition`` of
    x rolled by -shift), as a block's LN1 leaves them; else token order, as
    its LN2. On CUDA: x bf16 and contiguous, gamma and beta f32, C a
    multiple of 32 up to 1024."""
    if x.device.type == "cpu":
        return ln_rows_plain(x, gamma, beta, window, shift, eps, gather)
    name = "ln_rows"
    check_kernel_args(name, x, window, 1, (), (gamma, beta))
    b, d, h, w, c = x.shape
    expect_shape(name, gamma, (c,))
    expect_shape(name, beta, (c,))
    check_shift(name, x, shift)
    out = torch.empty((b * d * h * w, c), dtype=x.dtype, device=x.device)
    rc = cuda_lib.library().lib.lrce_ln_rows(
        x.data_ptr(), out.data_ptr(), b, d, h, w, c, *window, *shift, eps,
        gamma.data_ptr(), beta.data_ptr(), int(gather),
        cuda_lib.stream(x))
    cuda_lib.check(name, rc)
    ln_rows.launches += 1
    return out


ln_rows.launches = 0
