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
  exist on the TPU only to fit VMEM and do not come across. Windows of up to
  160 tokens take one CTA per (window group, head); windows of 161-448
  tokens (Swin-B's 16-frame window (8, 7, 7), N = 392; Swin-L's (3, 12, 12)
  at 5 frames, N = 432) a rows / columns pair of CTAs per (window group,
  head, 80-row block).

- ``window_attention_core`` is the attention CTA that K6, K2, K1 and K3
  share (``csrc/attn_fwd.cu``), on its own: packed qkv, rel_bias and mask in,
  ctx out. ``window_attention_core_plain`` is the statement of it, and the
  plain versions of K6 / K2 / K1 / K3 go through that.

K6 and K2 are ``torch.autograd.Function``s whose backward is K4 followed by
the f32 LN1 input backward, as ``_bwd`` / ``_hsplit_bwd`` are.

A tensor on the CPU goes through the plain PyTorch versions in this module,
which have the kernels' rounding points; a CUDA tensor launches the kernel
or raises. Nothing falls back.
"""

from __future__ import annotations

import collections
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
    """logits (nb, nH, N, N) + rel_bias (nH, N, N) [+ mask (..., N, N), one
    per window of a clip, windows in partition order]."""
    nb, _, n, _ = logits.shape
    if mask is None:
        return logits + rel_bias[None]
    mask = mask.reshape(-1, n, n)
    nw = mask.shape[0]
    add = rel_bias[None, None] + mask[None, :, None]
    return (logits.reshape(nb // nw, nw, num_heads, n, n)
            + add).reshape(nb, num_heads, n, n)


def _softmax_f32(logits):
    """Exact f32 softmax with the kernels' reciprocal multiply."""
    e = torch.exp(logits - logits.amax(-1, keepdim=True))
    return e * (1.0 / e.sum(-1, keepdim=True))


def _split_heads(qkv, num_heads):
    """Packed (nb, N, 3C) qkv -> q, k, v (nb, nH, N, hd), q scaled on its
    value in the activation dtype."""
    nb, n, c3 = qkv.shape
    hd = c3 // 3 // num_heads
    qkv = qkv.reshape(nb, n, 3, num_heads, hd)
    qkv = qkv.permute(2, 0, 3, 1, 4)                     # (3, nb, nH, N, hd)
    q = (qkv[0].float() * (1.0 / math.sqrt(hd))).to(qkv.dtype)
    return q, qkv[1], qkv[2]


def _qkv_heads(win, qkv_w, qkv_b, num_heads):
    """qkv + bias rounded to the activation dtype, q scaled on that value:
    three (nb, nH, N, hd) tensors."""
    return _split_heads(dense(win, qkv_w, qkv_b), num_heads)


def _merge_heads(t):
    """(nb, nH, N, hd) -> (nb, N, nH * hd)."""
    nb, nh, n, hd = t.shape
    return t.transpose(1, 2).reshape(nb, n, nh * hd)


def window_attention_core_plain(qkv: torch.Tensor, rel_bias: torch.Tensor,
                                mask: Optional[torch.Tensor],
                                num_heads: int) -> torch.Tensor:
    """Plain version of ``window_attention_core``, the statement of the
    attention CTA: q scaled on its value in qkv's dtype, logits + rel_bias
    (+ the window's mask) and an exact softmax in f32, the weights rounded
    to qkv's dtype before P.V, ctx summed in f32 and rounded once.

    qkv: (windows, N, 3C), ``[q | k | v]`` with head h at columns h * hd;
    rel_bias: (nH, N, N) f32; mask: (..., N, N) additive, one per window of
    a clip in partition order, or None. Returns ctx (windows, N, C)."""
    dt = qkv.dtype
    q, k, v = _split_heads(qkv, num_heads)
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
    weights = _softmax_f32(_logits_add(logits, rel_bias, mask, num_heads))
    ctx = torch.matmul(weights.to(dt).float(), v.float()).to(dt)
    return _merge_heads(ctx)


def attention_proj_f32(win: torch.Tensor, qkv_w, qkv_b, proj_w, proj_b,
                       rel_bias: torch.Tensor, mask: Optional[torch.Tensor],
                       num_heads: int) -> torch.Tensor:
    """Window attention and proj at the kernels' rounding points.

    win: (B*nW, N, C) normalized tokens; rel_bias: (nH, N, N) f32; mask:
    (nd, nh, nw, N, N) additive or None. Returns proj + bias in f32:
    qkv + bias rounds to the activation dtype, the attention is
    ``window_attention_core_plain``, ctx rounds.
    """
    ctx = window_attention_core_plain(dense(win, qkv_w, qkv_b), rel_bias,
                                      mask, num_heads)
    return matmul_f32(ctx, proj_w) + proj_b.float()


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
    if not kernel_width_supported(c, num_heads):
        raise ValueError(f"{name}: C = {c} with {num_heads} heads; the kernel "
                         f"takes C % 32 == 0, C <= {KERNEL_MAX_C}, "
                         "head_dim % 16 == 0")


KERNEL_MAX_C = 1536     # the LayerNorm CTA's widest row (csrc/swin_common.cu)


def kernel_width_supported(c: int, num_heads: int) -> bool:
    """Whether the Swin kernels take C channels in ``num_heads`` heads:
    C a multiple of 32 up to 1536 (Video Swin-L's last stage), head_dim a
    multiple of 16. ``check_kernel_args`` and the Swin stage's choice of
    route read this one rule."""
    return (c % num_heads == 0 and (c // num_heads) % 16 == 0
            and c % 32 == 0 and c <= KERNEL_MAX_C)


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
    return cuda_lib.stream(x)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def shift_mask_labels(mask: torch.Tensor):
    """The label form of an additive window mask, for the attention CTA.

    A shift mask adds 0 where two tokens of a window carry the same region
    label and one value v (-100) where they differ. mask: (..., N, N), one
    per window of a clip. Returns (labels, off): labels (windows, ceil16(N))
    int32, a token's label being the first token of its row that it may
    attend to (padding 0); off (windows,) f32, window w's v (0 for an
    all-zero window), or NaN where the labels and one value do not
    reproduce w's mask exactly: the kernel then reads that window's mask as
    it lies. Runs on the mask's device and does not synchronise."""
    n = mask.shape[-1]
    m = mask.reshape(-1, n, n)
    labels = (m == 0).float().argmax(-1)              # the first zero
    lo, hi = m.amin((-2, -1)), m.amax((-2, -1))
    v = torch.where(lo != 0, lo, hi)
    ok = (shift_mask_from_labels(labels, v) == m).flatten(1).all(-1)
    off = torch.where(ok, v, torch.full_like(v, float("nan")))
    pad = -n % 16
    labels = torch.nn.functional.pad(labels.to(torch.int32), (0, pad))
    return labels.contiguous(), off.contiguous()


def shift_mask_from_labels(labels: torch.Tensor,
                           off: torch.Tensor) -> torch.Tensor:
    """What the attention CTA adds for labels (windows, N) and off
    (windows,): off[w] where two tokens' labels differ, else 0."""
    same = labels[:, :, None] == labels[:, None, :]
    return torch.where(same, torch.zeros_like(off)[:, None, None],
                       off[:, None, None])


_MASK_LABELS = collections.OrderedDict()   # see mask_label_args
_MASK_LABELS_KEPT = 16


def mask_label_args(mask: Optional[torch.Tensor]):
    """(labels, off) of ``shift_mask_labels`` for a kernel call, made once
    per mask: the model hands every shifted block of a stage the same mask.
    An entry holds its mask, so the memory behind the key cannot be given to
    another tensor while the entry lives; an in-place write changes the
    key's version."""
    if mask is None:
        return None, None
    if mask.is_inference():
        return shift_mask_labels(mask)
    key = (mask.data_ptr(), mask._version, tuple(mask.shape), mask.device)
    hit = _MASK_LABELS.get(key)
    if hit is None:
        hit = _MASK_LABELS[key] = (mask, *shift_mask_labels(mask))
        if len(_MASK_LABELS) > _MASK_LABELS_KEPT:
            _MASK_LABELS.popitem(last=False)
    return hit[1], hit[2]


def attn_fwd_groups(nwin_total: int, num_heads: int, sms: int) -> int:
    """Window groups of ``attn_fwd_kernel``'s grid (windows of at most 160
    tokens): each CTA (group, head) reads its head's rel_bias once and walks
    its windows. The CTA fills an SM (ten warps, ~165 KB of shared memory),
    so the grid is sized as K4's: about one CTA per SM of ``sms``, never
    more groups than windows."""
    return attn_bwd_groups(nwin_total, num_heads, sms)


ATTN_MAX_TOKENS = 448        # the widest window of every attention kernel
ATTN_FWD_SMALL_TOKENS = 160  # attn_fwd_kernel: twenty 8-key blocks at most
ATTN_FWD_BLOCK_ROWS = 80     # query rows of one attn_fwd_big_kernel CTA
ATTN_FWD_WIDE_TOKENS = 400   # past it, CTAs of ATTN_FWD_WIDE_BLOCK_ROWS rows
ATTN_FWD_WIDE_BLOCK_ROWS = 64
ATTN_FWD_KEY_SPLITS = 2      # its warp sets, one per half of the keys
ATTN_FWD_CTAS = ("attn_fwd_kernel", "attn_fwd_big_kernel")
SMEM_PER_CTA = 227 * 1024    # dynamic shared memory a CTA may take (kMaxSmem)


def _padded(n: int) -> int:
    return -(-n // 16) * 16


def attn_supported(n: int, head_dim: int) -> bool:
    """Whether the window-attention kernels take windows of n tokens at
    this head_dim: head_dim 16 or 32 and at most 448 tokens (a multiple of
    16, so padding does not change the answer). The forward CTAs
    (``attn_fwd_cta``) and K4 take the same shapes. Every kernel wrapper
    (``check_attn_shape``) and the Swin stage's choice of route read this
    one rule; Video Swin's unclamped (8, 12, 12) window (N = 1152) and a
    head_dim of 48 or 64 take the plain block."""
    return n <= ATTN_MAX_TOKENS and head_dim in (16, 32)


def check_attn_shape(name: str, n: int, head_dim: int) -> None:
    """Raise before any launch where ``attn_supported`` says no."""
    if not attn_supported(n, head_dim):
        raise ValueError(f"{name}: takes windows of at most "
                         f"{ATTN_MAX_TOKENS} tokens and head_dim 16 or 32, "
                         f"got {n} and {head_dim}")


def attn_fwd_cta(n: int, head_dim: int) -> Optional[str]:
    """The CTA that ``launch_attn`` (``csrc/attn_fwd.cu``) gives windows of
    n tokens at this head_dim: ``attn_fwd_kernel`` up to 160 tokens (padded
    to 16), ``attn_fwd_big_kernel`` for 161-448; None for a shape that
    ``attn_supported`` refuses."""
    if not attn_supported(n, head_dim):
        return None
    if _padded(n) <= ATTN_FWD_SMALL_TOKENS:
        return "attn_fwd_kernel"
    return "attn_fwd_big_kernel"


def attn_fwd_block_rows(n: int) -> int:
    """Query rows of one ``attn_fwd_big_kernel`` CTA (``big_fwd_rows``):
    80 up to 400 padded tokens, 64 beyond, where 80 bias rows do not fit."""
    return (ATTN_FWD_BLOCK_ROWS if _padded(n) <= ATTN_FWD_WIDE_TOKENS
            else ATTN_FWD_WIDE_BLOCK_ROWS)


def attn_fwd_blocks(n: int) -> int:
    """Query blocks of ``attn_fwd_big_kernel``'s grid: blocks of
    ``attn_fwd_block_rows`` rows of the window padded to 16 rows."""
    return -(-_padded(n) // attn_fwd_block_rows(n))


def attn_fwd_big_smem_bytes(n: int, head_dim: int) -> int:
    """Shared memory of one ``attn_fwd_big_kernel`` CTA (``big_fwd_smem_
    bytes`` in ``csrc/attn_fwd.cu``): its bias rows in f32, k twice and v
    once, q of its rows, the labels twice, the two halves' (max, sum) and
    the upper half's f32 ctx."""
    npad = _padded(n)
    rows = attn_fwd_block_rows(n)
    return (rows * npad * 4 + 3 * npad * head_dim * 2 + rows * head_dim * 2
            + 2 * npad * 4 + ATTN_FWD_KEY_SPLITS * rows * 8
            + rows * head_dim * 4)


@functools.lru_cache(maxsize=256)
def attn_fwd_big_groups(nwin_total: int, num_heads: int, sms: int,
                        blocks: int) -> int:
    """Window groups of ``attn_fwd_big_kernel``'s grid (groups x heads x
    ``blocks`` query blocks). Its CTA takes an SM (~220 KB of shared
    memory), fills its 80 bias rows once and then walks its windows, so
    the call lasts about (waves of the grid) x (windows a CTA + one for the
    bias fill); the groups that make that least, fewest on a tie, never
    more than windows."""
    per = num_heads * blocks
    best, best_cost = 1, None
    for groups in range(1, min(nwin_total, 8 * sms) + 1):
        cost = -(-groups * per // sms) * (-(-nwin_total // groups) + 1)
        if best_cost is None or cost < best_cost:
            best, best_cost = groups, cost
    return best


def attn_fwd_launch_groups(nwin_total: int, n: int, head_dim: int,
                           num_heads: int, sms: int) -> int:
    """The ``groups`` argument of a forward attention launch: the grid of
    the CTA that ``attn_fwd_cta`` names."""
    if attn_fwd_cta(n, head_dim) == "attn_fwd_big_kernel":
        return attn_fwd_big_groups(nwin_total, num_heads, sms,
                                   attn_fwd_blocks(n))
    return attn_fwd_groups(nwin_total, num_heads, sms)


def attn_fwd_cta_launches(reset: bool = False) -> dict:
    """Launches of each forward attention CTA made by the CUDA library since
    the last reset (``lrce_attn_fwd_counts``), by name; ``reset`` zeroes
    them. Needs the built library, so the card's machine."""
    import ctypes

    out = (ctypes.c_longlong * len(ATTN_FWD_CTAS))()
    cuda_lib.check("lrce_attn_fwd_counts",
                   cuda_lib.library().lib.lrce_attn_fwd_counts(
                       ctypes.addressof(out), int(reset)))
    return dict(zip(ATTN_FWD_CTAS, out))


def _check_core_shapes(name, qkv, rel_bias, mask, num_heads):
    if qkv.ndim != 3 or qkv.shape[-1] % (3 * num_heads):
        raise ValueError(f"{name}: qkv must be (windows, N, 3C) with C a "
                         f"multiple of {num_heads} heads, got "
                         f"{tuple(qkv.shape)}")
    n = qkv.shape[1]
    expect_shape(name, rel_bias, (num_heads, n, n))
    if mask is not None:
        nw = mask.numel() // (n * n) if n else 0
        if (mask.ndim < 3 or tuple(mask.shape[-2:]) != (n, n) or nw < 1
                or qkv.shape[0] % nw):
            raise ValueError(f"{name}: mask {tuple(mask.shape)} is not (..., "
                             f"{n}, {n}) with a window count that divides "
                             f"{qkv.shape[0]}")


def window_attention_core(qkv: torch.Tensor, rel_bias: torch.Tensor,
                          mask: Optional[torch.Tensor],
                          num_heads: int) -> torch.Tensor:
    """The attention CTA of K6 / K2 / K1 / K3 alone: ctx = softmax(q k^T +
    rel_bias [+ mask]) v per (window, head); see
    ``window_attention_core_plain`` for the contract.

    qkv: (windows, N, 3C); rel_bias: (nH, N, N) f32; mask: (..., N, N) f32,
    one per window of a clip (windows a multiple of their count), or None.
    Returns ctx (windows, N, C). On CUDA: qkv bf16, everything contiguous,
    head_dim 16 or 32 and N <= 448 (``attn_supported``), which run an
    ``mma.sync`` CTA of ``csrc/attn_fwd.cu`` (``attn_fwd_cta``:
    ``attn_fwd_kernel`` up to 160 tokens, ``attn_fwd_big_kernel``
    beyond)."""
    name = "window_attention_core"
    _check_core_shapes(name, qkv, rel_bias, mask, num_heads)
    if qkv.device.type == "cpu":
        return window_attention_core_plain(qkv, rel_bias, mask, num_heads)
    if qkv.dtype != torch.bfloat16:
        raise TypeError(f"{name}: qkv must be bfloat16, got {qkv.dtype}")
    for t in (rel_bias, mask):
        if t is not None and t.dtype != torch.float32:
            raise TypeError(f"{name}: rel_bias and mask must be float32, got "
                            f"{t.dtype}")
    if qkv.device.type != "cuda":
        raise ValueError(f"{name}: takes CPU or CUDA tensors, got "
                         f"{qkv.device}")
    for t in (qkv, rel_bias, mask):
        if t is not None and (t.device != qkv.device
                              or not t.is_contiguous()):
            raise ValueError(f"{name}: every tensor must be contiguous and on "
                             f"{qkv.device}")
    nwin, n, c3 = qkv.shape
    c = c3 // 3
    check_attn_shape(name, n, c // num_heads)
    nwin_clip = nwin if mask is None else mask.numel() // (n * n)
    labels, off = mask_label_args(mask)
    ctx = torch.empty((nwin, n, c), dtype=qkv.dtype, device=qkv.device)
    rc = cuda_lib.library().lib.lrce_window_attn_core(
        qkv.data_ptr(), ctx.data_ptr(), rel_bias.data_ptr(), _ptr(mask),
        _ptr(labels), _ptr(off), nwin, nwin_clip, n, c, num_heads,
        attn_fwd_launch_groups(nwin, n, c // num_heads, num_heads,
                               sm_count(qkv)), _stream(qkv))
    cuda_lib.check(name, rc)
    window_attention_core.launches += 1
    return ctx


window_attention_core.launches = 0


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
    n = window[0] * window[1] * window[2]
    check_attn_shape(name, n, c // num_heads)
    t = b * d * h * w
    out = torch.empty_like(x)
    ws_tc = torch.empty((t, c), dtype=x.dtype, device=x.device)
    ws_qkv = torch.empty((t, 3 * c), dtype=x.dtype, device=x.device)
    labels, off = mask_label_args(mask)
    rc = cuda_lib.library().lib.lrce_window_attn_fwd(
        x.data_ptr(), out.data_ptr(), b, d, h, w, c, *window, *shift,
        num_heads, ln_eps, ln_scale.data_ptr(), ln_bias.data_ptr(),
        qkv_w.data_ptr(), qkv_b.data_ptr(), proj_w.data_ptr(),
        proj_b.data_ptr(), rel_bias.data_ptr(), _ptr(mask), _ptr(labels),
        _ptr(off), attn_fwd_launch_groups(t // n, n, c // num_heads,
                                          num_heads, sm_count(x)),
        ws_tc.data_ptr(), ws_qkv.data_ptr(), _stream(x))
    cuda_lib.check(name, rc)
    return out


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(x: torch.Tensor) -> int:
    """Streaming multiprocessors of the card that holds the CUDA tensor x."""
    index = x.device.index
    return _sm_count(torch.cuda.current_device() if index is None else index)


ATTN_BWD_SMALL_TOKENS = 160  # attn_bwd_kernel: ten 16-row key blocks at most
ATTN_BWD_BLOCK_ROWS = 80     # query rows / keys of one of the pair's CTAs
ATTN_BWD_PAIR_CTAS = 16      # the pair's CTAs an SM over a call, about


def window_kernels_supported(n: int, c: int, num_heads: int) -> bool:
    """Whether a window-aligned Swin stage of windows of n tokens, C
    channels and ``num_heads`` heads runs on the kernels, forward and
    backward alike: its width (``kernel_width_supported``) and its windows
    (``attn_supported``). The route is chosen by this rule before any
    launch, so that no stage reaches a kernel that refuses it."""
    return (kernel_width_supported(c, num_heads)
            and attn_supported(n, c // num_heads))


def attn_bwd_blocks(n: int) -> int:
    """Row blocks of K4's grid: 1 for attn_bwd_kernel (N padded to 16 at
    most 160), else the pair's 80-row blocks of the padded window."""
    padded = -(-n // 16) * 16
    if padded <= ATTN_BWD_SMALL_TOKENS:
        return 1
    return -(-padded // ATTN_BWD_BLOCK_ROWS)


def attn_bwd_groups(nwin_total: int, num_heads: int, sms: int,
                    blocks: int = 1) -> int:
    """Window groups of K4's grid: each CTA (group, head[, block]) walks its
    windows, keeps its f32 partial of drel and of the qkv-bias gradient on
    chip and writes it once; the partials are summed afterwards in a fixed
    order. attn_bwd_kernel fills an SM (ten warps, ~190 KB of shared
    memory), so with ``blocks`` 1 the grid has about one CTA per SM of
    ``sms`` and never more groups than windows. The pair (``blocks`` row
    blocks) gets about 16 CTAs an SM over the call, at most one group a
    window: its rows CTA (five warps, ~64 KB) runs three to an SM and needs
    that many to fill the card, its columns CTA (~205 KB) one, in waves
    short enough to balance."""
    if blocks == 1:
        return max(1, min(nwin_total, sms // num_heads))
    want = -(-ATTN_BWD_PAIR_CTAS * sms // (num_heads * blocks))
    return max(1, min(nwin_total, want))


SPLITK_TILE = 128           # the weight-gradient GEMM's output tile edge
SPLITK_MIN_ROWS = 256       # rows of the reduction a split is worth


def splitk_splits(m: int, n: int, k: int, sms: int) -> int:
    """Splits of the reduction (m rows) of a weight-gradient GEMM with an
    (n, k) output of 128 x 128 tiles: about two CTAs per SM of ``sms``, at
    least 256 rows each."""
    tiles = -(-n // SPLITK_TILE) * -(-k // SPLITK_TILE)
    return max(1, min(-(-2 * sms // tiles), m // SPLITK_MIN_ROWS))


def attn_bwd_workspace_shapes(t: int, c: int, num_heads: int, n: int,
                              groups: int, splits: int):
    """(bf16 shapes, f32 shapes) of K4's workspaces, in the C entry's
    order: y, qkv, g (window order), dctx, ctx, dqkv; then the per-group
    partials of drel and of the qkv-bias sums (one row per group and row
    block), the split-K partials, and the pair's per-row softmax statistics
    (m, 1 / l, rowsum(dP P), 0 for every row of the padded window; empty
    where attn_bwd_kernel takes the window)."""
    blocks = attn_bwd_blocks(n)
    rows = 0 if blocks == 1 else t // n * num_heads * (-(-n // 16) * 16)
    return (((t, c), (t, 3 * c), (t, c), (t, c), (t, c), (t, 3 * c)),
            ((groups, num_heads, n, n), (groups * blocks, 3 * c),
             (splits, 3 * c, c), (rows, 4)))


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
    check_attn_shape(name, n, c // num_heads)
    t = b * d * h * w
    sms = sm_count(x)
    blocks = attn_bwd_blocks(n)
    groups = attn_bwd_groups(t // n, num_heads, sms, blocks)
    splits = splitk_splits(t, 3 * c, c, sms)
    dev = x.device

    def bf(*shape):
        return torch.empty(shape, dtype=torch.bfloat16, device=dev)

    def f32(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    dy = torch.empty_like(x)
    dqkv_w, dqkv_b, dproj_w = f32(3 * c, c), f32(3 * c), f32(c, c)
    drel = f32(num_heads, n, n)
    bf_shapes, f32_shapes = attn_bwd_workspace_shapes(t, c, num_heads, n,
                                                      groups, splits)
    ws = (*(bf(*sh) for sh in bf_shapes), *(f32(*sh) for sh in f32_shapes))
    # the pair (N > 160) reads the mask by its labels, attn_bwd_kernel densely
    labels, off = mask_label_args(mask) if blocks > 1 else (None, None)
    rc = cuda_lib.library().lib.lrce_attn_bwd(
        x.data_ptr(), g.data_ptr(), b, d, h, w, c, *window, *shift,
        num_heads, ln_eps, ln_scale.data_ptr(), ln_bias.data_ptr(),
        qkv_w.data_ptr(), qkv_b.data_ptr(), proj_w.data_ptr(),
        rel_bias.data_ptr(), _ptr(mask), _ptr(labels), _ptr(off),
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
