"""K1 and K3: the whole Swin block (LN1 + window attention + proj + residual
+ LN2 + MLP + residual) as one call, and its shifted form; K5, the MLP
backward; and the block's backward.

``fused_swin_block`` (K1) replaces ``lrce_tpu/ops/pallas_swin_block.py``
(``fused_swin_block`` / ``_block_kernel``): x comes pre-rolled, as in JAX.
``fused_swin_pair`` (K3) replaces ``lrce_tpu/ops/pallas_swin_pair.py``
(``fused_swin_pair`` / ``_pair_kernel`` / ``_one_block``): k = 1 or 2
consecutive blocks on an unrolled x, each with its cyclic shift. Both run
``csrc/swin_block.cu``, where the shift is index arithmetic in the LN1
gather and the proj scatter, so a shifted block costs no roll passes. On
the model's path K1 runs the unshifted blocks of stages 0-2 and K3 (k = 1)
the shifted ones.

``mlp_bwd`` (K5) replaces ``_mlp_bwd_kernel`` / ``_mlp_bwd_impl``
(``csrc/mlp_bwd.cu``): it recomputes LN2, fc1 and the GELU and returns the
LN2-output cotangent and the MLP's weight gradients.

``fused_ln_mlp`` (K7) replaces ``_ln_mlp_kernel`` / ``_ln_mlp_fwd_impl``
(``csrc/ln_mlp.cu``): LN2 + MLP + residual as one persistent launch at any
C <= 1024 (``ln_mlp_supported``), its work list from ``ln_mlp_plan``; its
backward is K5 and the LN2 input backward, as ``_ln_mlp_bwd``. The Swin
tower runs it in every block wider than K1 / K3 take (Swin-B's stage 3, C
= 1024; Swin-L's stages 2-3, C = 768 / 1536); at a width K7 does not take
(C = 1536) its forward is the plain version, whose products are
tensor-core ``mm``s with f32 output, and its backward still K5.
``ops/mlp.py`` (K8) runs the same kernel without dp2 at the widths its own
does not take.

K1 and K3 are ``torch.autograd.Function``s that save only their inputs, as
``_block_fwd`` does. Their backward is ``_block_bwd``'s: recompute
h1 = x + dp1 * K6(x), K5 on (h1, g, dp2) and the LN2 input backward, then
K4 on dp1 * dh1 and the LN1 input backward. A shifted block passes its
shift to K6 and K4, whose addressing does the roll, so K3's backward is the
same code as K1's (``_pair_bwd`` re-traced rolls around the unfused ops).

A tensor on the CPU goes through the plain PyTorch versions in this module,
which have the kernels' rounding points, inside the same
``autograd.Function``s; a CUDA tensor launches the kernel or raises.
Nothing falls back.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from lrce_tpu_torch.ops import cuda_lib
from lrce_tpu_torch.ops.nn import (gelu, layer_norm, layer_norm_input_bwd,
                                   matmul_f32)
from lrce_tpu_torch.ops.window_attn import (NO_SHIFT, Shift, Window,
                                            mask_label_args,
                                            attention_proj_f32, attention_vjp,
                                            attn_fwd_launch_groups,
                                            check_attention_shapes,
                                            check_attn_shape,
                                            check_kernel_args, check_shift,
                                            expect_shape,
                                            fused_window_attention,
                                            roll_shift, sm_count,
                                            splitk_splits, window_partition,
                                            window_reverse)



def _per_sample(dp: torch.Tensor, ndim: int) -> torch.Tensor:
    return dp.reshape((-1,) + (1,) * (ndim - 1)).float()


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
    hmid = gelu(matmul_f32(z, w1) + b1.float()).to(dt)
    out = matmul_f32(hmid, w2) + b2.float()
    if dp2 is not None:
        out = out * _per_sample(dp2, 5)
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


# ---------------------------------------------------------------------------
# The back half of a block in one launch (csrc/back_half.cu), C = 128 / 256
# ---------------------------------------------------------------------------

BACK_HALF_WIDTHS = (128, 256)   # C at which K1 / K3 run it (FF = 4 C)


def back_half_supported(c: int, ff: int) -> bool:
    """Whether K1 / K3 run their back half as one launch at this width:
    C = 128 or 256 with FF = 4 C (stages 0 and 1). At C = 512 the fc2
    accumulator of a 64-row tile does not fit a thread's registers, and the
    back half is four launches."""
    return c in BACK_HALF_WIDTHS and ff == 4 * c


def back_half_plain(ctx, x, proj_w, proj_b, ln2s, ln2b, w1, b1, w2, b2,
                    dp1: Optional[torch.Tensor], dp2: Optional[torch.Tensor],
                    window: Window, shift: Shift = NO_SHIFT,
                    ln_eps: float = 1e-5) -> torch.Tensor:
    """Plain version of ``swin_back_half``, with ``_block_kernel``'s
    rounding points: proj + bias in f32, x dp1, rounded, back to spatial
    order under the shift and added to x in x's dtype (h1); then LN2, the
    MLP and the residual as ``ln_mlp_plain``."""
    b, d, h, w, c = x.shape
    n = window[0] * window[1] * window[2]
    a = matmul_f32(ctx.reshape(-1, c), proj_w) + proj_b.float()
    if dp1 is not None:
        a = a.reshape(b, -1, c) * dp1.reshape(b, 1, 1).float()
    a = window_reverse(a.to(x.dtype).reshape(-1, n, c), window, b, d, h, w)
    h1 = x + roll_shift(a, shift, 1)
    return ln_mlp_plain(h1, ln2s, ln2b, w1, b1, w2, b2, dp2, ln_eps)


def swin_back_half(ctx, x, proj_w, proj_b, ln2s, ln2b, w1, b1, w2, b2,
                   dp1: Optional[torch.Tensor], dp2: Optional[torch.Tensor],
                   window: Window, shift: Shift = NO_SHIFT,
                   ln_eps: float = 1e-5) -> torch.Tensor:
    """The back half of a Swin block: out = h1 + dp2 * fc2(gelu(fc1(LN2
    h1))) with h1 = x + dp1 * proj(ctx), where ctx (T, C) holds the
    attention's output in window order (``window_partition`` of x rolled by
    -shift) and x, out are (B, D, H, W, C).

    The part of K1 / K3 that ``csrc/back_half.cu`` runs in one launch at C =
    128 or 256 (``back_half_supported``), h1 and the (T, 4C) hidden on chip;
    this entry runs it alone, as the tests and ``chip_smoke.py`` do. On
    CUDA: ctx, x and the matrices bf16 and contiguous, LN parameters,
    biases and dp1 / dp2 ((B,) or None) f32. No autograd."""
    if x.device.type == "cpu":
        return back_half_plain(ctx, x, proj_w, proj_b, ln2s, ln2b, w1, b1,
                               w2, b2, dp1, dp2, window, shift, ln_eps)
    name = "swin_back_half"
    dp1 = None if dp1 is None else dp1.reshape(-1)
    dp2 = None if dp2 is None else dp2.reshape(-1)
    check_kernel_args(name, x, window, 1, (ctx, proj_w, w1, w2),
                      (proj_b, ln2s, ln2b, b1, b2, dp1, dp2))
    b, d, h, w, c = x.shape
    ff = w1.shape[0]
    if not back_half_supported(c, ff):
        raise ValueError(f"{name}: takes C in {BACK_HALF_WIDTHS} with FF = "
                         f"4 C, got C = {c}, FF = {ff}")
    expect_shape(name, ctx, (b * d * h * w, c))
    expect_shape(name, proj_w, (c, c))
    for t in (proj_b, ln2s, ln2b, b2):
        expect_shape(name, t, (c,))
    expect_shape(name, w1, (ff, c))
    expect_shape(name, b1, (ff,))
    expect_shape(name, w2, (c, ff))
    expect_shape(name, dp1, (b,))
    expect_shape(name, dp2, (b,))
    check_shift(name, x, shift)
    out = torch.empty_like(x)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    rc = cuda_lib.library().lib.lrce_back_half(
        ctx.data_ptr(), x.data_ptr(), out.data_ptr(), b, d, h, w, c, *window,
        *shift, ln_eps, *(ptr(t) for t in (proj_w, proj_b, ln2s, ln2b, w1,
                                             b1, w2, b2, dp1, dp2)),
        cuda_lib.stream(x))
    cuda_lib.check(name, rc)
    swin_back_half.launches += 1
    return out


swin_back_half.launches = 0


# ---------------------------------------------------------------------------
# K5: the MLP backward
# ---------------------------------------------------------------------------

def _scale_g(g: torch.Tensor, dp2: Optional[torch.Tensor], dt) -> torch.Tensor:
    g = g.to(dt)
    if dp2 is None:
        return g
    return (g.float() * _per_sample(dp2, g.ndim)).to(dt)


def mlp_bwd_plain(h1, g, ln2s, ln2b, w1, b1, w2,
                  dp2: Optional[torch.Tensor], ln_eps: float = 1e-5):
    """Plain version of K5, with ``_mlp_bwd_kernel``'s rounding points.

    h1: the MLP half's input (B, D, H, W, C); g: the block output's
    cotangent; dp2: (B,) multipliers or None. Returns (dz, dw1, db1, dw2,
    db2): dz, the cotangent of the LN2 output, summed in f32 and rounded
    once to h1's dtype; the rest f32 in nn.Linear layouts (w1 (FF, C),
    w2 (C, FF)).
    """
    dt = h1.dtype
    c = h1.shape[-1]
    z = layer_norm(h1, ln2s, ln2b, ln_eps).reshape(-1, c)
    g2 = _scale_g(g, dp2, dt).reshape(-1, c).float()
    pre = matmul_f32(z, w1) + b1.float()
    cdf = 0.5 * (1.0 + torch.erf(pre * (1.0 / math.sqrt(2.0))))
    hid = (pre * cdf).to(dt).float()
    dw2 = torch.matmul(g2.t(), hid)
    db2 = g2.sum(0)
    dhid = torch.matmul(g2, w2.float())
    pdf = torch.exp(-0.5 * pre * pre) * (1.0 / math.sqrt(2.0 * math.pi))
    dpre = dhid * (cdf + pre * pdf)
    db1 = dpre.sum(0)
    dpre = dpre.to(dt).float()
    dw1 = torch.matmul(dpre.t(), z.float())
    dz = torch.matmul(dpre, w1.float()).to(dt).reshape(h1.shape)
    return dz, dw1, db1, dw2, db2


MLP_BWD_TILE_ROWS = 128     # tokens per tile of K5's hidden kernel


def mlp_bwd_col_rows(t: int) -> int:
    """Rows of K5's column-sum workspace: the hidden kernel writes one f32
    row of db1 partials per tile of 128 tokens, summed in a fixed order."""
    return -(-t // MLP_BWD_TILE_ROWS)


def mlp_bwd_workspace_shapes(t: int, c: int, ff: int, splits: int):
    """(bf16 shapes, f32 shapes) of K5's workspaces, in the C entry's
    order: z, the bf16 hidden, the bf16 dpre; the column sums and the
    split-K partials. No f32 (T, FF) array: the pre-activation stays in
    registers."""
    return (((t, c), (t, ff), (t, ff)),
            ((mlp_bwd_col_rows(t), ff), (splits, ff * c)))


def _mlp_bwd_kernel(h1, g, ln2s, ln2b, w1, b1, w2, dp2, ln_eps):
    name = "mlp_bwd"
    check_kernel_args(name, h1, (1, 1, 1), 1, (g, w1, w2),
                      (ln2s, ln2b, b1, dp2))
    b, d, h, w, c = h1.shape
    ff = w1.shape[0]
    expect_shape(name, g, h1.shape)
    for t in (ln2s, ln2b):
        expect_shape(name, t, (c,))
    expect_shape(name, w1, (ff, c))
    expect_shape(name, b1, (ff,))
    expect_shape(name, w2, (c, ff))
    expect_shape(name, dp2, (b,))
    if ff % 64:
        raise ValueError(f"{name}: MLP width {ff} is not a multiple of 64")
    t = b * d * h * w
    dev = h1.device
    sms = sm_count(h1)
    splits = max(splitk_splits(t, ff, c, sms), splitk_splits(t, c, ff, sms))

    def bf(*shape):
        return torch.empty(shape, dtype=torch.bfloat16, device=dev)

    def f32(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    dz = torch.empty_like(h1)
    dw1, db1, dw2 = f32(ff, c), f32(ff), f32(c, ff)
    g2 = bf(t, c)
    col_rows = mlp_bwd_col_rows(t)
    bf_shapes, f32_shapes = mlp_bwd_workspace_shapes(t, c, ff, splits)
    ws = (*(bf(*sh) for sh in bf_shapes), *(f32(*sh) for sh in f32_shapes))
    rc = cuda_lib.library().lib.lrce_mlp_bwd(
        h1.data_ptr(), g.data_ptr(), b, d, h, w, c, ff, ln_eps,
        ln2s.data_ptr(), ln2b.data_ptr(), w1.data_ptr(), b1.data_ptr(),
        w2.data_ptr(),
        None if dp2 is None else dp2.data_ptr(), dz.data_ptr(),
        dw1.data_ptr(), db1.data_ptr(), dw2.data_ptr(), g2.data_ptr(),
        *(t_.data_ptr() for t_ in ws), col_rows, splits,
        cuda_lib.stream(h1))
    cuda_lib.check(name, rc)
    mlp_bwd.launches += 1
    db2 = g2.float().sum(0)          # sum g, outside the kernel as in JAX
    return dz, dw1, db1, dw2, db2


def mlp_bwd(h1, g, ln2s, ln2b, w1, b1, w2, dp2: Optional[torch.Tensor],
            ln_eps: float = 1e-5):
    """K5: the backward of out = h1 + dp2 * fc2(gelu(fc1(LN2 h1))) up to
    the LN2 output, for the output cotangent g (see ``mlp_bwd_plain``). On
    CUDA: h1, g, w1, w2 bf16; LN parameters, b1 and dp2 f32."""
    if h1.device.type == "cpu":
        return mlp_bwd_plain(h1, g, ln2s, ln2b, w1, b1, w2, dp2, ln_eps)
    return _mlp_bwd_kernel(h1, g, ln2s, ln2b, w1, b1, w2, dp2, ln_eps)


mlp_bwd.launches = 0


# ---------------------------------------------------------------------------
# K7: LN2 + MLP + residual
# ---------------------------------------------------------------------------

def ln_mlp_plain(h1, ln2s, ln2b, w1, b1, w2, b2,
                 dp2: Optional[torch.Tensor], ln_eps: float = 1e-5):
    """Plain version of K7 (and, with dp2 None, of K8), with
    ``_ln_mlp_kernel``'s rounding points: LN2 in f32, rounded; fc1 + b1 and
    the exact-erf GELU in f32, the hidden rounded; fc2 + b2 in f32, times
    the sample's dp2, + h1 in f32, rounded once.

    h1: (B, D, H, W, C); w1 (FF, C), w2 (C, FF) in nn.Linear layout; dp2:
    (B,) or (B, 1) f32 multipliers or None."""
    dt = h1.dtype
    z = layer_norm(h1, ln2s, ln2b, ln_eps)
    hid = gelu(matmul_f32(z, w1) + b1.float()).to(dt)
    out = matmul_f32(hid, w2) + b2.float()
    if dp2 is not None:
        out = out * _per_sample(dp2, h1.ndim)
    return (h1.float() + out).to(dt)


LN_MLP_TILE = 128       # rows and columns of a GEMM tile of the kernel
LN_MLP_MAX_SPLITS = 8   # fc2 slices of FF at most


class LnMlpPlan(NamedTuple):
    """The work list of one call of the K7 kernel (``csrc/ln_mlp.cu``): the
    ``fc1_tiles`` fc1 tiles of each block of 128 rows and, ``lag`` row
    blocks later, its ``fc2_tiles`` x ``splits`` fc2 tasks (column tile by
    column tile, the slices of FF of a tile side by side); ``grid`` CTAs,
    ``counters`` zeroed ints. The LayerNorm is not in the list: three warps
    of every CTA take its jobs of 2 rows from a ticket of their own."""
    row_blocks: int
    fc1_tiles: int
    fc2_tiles: int
    splits: int
    lag: int
    tasks: int
    grid: int
    counters: int


def ln_mlp_supported(c: int, ff: int) -> bool:
    """The widths the K7 kernel takes: C a multiple of 64 up to 1024, FF a
    multiple of 128."""
    return 64 <= c <= 1024 and c % 64 == 0 and ff >= 128 and ff % 128 == 0


def ln_mlp_plan(t: int, c: int, ff: int, sms: int) -> LnMlpPlan:
    """The K7 kernel's work list for T rows of C on a card of ``sms`` SMs.
    fc2 is split over FF into the most slices (a power of two, each a
    multiple of 64 deep, at most 8) that keep row blocks x column tiles x
    slices within the 2 x ``sms`` consumer warpgroups: at T = 882, C =
    1024, 7 x 8 tiles become 224 tasks; at T = 7,056 the 448 tiles fill
    the card unsplit. A row block's fc2 follows its fc1 ``lag`` row blocks
    later: two waves of the consumers' fc1 tiles in between."""
    rb = -(-t // LN_MLP_TILE)
    nct = -(-c // LN_MLP_TILE)
    nf1 = ff // LN_MLP_TILE
    splits = 1
    while (2 * splits <= LN_MLP_MAX_SPLITS and (ff // 64) % (2 * splits) == 0
           and rb * nct * 2 * splits <= 2 * sms):
        splits *= 2
    lag = -(-4 * sms // nf1)
    tasks = rb * (nf1 + nct * splits)
    return LnMlpPlan(rb, nf1, nct, splits, lag, tasks, min(sms, tasks),
                     3 + rb + rb * nct)


def ln_mlp_tasks(plan: LnMlpPlan) -> List[Tuple[str, int, int, int]]:
    """The tasks of ``plan`` in ticket order, as the kernel decodes them:
    ("fc1", row block, column tile, 0), ("fc2", row block, column tile,
    slice)."""
    out = []
    for step in range(plan.row_blocks + plan.lag):
        if step < plan.row_blocks:
            out += [("fc1", step, i, 0) for i in range(plan.fc1_tiles)]
        if step >= plan.lag:
            out += [("fc2", step - plan.lag, i, s)
                    for i in range(plan.fc2_tiles)
                    for s in range(plan.splits)]
    return out


# The kernel's counters, per (device, stream): zero when made, and set back
# to zero by every launch before it ends, so a buffer serves every later
# call on its stream.
_LN_MLP_COUNTERS: dict = {}


def _ln_mlp_counters(dev: torch.device, n: int) -> torch.Tensor:
    stream = torch.cuda.current_stream(dev)
    key = (dev.index, stream.cuda_stream)
    buf = _LN_MLP_COUNTERS.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 4096), dtype=torch.int32, device=dev)
        _LN_MLP_COUNTERS[key] = buf
    return buf


def ln_mlp_forward(counted, h1, ln2s, ln2b, w1, b1, w2, b2, dp2, ln_eps):
    """The plain version on the CPU; on CUDA one launch of the K7 kernel
    (``csrc/ln_mlp.cu``), counted on ``counted`` (``fused_ln_mlp``, or
    ``ops.mlp.fused_mlp`` at the widths its own kernel does not take).
    dp2: (B,) f32 or None."""
    if h1.device.type == "cpu":
        return ln_mlp_plain(h1, ln2s, ln2b, w1, b1, w2, b2, dp2, ln_eps)
    name = counted.__name__
    check_kernel_args(name, h1, (1, 1, 1), 1, (w1, w2),
                      (ln2s, ln2b, b1, b2, dp2))
    b, d, h, w, c = h1.shape
    ff = w1.shape[0]
    for t in (ln2s, ln2b, b2):
        expect_shape(name, t, (c,))
    expect_shape(name, w1, (ff, c))
    expect_shape(name, b1, (ff,))
    expect_shape(name, w2, (c, ff))
    expect_shape(name, dp2, (b,))
    if not ln_mlp_supported(c, ff):
        raise ValueError(f"{name}: takes C a multiple of 64 up to 1024 and "
                         f"FF a multiple of 128, got C = {c}, FF = {ff}")
    t = b * d * h * w
    plan = ln_mlp_plan(t, c, ff, sm_count(h1))
    out = torch.empty_like(h1)
    ws_z = torch.empty((t, c), dtype=h1.dtype, device=h1.device)
    ws_hid = torch.empty((t, ff), dtype=h1.dtype, device=h1.device)
    ws_part = None if plan.splits == 1 else torch.empty(
        (plan.row_blocks * LN_MLP_TILE, plan.fc2_tiles * LN_MLP_TILE),
        dtype=torch.float32, device=h1.device)
    counters = _ln_mlp_counters(h1.device, plan.counters)
    rc = cuda_lib.library().lib.lrce_ln_mlp_fwd(
        h1.data_ptr(), out.data_ptr(), t, c, ff, d * h * w, plan.splits,
        plan.lag, plan.grid, ln_eps, ln2s.data_ptr(), ln2b.data_ptr(),
        w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
        None if dp2 is None else dp2.data_ptr(), ws_z.data_ptr(),
        ws_hid.data_ptr(), None if ws_part is None else ws_part.data_ptr(),
        counters.data_ptr(), cuda_lib.stream(h1))
    cuda_lib.check(name, rc)
    counted.launches += 1
    return out


def _fused_ln_mlp_forward(h1, ln2s, ln2b, w1, b1, w2, b2, dp2, ln_eps):
    """``fused_ln_mlp``'s forward: the K7 kernel where it takes the width,
    else the plain version (on the card too)."""
    if ln_mlp_supported(h1.shape[-1], w1.shape[0]):
        return ln_mlp_forward(fused_ln_mlp, h1, ln2s, ln2b, w1, b1, w2, b2,
                              dp2, ln_eps)
    return ln_mlp_plain(h1, ln2s, ln2b, w1, b1, w2, b2, dp2, ln_eps)


class _LnMlpFn(torch.autograd.Function):
    """K7 forward (``_fused_ln_mlp_forward``); backward K5 + the LN2 input
    backward, dh1 = g + dh1_ln, as ``_ln_mlp_bwd``. Saves only the inputs;
    dp2 gets no gradient."""

    @staticmethod
    def forward(ctx, h1, ln2s, ln2b, w1, b1, w2, b2, dp2, ln_eps):
        ctx.save_for_backward(h1, ln2s, ln2b, w1, b1, w2, b2, dp2)
        ctx.ln_eps = ln_eps
        return _fused_ln_mlp_forward(h1, ln2s, ln2b, w1, b1, w2, b2, dp2,
                                     ln_eps)

    @staticmethod
    def backward(ctx, g):
        h1, ln2s, ln2b, w1, b1, w2, b2, dp2 = ctx.saved_tensors
        dt = h1.dtype
        g = g.to(dt).contiguous()
        dz, dw1, db1, dw2, db2 = mlp_bwd(h1, g, ln2s, ln2b, w1, b1, w2, dp2,
                                         ctx.ln_eps)
        dh1_ln, dln2s, dln2b = layer_norm_input_bwd(h1, dz, ln2s, ctx.ln_eps)
        dh1 = (g.float() + dh1_ln).to(dt)
        return (dh1, dln2s.to(ln2s.dtype), dln2b.to(ln2b.dtype),
                dw1.to(w1.dtype), db1.to(b1.dtype), dw2.to(w2.dtype),
                db2.to(b2.dtype), None, None)


def fused_ln_mlp(h1, ln2s, ln2b, w1, b1, w2, b2,
                 dp2: Optional[torch.Tensor] = None,
                 ln_eps: float = 1e-5) -> torch.Tensor:
    """K7: out = h1 + dp2 * fc2(gelu(fc1(LN2(h1)))) on (B, D, H, W, C): the
    kernel at C <= 1024 (``ln_mlp_supported``), the plain version with its
    rounding points at wider C (Swin-L's stage 3, C = 1536).

    w1 (FF, C), w2 (C, FF) in nn.Linear layout, in h1's dtype; LN parameters
    and biases f32; dp2: (B,) or (B, 1) f32 per-sample stochastic-depth
    multipliers, or None when inactive. On CUDA: h1, w1, w2 bf16 and
    contiguous. Differentiable at every width: the backward is K5
    (``mlp_bwd``) and the LN2 input backward; with grad mode off the
    forward runs without the autograd.Function."""
    dp = None if dp2 is None else dp2.reshape(-1)
    if not torch.is_grad_enabled():
        return _fused_ln_mlp_forward(h1, ln2s, ln2b, w1, b1, w2, b2, dp,
                                     ln_eps)
    return _LnMlpFn.apply(h1, ln2s, ln2b, w1, b1, w2, b2, dp, ln_eps)


fused_ln_mlp.launches = 0


# ---------------------------------------------------------------------------
# The forward of one block
# ---------------------------------------------------------------------------

def _one_block(counted, x, shift, wts, mask, dp1, dp2, window, num_heads,
               ln_eps):
    """One block: on the CPU the plain version between rolls by -shift and
    +shift; on CUDA the kernel, the shift in its addressing, counted on
    ``counted`` (``fused_swin_block`` or ``fused_swin_pair``). wts: the 13
    block tensors ln1s ... b2, rel_bias at index 6; dp1, dp2: (B,) or
    None."""
    if x.device.type == "cpu":
        y = swin_block_plain(roll_shift(x, shift, -1), *wts[:7], mask,
                             *wts[7:], dp1, dp2, window, num_heads, ln_eps)
        return roll_shift(y, shift, 1)
    name = counted.__name__
    ln1s, ln1b, qkv_w, qkv_b, proj_w, proj_b, rel_bias, ln2s, ln2b, w1, b1, \
        w2, b2 = wts
    check_kernel_args(name, x, window, num_heads, (qkv_w, proj_w, w1, w2),
                      (ln1s, ln1b, qkv_b, proj_b, rel_bias, mask, ln2s, ln2b,
                       b1, b2, dp1, dp2))
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
    check_shift(name, x, shift)
    n = window[0] * window[1] * window[2]
    check_attn_shape(name, n, c // num_heads)
    t = b * d * h * w
    out = torch.empty_like(x)
    # the back half in one launch (h1 and the hidden on chip) where its
    # kernel takes the width, else four launches through device memory
    one_launch = back_half_supported(c, ff)
    # scratch: (T, C) LN output / ctx, (T, 3C) qkv (or (T, max(3C, FF)) qkv
    # / hidden), (T, C) h1 for the four launches
    ws = (torch.empty((t, c), dtype=x.dtype, device=x.device),
          torch.empty((t, 3 * c if one_launch else max(3 * c, ff)),
                      dtype=x.dtype, device=x.device),
          None if one_launch else torch.empty((t, c), dtype=x.dtype,
                                              device=x.device))
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    labels, off = mask_label_args(mask)
    rc = cuda_lib.library().lib.lrce_swin_block_fwd(
        x.data_ptr(), out.data_ptr(), b, d, h, w, c, *window, *shift,
        num_heads, ff, ln_eps, *(ptr(t) for t in (
            ln1s, ln1b, qkv_w, qkv_b, proj_w, proj_b, rel_bias, mask, labels,
            off, ln2s, ln2b, w1, b1, w2, b2, dp1, dp2)),
        attn_fwd_launch_groups(t // n, n, c // num_heads, num_heads,
                               sm_count(x)), int(one_launch),
        *(ptr(t) for t in ws),
        cuda_lib.stream(x))
    cuda_lib.check(name, rc)
    counted.launches += 1
    if one_launch:
        swin_back_half.launches += 1
    return out


# ---------------------------------------------------------------------------
# The block backward (``_block_bwd``), shared by K1 and K3
# ---------------------------------------------------------------------------

def block_vjp(x, g, wts, mask, dp1, dp2, window, num_heads, ln_eps,
              shift: Shift = NO_SHIFT):
    """Gradients of one block for the output cotangent g: (dx, 13 weight
    gradients in ``wts`` order). dp1 / dp2 get none."""
    ln1s, ln1b, qkv_w, qkv_b, proj_w, proj_b, rel_bias, ln2s, ln2b, w1, b1, \
        w2, b2 = wts
    dt = x.dtype
    g = g.to(dt).contiguous()
    with torch.no_grad():
        a = fused_window_attention(x, ln1s, ln1b, qkv_w, qkv_b, proj_w,
                                   proj_b, rel_bias, mask, window, num_heads,
                                   ln_eps, shift)
    if dp1 is not None:
        a = (a.float() * _per_sample(dp1, a.ndim)).to(dt)
    h1 = x + a
    dz, dw1, db1, dw2, db2 = mlp_bwd(h1, g, ln2s, ln2b, w1, b1, w2, dp2,
                                     ln_eps)
    dh1_ln, dln2s, dln2b = layer_norm_input_bwd(h1, dz, ln2s, ln_eps)
    dh1 = (g.float() + dh1_ln).to(dt)
    ga = dh1 if dp1 is None else (dh1.float()
                                  * _per_sample(dp1, dh1.ndim)).to(dt)
    dx_a, dln1s, dln1b, dqkv_w, dqkv_b, dproj_w, dproj_b, drel = (
        attention_vjp(x, ga, ln1s, ln1b, qkv_w, qkv_b, proj_w, rel_bias, mask,
                      window, num_heads, ln_eps, shift))
    dx = dh1 + dx_a
    return dx, (dln1s, dln1b, dqkv_w, dqkv_b, dproj_w, dproj_b, drel,
                dln2s.to(ln2s.dtype), dln2b.to(ln2b.dtype), dw1.to(w1.dtype),
                db1.to(b1.dtype), dw2.to(w2.dtype), db2.to(b2.dtype))


def _run_blocks(counted, x, mask, dp1, dp2, window, num_heads, shifts, masked,
                ln_eps, stacked):
    """k consecutive blocks, block i with shifts[i], the weights stacked[.][i]
    and the mask if masked[i]. Returns (output, the input of each block)."""
    xs: List[torch.Tensor] = []
    for blk, s in enumerate(shifts):
        xs.append(x)
        x = _one_block(counted, x, s, [t[blk] for t in stacked],
                       mask if masked[blk] else None,
                       None if dp1 is None else dp1[blk],
                       None if dp2 is None else dp2[blk], window, num_heads,
                       ln_eps)
    return x, xs


class _SwinBlocksFn(torch.autograd.Function):
    """k consecutive blocks (shifts[i] per block) with per-block weights
    stacked on a leading axis; K1 (k = 1, no shift) or K3. masked[i]: block
    i adds the mask. Saves the inputs of each block (for k = 1, the inputs
    only)."""

    @staticmethod
    def forward(ctx, counted, x, mask, dp1, dp2, window, num_heads, shifts,
                masked, ln_eps, *stacked):
        x, xs = _run_blocks(counted, x, mask, dp1, dp2, window, num_heads,
                            shifts, masked, ln_eps, stacked)
        ctx.save_for_backward(mask, dp1, dp2, *xs, *stacked)
        ctx.cfg = (window, num_heads, tuple(shifts), masked, ln_eps)
        return x

    @staticmethod
    def backward(ctx, g):
        window, num_heads, shifts, masked, ln_eps = ctx.cfg
        k = len(shifts)
        mask, dp1, dp2, *rest = ctx.saved_tensors
        xs, stacked = rest[:k], rest[k:]
        grads = [[None] * k for _ in stacked]
        for blk in reversed(range(k)):
            s = shifts[blk]
            g, gw = block_vjp(xs[blk], g, [t[blk] for t in stacked],
                              mask if masked[blk] else None,
                              None if dp1 is None else dp1[blk],
                              None if dp2 is None else dp2[blk], window,
                              num_heads, ln_eps, s)
            for i, gi in enumerate(gw):
                grads[i][blk] = gi
        return (None, g, None, None, None, None, None, None, None, None,
                *(torch.stack(gl) for gl in grads))


def fused_swin_block(x, ln1s, ln1b, qkv_w, qkv_b, proj_w, proj_b, rel_bias,
                     mask, ln2s, ln2b, w1, b1, w2, b2, dp1, dp2,
                     window: Window, num_heads: int,
                     ln_eps: float = 1e-5) -> torch.Tensor:
    """Whole Swin block on a pre-rolled, window-aligned (B, D, H, W, C) x.

    Weights in nn.Linear layout: qkv_w (3C, C), proj_w (C, C), w1 (FF, C),
    w2 (C, FF); LN parameters and biases f32. rel_bias (nH, N, N) f32. mask
    (nd, nh, nw, N, N) f32, or None for an unshifted block. dp1, dp2: (B,)
    or (B, 1) f32 per-sample stochastic-depth multipliers, or None when
    inactive. Differentiable: the backward is K6 + K5 + K4; with grad mode
    off the block runs without the autograd.Function.
    """
    wts = (ln1s, ln1b, qkv_w, qkv_b, proj_w, proj_b, rel_bias, ln2s, ln2b,
           w1, b1, w2, b2)
    if not torch.is_grad_enabled():
        return _one_block(fused_swin_block, x, NO_SHIFT, wts, mask,
                          None if dp1 is None else dp1.reshape(-1),
                          None if dp2 is None else dp2.reshape(-1), window,
                          num_heads, ln_eps)
    d1 = None if dp1 is None else dp1.reshape(1, -1)
    d2 = None if dp2 is None else dp2.reshape(1, -1)
    return _SwinBlocksFn.apply(fused_swin_block, x, mask, d1, d2, window,
                               num_heads, (NO_SHIFT,), (mask is not None,),
                               ln_eps, *(t.unsqueeze(0) for t in wts))


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
    (0, 0, 0) for W-MSA, the stage's shift for SW-MSA. Each block launches
    the kernel once. Differentiable: the backward is K6 + K5 + K4 per block.
    """
    k = len(shifts)
    if k not in (1, 2) or any(t.shape[0] != k for t in (
            ln1s, ln1b, qkv_w, qkv_b, proj_w, proj_b, rel_bias, ln2s, ln2b,
            w1, b1, w2, b2)):
        raise ValueError(f"fused_swin_pair: k = {k} shifts need weights "
                         "stacked on a leading axis of k, and k must be 1 "
                         "or 2")
    shifts = tuple(tuple(s) for s in shifts)
    masked = tuple(any(s) for s in shifts)
    stacked = (ln1s, ln1b, qkv_w, qkv_b, proj_w, proj_b, rel_bias, ln2s, ln2b,
               w1, b1, w2, b2)
    if not torch.is_grad_enabled():
        return _run_blocks(fused_swin_pair, x, mask, dp1, dp2, window,
                           num_heads, shifts, masked, ln_eps, stacked)[0]
    return _SwinBlocksFn.apply(fused_swin_pair, x, mask, dp1, dp2, window,
                               num_heads, shifts, masked, ln_eps, *stacked)


fused_swin_pair.launches = 0
