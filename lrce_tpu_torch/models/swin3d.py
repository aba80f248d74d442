"""Video Swin Transformer 3D (Swin-B, and Swin-L at 384 x 384), channels-last,
eval and training forward.

Counterpart of ``lrce_tpu/models/swin3d.py``: patch embed Conv3d (2,4,4),
four stages of (W-MSA, SW-MSA) blocks with relative position bias, patch
merging between stages, final LayerNorm. Activations stay (B, D, H, W, C)
as in the JAX package. Parameter names follow the reference checkpoint
(``patch_embed.proj``, ``layers.{i}.blocks.{j}.attn.qkv``, ...), so
``state_dict()`` loads a Video-Swin checkpoint as it is.

Two routes through a stage, chosen by ``SwinTransformer3D.use_kernels``:
  - kernels (the default), where the JAX package routes Pallas kernels:
    on window-aligned stages with C <= 512, unshifted blocks run K1
    (``fused_swin_block``) and shifted blocks K3 (``fused_swin_pair`` with
    k = 1, the shift inside the kernel); at C > 512 (Swin-B's stage 3,
    Swin-L's stages 2-3) the attention runs K2
    (``fused_window_attention_hsplit``) and LN2 + MLP + residual run
    ``fused_ln_mlp``, the JAX package's ``LRCE_TPU_LNMLP`` route: its
    forward is K7 where K7 takes the width (``ln_mlp_supported``: C <=
    1024), else the plain version at K7's rounding points, and its
    backward K5 at every width. Stages that need padding, or whose
    windows or width no kernel takes (``window_kernels_supported``: C <=
    1536, head_dim 16 or 32 and windows of at most 448 tokens, in either
    grad mode; not Swin-L's unclamped (8, 12, 12) window, N = 1152), take
    the plain block;
  - plain: every block is ``swin_block``, the JAX package's XLA path (pad,
    roll, partition, attention, reverse, unroll, crop, MLP).
On a CPU tensor a kernel wrapper runs its own plain version, so both
routes run, and are tested, without a GPU. The kernel wrappers are
``autograd.Function``s (backward K6 + K5 + K4, or K4 for K2), so both
routes train.

In training every block draws per-sample stochastic-depth multipliers
dp1, dp2 (B,) = bernoulli(1 - rate) / (1 - rate) from the caller's
``torch.Generator``, with the rates linspace(0, drop_path_rate) over all
blocks, as ``lrce_tpu.models.swin3d`` draws them; both routes consume the
same draws.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from lrce_tpu_torch.ops.nn import LayerNorm, Linear, gelu, trunc_normal
from lrce_tpu_torch.ops.swin_block import (fused_ln_mlp, fused_swin_block,
                                            fused_swin_pair, ln_mlp_supported)
from lrce_tpu_torch.ops.window_attn import (ATTN_FWD_WIDE_TOKENS,
                                            fused_window_attention_hsplit,
                                            window_kernels_supported,
                                            window_partition, window_reverse)
from lrce_tpu_torch.utils import trace

LN_EPS = 1e-5
# Widest stage whose blocks run K1/K3; wider stages run K2 (the JAX
# package's "full" / "hsplit" split, swin3d._pallas_supported).
BLOCK_KERNEL_MAX_C = 512


class SwinConfig(NamedTuple):
    patch_size: Tuple[int, int, int] = (2, 4, 4)
    in_chans: int = 3
    embed_dim: int = 128
    depths: Tuple[int, ...] = (2, 2, 18, 2)
    num_heads: Tuple[int, ...] = (4, 8, 16, 32)
    window_size: Tuple[int, int, int] = (8, 7, 7)
    mlp_ratio: float = 4.0
    drop_path_rate: float = 0.2


SWIN_BASE = SwinConfig()
# Video Swin-L at 384 x 384 (Kinetics-600, ImageNet-22K pretrained; Liu et
# al., arXiv:2106.13230, configs/recognition/swin/swin_large_384_patch244_
# window81212_kinetics600_22k.py): head_dim 32 at every stage, the window
# (8, 12, 12), clamped to (3, 12, 12) on 5-frame clips (N = 432).
SWIN_LARGE = SwinConfig(embed_dim=192, num_heads=(6, 12, 24, 48),
                        window_size=(8, 12, 12))
# the towers a model configuration names by its ``swin`` key
SWIN_CONFIGS = {"base": SWIN_BASE, "large": SWIN_LARGE}


def get_window_size(x_size: Sequence[int], window_size: Sequence[int],
                    shift_size: Sequence[int]):
    """Clamp the window, and zero the shift, on axes where the input is no
    larger than the window."""
    use_window = list(window_size)
    use_shift = list(shift_size)
    for i in range(len(x_size)):
        if x_size[i] <= window_size[i]:
            use_window[i] = x_size[i]
            use_shift[i] = 0
    return tuple(use_window), tuple(use_shift)


@functools.lru_cache(maxsize=None)
def relative_position_index(full_window: Tuple[int, int, int]) -> np.ndarray:
    """Pairwise relative-position index over the constructor window; a
    clamped window takes the top-left (N, N) block."""
    wd, wh, ww = full_window
    coords = np.stack(np.meshgrid(np.arange(wd), np.arange(wh), np.arange(ww),
                                  indexing="ij"))
    flat = coords.reshape(3, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0)
    rel = rel.astype(np.int64)
    rel[:, :, 0] += wd - 1
    rel[:, :, 1] += wh - 1
    rel[:, :, 2] += ww - 1
    rel[:, :, 0] *= (2 * wh - 1) * (2 * ww - 1)
    rel[:, :, 1] *= 2 * ww - 1
    return rel.sum(-1)


@functools.lru_cache(maxsize=None)
def compute_shift_mask(dims: Tuple[int, int, int], window: Tuple[int, int, int],
                       shift: Tuple[int, int, int]) -> np.ndarray:
    """Additive (nW, N, N) mask, 0 or -100, for shifted windows."""
    dp, hp, wp = dims
    img = np.zeros((dp, hp, wp), np.int32)
    cnt = 0
    for d in (slice(-window[0]), slice(-window[0], -shift[0] or None),
              slice(-shift[0] or dp, None)):
        for h in (slice(-window[1]), slice(-window[1], -shift[1] or None),
                  slice(-shift[1] or hp, None)):
            for w in (slice(-window[2]), slice(-window[2], -shift[2] or None),
                      slice(-shift[2] or wp, None)):
                img[d, h, w] = cnt
                cnt += 1
    nd, nh, nw = dp // window[0], hp // window[1], wp // window[2]
    win = img.reshape(nd, window[0], nh, window[1], nw, window[2])
    win = win.transpose(0, 2, 4, 1, 3, 5).reshape(-1, int(np.prod(window)))
    diff = win[:, None, :] - win[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------

class PatchProj(nn.Module):
    """Conv3d weight (O, I, pd, ph, pw) in the compute dtype, f32 bias."""

    def __init__(self, cfg: SwinConfig, dtype, generator):
        super().__init__()
        shape = (cfg.embed_dim, cfg.in_chans) + tuple(cfg.patch_size)
        self.weight = nn.Parameter(trunc_normal(shape, 0.02, generator).to(dtype))
        self.bias = nn.Parameter(torch.zeros(cfg.embed_dim))


class PatchEmbed3D(nn.Module):
    def __init__(self, cfg: SwinConfig, dtype, generator):
        super().__init__()
        self.patch_size = tuple(cfg.patch_size)
        self.proj = PatchProj(cfg, dtype, generator)
        self.norm = LayerNorm(cfg.embed_dim, LN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, D, H, W, C_in) -> (B, D', H', W', embed_dim); each spatial axis
        is zero-padded up to a multiple of the patch size."""
        pd, ph, pw = self.patch_size
        _, d, h, w, _ = x.shape
        pads = ((pd - d % pd) % pd, (ph - h % ph) % ph, (pw - w % pw) % pw)
        if any(pads):
            x = F.pad(x, (0, 0, 0, pads[2], 0, pads[1], 0, pads[0]))
        y = F.conv3d(x.permute(0, 4, 1, 2, 3), self.proj.weight.to(x.dtype),
                     stride=self.patch_size)
        y = y.permute(0, 2, 3, 4, 1).contiguous()
        y = (y.float() + self.proj.bias.float()).to(x.dtype)
        return self.norm(y)


class WindowAttention3D(nn.Module):
    def __init__(self, dim: int, num_heads: int, window: Tuple[int, int, int],
                 dtype, generator):
        super().__init__()
        self.num_heads = num_heads
        table_len = (2 * window[0] - 1) * (2 * window[1] - 1) * (2 * window[2] - 1)
        self.qkv = Linear(dim, 3 * dim, dtype=dtype, init="trunc_normal",
                          generator=generator)
        self.proj = Linear(dim, dim, dtype=dtype, init="trunc_normal",
                           generator=generator)
        self.relative_position_bias_table = nn.Parameter(
            trunc_normal((table_len, num_heads), 0.02, generator))

    def rel_bias(self, rel_index: torch.Tensor) -> torch.Tensor:
        """(nH, N, N) f32 bias gathered from the table."""
        table = self.relative_position_bias_table.float()
        return table[rel_index].permute(2, 0, 1).contiguous()


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, dtype, generator):
        super().__init__()
        self.fc1 = Linear(dim, hidden, dtype=dtype, init="trunc_normal",
                          generator=generator)
        self.fc2 = Linear(hidden, dim, dtype=dtype, init="trunc_normal",
                          generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(gelu(self.fc1(x)))


class SwinTransformerBlock3D(nn.Module):
    def __init__(self, dim: int, num_heads: int, cfg: SwinConfig, dtype,
                 generator):
        super().__init__()
        self.norm1 = LayerNorm(dim, LN_EPS)
        self.attn = WindowAttention3D(dim, num_heads, cfg.window_size, dtype,
                                      generator)
        self.norm2 = LayerNorm(dim, LN_EPS)
        self.mlp = Mlp(dim, int(dim * cfg.mlp_ratio), dtype, generator)

    def kernel_weights(self, compute_dtype):
        """Block parameters in the kernel wrappers' argument order, less
        rel_bias / mask / dp; the weight matrices cast to the compute dtype
        (a differentiable cast: their gradients reach the masters)."""
        a, m = self.attn, self.mlp
        cd = lambda w: w.to(compute_dtype)  # noqa: E731
        return (self.norm1.weight, self.norm1.bias, cd(a.qkv.weight),
                a.qkv.bias, cd(a.proj.weight), a.proj.bias, self.norm2.weight,
                self.norm2.bias, cd(m.fc1.weight), m.fc1.bias,
                cd(m.fc2.weight), m.fc2.bias)


class PatchMerging(nn.Module):
    def __init__(self, dim: int, dtype, generator):
        super().__init__()
        self.norm = LayerNorm(4 * dim, LN_EPS)
        self.reduction = Linear(4 * dim, 2 * dim, bias=False, dtype=dtype,
                                init="trunc_normal", generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, D, H, W, C) -> (B, D, H/2, W/2, 2C), x0, x1, x2, x3 order."""
        _, _, h, w, _ = x.shape
        if h % 2 or w % 2:
            x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
        x = torch.cat([x[:, :, 0::2, 0::2], x[:, :, 1::2, 0::2],
                       x[:, :, 0::2, 1::2], x[:, :, 1::2, 1::2]], dim=-1)
        return self.reduction(self.norm(x))


def drop_path_multipliers(b: int, rate: float, generator: torch.Generator,
                          device) -> torch.Tensor:
    """(B,) f32 per-sample stochastic-depth multipliers: 1/keep with
    probability keep = 1 - rate, else 0."""
    keep = 1.0 - rate
    draw = torch.rand((b,), generator=generator, device=device)
    return (draw < keep).float() / keep


def drop_path(y: torch.Tensor, dp: Optional[torch.Tensor]) -> torch.Tensor:
    """y scaled per sample by dp (B,) in f32 and rounded; identity for None."""
    if dp is None:
        return y
    return (y.float() * dp.reshape((-1,) + (1,) * (y.ndim - 1))).to(y.dtype)


def window_attention(attn: WindowAttention3D, x: torch.Tensor, num_heads: int,
                     rel_index: torch.Tensor,
                     mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Windowed MHA with relative position bias, the plain route.
    x: (B*nW, N, C); mask: (nW, N, N) additive or None."""
    nb, n, c = x.shape
    hd = c // num_heads
    dt = x.dtype
    qkv = attn.qkv(x).reshape(nb, n, 3, num_heads, hd).permute(2, 0, 3, 1, 4)
    logits = torch.matmul(qkv[0].float(), qkv[1].float().transpose(-1, -2))
    logits = logits / math.sqrt(hd) + attn.rel_bias(rel_index)[None]
    if mask is not None:
        n_w = mask.shape[0]
        logits = (logits.reshape(nb // n_w, n_w, num_heads, n, n)
                  + mask[None, :, None]).reshape(nb, num_heads, n, n)
    weights = torch.softmax(logits, dim=-1).to(dt)
    ctx = torch.matmul(weights.float(), qkv[2].float()).to(dt)
    return attn.proj(ctx.transpose(1, 2).reshape(nb, n, c))


def swin_block(blk: SwinTransformerBlock3D, x: torch.Tensor, *, num_heads: int,
               window: Tuple[int, int, int], shift: Tuple[int, int, int],
               rel_index: torch.Tensor, mask: Optional[torch.Tensor],
               dp1: Optional[torch.Tensor] = None,
               dp2: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One Swin block, the plain route: LN1, pad to window multiples, roll
    by -shift, window attention, reverse, roll back, crop, residual, then
    LN2 + MLP + residual; dp1 / dp2 scale the two branches per sample."""
    b, d, h, w, c = x.shape
    pad_d = (window[0] - d % window[0]) % window[0]
    pad_h = (window[1] - h % window[1]) % window[1]
    pad_w = (window[2] - w % window[2]) % window[2]
    shifted = any(s > 0 for s in shift)
    y = blk.norm1(x)
    if pad_d or pad_h or pad_w:
        y = F.pad(y, (0, 0, 0, pad_w, 0, pad_h, 0, pad_d))
    if shifted:
        y = torch.roll(y, tuple(-s for s in shift), (1, 2, 3))
    attn = window_attention(blk.attn, window_partition(y, window), num_heads,
                            rel_index, mask)
    y = window_reverse(attn, window, b, d + pad_d, h + pad_h, w + pad_w)
    if shifted:
        y = torch.roll(y, tuple(shift), (1, 2, 3))
    if pad_d or pad_h or pad_w:
        y = y[:, :d, :h, :w].contiguous()
    x = x + drop_path(y, dp1)
    return x + drop_path(blk.mlp(blk.norm2(x)), dp2)


class BasicLayer(nn.Module):
    """One stage: depth blocks, alternating unshifted / shifted, then an
    optional PatchMerging."""

    def __init__(self, dim: int, depth: int, num_heads: int, cfg: SwinConfig,
                 downsample: bool, dtype, generator):
        super().__init__()
        if depth % 2:
            raise ValueError("Swin stage depths are even (W-MSA, SW-MSA pairs)")
        self.num_heads = num_heads
        self.window_size = tuple(cfg.window_size)
        self.blocks = nn.ModuleList(
            SwinTransformerBlock3D(dim, num_heads, cfg, dtype, generator)
            for _ in range(depth))
        self.downsample = (PatchMerging(dim, dtype, generator) if downsample
                           else None)

    def forward(self, x: torch.Tensor, use_kernels: bool,
                consts: "DeviceConstants",
                dp_rates: Optional[Sequence[float]] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """dp_rates: the blocks' drop-path rates in training, else None."""
        b, d, h, w, c = x.shape
        window, shift = get_window_size(
            (d, h, w), self.window_size, tuple(s // 2 for s in self.window_size))
        dims = tuple(-(-v // wv) * wv for v, wv in zip((d, h, w), window))
        n = window[0] * window[1] * window[2]
        rel_index = consts.rel_index(self.window_size, n, x.device)
        shifted = any(s > 0 for s in shift)
        mask = consts.shift_mask(dims, window, shift, x.device) if shifted else None
        aligned = dims == (d, h, w)
        # The route is chosen by shape before any launch, never by catching
        # a kernel's refusal: the kernels need window-aligned stages and a
        # width and a window that they take, windows of at most 448 tokens at
        # head_dim 16 or 32 (16-frame clips of Swin-B give N = 392 and
        # Swin-L at 384 N = 432, both on the kernels; a wider head dim, or
        # Swin-L's unclamped window of 1152 tokens, takes the plain block).
        kernels = use_kernels and aligned and window_kernels_supported(
            n, c, self.num_heads)
        # blocks wider than BLOCK_KERNEL_MAX_C run K2, then LN2 + MLP
        # through ``fused_ln_mlp``: K7 forward where K7 takes the width
        k7 = ln_mlp_supported(c, self.blocks[0].mlp.fc1.weight.shape[0])
        nwin = tuple(v // wv for v, wv in zip(dims, window))
        heads = self.num_heads
        window_heads = b * math.prod(nwin) * heads
        dt = x.dtype
        for j, blk in enumerate(self.blocks):
            s = shift if j % 2 else (0, 0, 0)
            m = mask if j % 2 else None
            trace.count_detail("attn.window_heads", window_heads)
            if n > ATTN_FWD_WIDE_TOKENS:
                trace.count_detail("attn.window_heads_big", window_heads)
            dp1 = dp2 = None
            if dp_rates is not None:
                dp1, dp2 = (drop_path_multipliers(b, dp_rates[j], generator,
                                                  x.device) for _ in range(2))
            if not kernels:
                x = swin_block(blk, x, num_heads=heads, window=window, shift=s,
                               rel_index=rel_index, mask=m, dp1=dp1, dp2=dp2)
                continue
            rel_bias = blk.attn.rel_bias(rel_index)
            mask5 = None if m is None else m.reshape(*nwin, n, n)
            wts = blk.kernel_weights(dt)
            if c <= BLOCK_KERNEL_MAX_C and m is None:
                x = fused_swin_block(x, *wts[:6], rel_bias, None, *wts[6:],
                                     dp1, dp2, window, heads, LN_EPS)
            elif c <= BLOCK_KERNEL_MAX_C:
                stk = [t.unsqueeze(0) for t in wts]
                one = (lambda t: None if t is None  # noqa: E731
                       else t.unsqueeze(0))
                x = fused_swin_pair(x, *stk[:6], rel_bias.unsqueeze(0), mask5,
                                    *stk[6:], one(dp1), one(dp2), window,
                                    heads, (s,), LN_EPS)
            else:
                # the JAX package's LRCE_TPU_LNMLP route: rolls around K2
                y = torch.roll(x, tuple(-v for v in s), (1, 2, 3)) if m is not None else x
                y = fused_window_attention_hsplit(y, *wts[:6], rel_bias, mask5,
                                                  window, heads, LN_EPS)
                if m is not None:
                    y = torch.roll(y, tuple(s), (1, 2, 3))
                x = fused_ln_mlp(x + drop_path(y, dp1), *wts[6:], dp2, LN_EPS)
                trace.count_detail("swin.wide_mlp_fused")
                if k7:
                    trace.count_detail("swin.wide_mlp_k7")
        if self.downsample is not None:
            x = self.downsample(x)
        return x


class DeviceConstants:
    """Relative-position indices and shift masks on the device, made once
    per geometry."""

    def __init__(self):
        self._cache: Dict[tuple, torch.Tensor] = {}

    def rel_index(self, full_window, n: int, device) -> torch.Tensor:
        key = ("rel", full_window, n, str(device))
        if key not in self._cache:
            idx = relative_position_index(tuple(full_window))[:n, :n]
            self._cache[key] = torch.from_numpy(np.ascontiguousarray(idx)).to(device)
        return self._cache[key]

    def shift_mask(self, dims, window, shift, device) -> torch.Tensor:
        key = ("mask", dims, window, shift, str(device))
        if key not in self._cache:
            self._cache[key] = torch.from_numpy(
                compute_shift_mask(dims, window, shift)).to(device)
        return self._cache[key]


class SwinTransformer3D(nn.Module):
    """(B, D, H, W, 3) channels-last video -> (B, D', H/32, W/32, 8*embed_dim)."""

    def __init__(self, cfg: SwinConfig = SWIN_BASE, *, dtype=torch.float32,
                 generator: torch.Generator, use_kernels: bool = True):
        """use_kernels: the kernel route."""
        super().__init__()
        self.cfg = cfg
        self.use_kernels = use_kernels
        self.consts = DeviceConstants()
        n_stages = len(cfg.depths)
        self.patch_embed = PatchEmbed3D(cfg, dtype, generator)
        self.layers = nn.ModuleList(
            BasicLayer(int(cfg.embed_dim * 2 ** i), cfg.depths[i],
                       cfg.num_heads[i], cfg, i < n_stages - 1, dtype,
                       generator)
            for i in range(n_stages))
        self.norm = LayerNorm(int(cfg.embed_dim * 2 ** (n_stages - 1)), LN_EPS)

    def forward(self, x: torch.Tensor, training: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """training: draw drop-path multipliers from ``generator``."""
        x = self.patch_embed(x)
        depths = self.cfg.depths
        rates = np.linspace(0, self.cfg.drop_path_rate, sum(depths)).tolist()
        offset = 0
        for i, (layer, depth) in enumerate(zip(self.layers, depths)):
            with trace.span(f"swin.s{i}"):
                x = layer(x, self.use_kernels, self.consts,
                          rates[offset:offset + depth] if training else None,
                          generator)
            offset += depth
        return self.norm(x)
