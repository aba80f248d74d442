"""The plain reference of an LRCE model: Video Swin 3D, BERT and the
recurrent fusion head, in float32 tensor code and nothing else.

It follows the published description (Video Swin Transformer,
arXiv:2106.13230; BERT, arXiv:1810.04805; LRCE's fusion decoder) and the
numerics of the program it judges only where they are part of the model:
LayerNorm eps 1e-5 in Swin and 1e-12 elsewhere, exact erf GELU, the shift
mask's additive -100, the relative-position index built over the
constructor window and sliced to (N, N), the additive finfo.min key mask of
BERT, and the reference quirk that the fusion never applies the question's
mask. It imports nothing of the program: the weights arrive as a dict of
tensors keyed by the program's state-dict names, made by the benchmark.

Dropout and drop-path draws are uniform numbers from a ``Drops`` source,
taken in the order in which the model consumes them. ``Numerics`` decides
how a matrix product rounds its operands: not at all (the reference), or to
float8 e4m3 with one scale a tensor (the control).
"""

from __future__ import annotations

import functools
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
SWIN_EPS = 1e-5
TEXT_EPS = 1e-12
FP8_MAX = 448.0

Params = Dict[str, torch.Tensor]


class Numerics:
    """How the operands of every matrix product are rounded. ``fp8``: each
    operand scaled by its absolute maximum over 448, rounded to float8 e4m3
    and scaled back; the gradient passes the rounding unchanged."""

    def __init__(self, fp8: bool = False):
        self.fp8 = fp8

    def q(self, x: torch.Tensor) -> torch.Tensor:
        if not self.fp8 or x.device.type == "meta":
            return x
        scale = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
        y = (x.detach() / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
        return x + (y - x).detach()

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.matmul(self.q(a), self.q(b))


class Drops:
    """Uniform [0, 1) draws for dropout and drop-path.

    ``record`` mode (a forward over meta tensors) notes the shape of every
    draw of a whole batch, in order. ``fill`` then draws them all from one
    generator, in that order, as the model would at that batch. A forward
    over the questions [q0, q1) of the batch then takes each draw's rows of
    those questions: ``per_q`` rows a question (the clips of a question for
    drop-path, one row otherwise)."""

    def __init__(self):
        self.shapes: List[Tuple[Tuple[int, ...], int]] = []
        self.draws: List[torch.Tensor] = []
        self.recording = True
        self.pos = 0
        self.rows = (0, 0)

    def fill(self, generator: torch.Generator, device) -> None:
        self.draws = [torch.rand(shape, generator=generator, device=device)
                      for shape, _ in self.shapes]
        self.recording = False

    def select(self, q0: int, q1: int) -> None:
        self.rows = (q0, q1)
        self.pos = 0

    def rand(self, shape: Sequence[int], per_q: int) -> torch.Tensor:
        if self.recording:
            self.shapes.append((tuple(shape), per_q))
            return torch.empty(tuple(shape), device="meta")
        draw = self.draws[self.pos]
        self.pos += 1
        q0, q1 = self.rows
        out = draw[q0 * per_q:q1 * per_q]
        if tuple(out.shape) != tuple(shape):
            raise RuntimeError(f"draw {self.pos - 1}: recorded "
                               f"{tuple(draw.shape)}, taken as {tuple(shape)}")
        return out


def dropout(x, rate: float, drops: Optional[Drops], per_q: int = 1):
    if drops is None or rate == 0.0:
        return x
    keep = 1.0 - rate
    draw = drops.rand(x.shape, per_q)
    return torch.where(draw < keep, x / keep, torch.zeros_like(x))


def dense(nm: Numerics, x, w, b=None):
    y = nm.mm(x, w.t())
    return y if b is None else y + b


def layer_norm(x, w, b, eps: float):
    mean = x.mean(-1, keepdim=True)
    d = x - mean
    var = (d * d).mean(-1, keepdim=True)
    return d * torch.rsqrt(var + eps) * w + b


def gelu(x):
    return x * 0.5 * (1.0 + torch.erf(x / math.sqrt(2.0)))


def ln(P: Params, prefix: str, x, eps: float):
    return layer_norm(x, P[prefix + ".weight"], P[prefix + ".bias"], eps)


def lin(nm: Numerics, P: Params, prefix: str, x):
    return dense(nm, x, P[prefix + ".weight"], P.get(prefix + ".bias"))


# ---------------------------------------------------------------- Video Swin

@functools.lru_cache(maxsize=None)
def relative_position_index(window) -> np.ndarray:
    wd, wh, ww = window
    coords = np.stack(np.meshgrid(np.arange(wd), np.arange(wh), np.arange(ww),
                                  indexing="ij")).reshape(3, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0)
    rel = rel.astype(np.int64)
    rel[:, :, 0] += wd - 1
    rel[:, :, 1] += wh - 1
    rel[:, :, 2] += ww - 1
    rel[:, :, 0] *= (2 * wh - 1) * (2 * ww - 1)
    rel[:, :, 1] *= 2 * ww - 1
    return rel.sum(-1)


@functools.lru_cache(maxsize=None)
def shift_mask(dims, window, shift) -> np.ndarray:
    """Additive (nW, N, N) mask of shifted windows: -100 between tokens of
    different regions."""
    img = np.zeros(dims, np.int32)
    cnt = 0
    for d in (slice(-window[0]), slice(-window[0], -shift[0] or None),
              slice(-shift[0] or dims[0], None)):
        for h in (slice(-window[1]), slice(-window[1], -shift[1] or None),
                  slice(-shift[1] or dims[1], None)):
            for w in (slice(-window[2]), slice(-window[2], -shift[2] or None),
                      slice(-shift[2] or dims[2], None)):
                img[d, h, w] = cnt
                cnt += 1
    n = [v // wv for v, wv in zip(dims, window)]
    win = img.reshape(n[0], window[0], n[1], window[1], n[2], window[2])
    win = win.transpose(0, 2, 4, 1, 3, 5).reshape(-1, int(np.prod(window)))
    diff = win[:, None, :] - win[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


def partition(x, window):
    b, d, h, w, c = x.shape
    x = x.reshape(b, d // window[0], window[0], h // window[1], window[1],
                  w // window[2], window[2], c)
    return x.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(-1, math.prod(window), c)


def unpartition(x, window, b, d, h, w):
    c = x.shape[-1]
    x = x.reshape(b, d // window[0], h // window[1], w // window[2],
                  window[0], window[1], window[2], c)
    return x.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(b, d, h, w, c)


def swin_block(nm, P, pre, x, heads, window, shift, full_window, mask, dp1,
               dp2):
    b, d, h, w, c = x.shape
    pads = [(wv - v % wv) % wv for v, wv in zip((d, h, w), window)]
    y = ln(P, pre + ".norm1", x, SWIN_EPS)
    if any(pads):
        y = F.pad(y, (0, 0, 0, pads[2], 0, pads[1], 0, pads[0]))
    shifted = any(shift)
    if shifted:
        y = torch.roll(y, tuple(-s for s in shift), (1, 2, 3))
    win = partition(y, window)
    nb, n, _ = win.shape
    hd = c // heads
    qkv = lin(nm, P, pre + ".attn.qkv", win).reshape(nb, n, 3, heads, hd)
    qkv = qkv.permute(2, 0, 3, 1, 4)
    idx = torch.from_numpy(np.ascontiguousarray(
        relative_position_index(full_window)[:n, :n])).to(x.device)
    table = P[pre + ".attn.relative_position_bias_table"]
    bias = table[idx].permute(2, 0, 1)
    logits = nm.mm(qkv[0], qkv[1].transpose(-1, -2)) / math.sqrt(hd) + bias
    if mask is not None:
        nw = mask.shape[0]
        logits = (logits.reshape(nb // nw, nw, heads, n, n)
                  + mask[None, :, None]).reshape(nb, heads, n, n)
    ctx = nm.mm(torch.softmax(logits, -1), qkv[2])
    attn = lin(nm, P, pre + ".attn.proj",
               ctx.transpose(1, 2).reshape(nb, n, c))
    dims = [v + p for v, p in zip((d, h, w), pads)]
    y = unpartition(attn, window, b, *dims)
    if shifted:
        y = torch.roll(y, tuple(shift), (1, 2, 3))
    y = y[:, :d, :h, :w]
    x = x + y * dp1.reshape(-1, 1, 1, 1, 1)
    hid = gelu(lin(nm, P, pre + ".mlp.fc1", ln(P, pre + ".norm2", x,
                                                SWIN_EPS)))
    return x + lin(nm, P, pre + ".mlp.fc2", hid) * dp2.reshape(-1, 1, 1, 1, 1)


def swin(nm: Numerics, P: Params, cfg: dict, x, drops: Optional[Drops],
         n_clips: int):
    """(B, D, H, W, 3) normalized clips -> (B, D', H/32, W/32, 8 C)."""
    pre = "video_extractor.swin"
    patch = tuple(cfg["patch_size"])
    _, d, h, w, _ = x.shape
    pads = [(p - v % p) % p for v, p in zip((d, h, w), patch)]
    if any(pads):
        x = F.pad(x, (0, 0, 0, pads[2], 0, pads[1], 0, pads[0]))
    wt = nm.q(P[pre + ".patch_embed.proj.weight"])
    y = F.conv3d(nm.q(x).permute(0, 4, 1, 2, 3), wt, stride=patch)
    y = y.permute(0, 2, 3, 4, 1) + P[pre + ".patch_embed.proj.bias"]
    x = ln(P, pre + ".patch_embed.norm", y, SWIN_EPS)
    depths = cfg["depths"]
    rates = np.linspace(0, cfg["drop_path_rate"], sum(depths)).tolist()
    full = tuple(cfg["window_size"])
    k = 0
    for i, depth in enumerate(depths):
        b, d, h, w, c = x.shape
        window, shift = list(full), [s // 2 for s in full]
        for a, v in enumerate((d, h, w)):
            if v <= full[a]:
                window[a], shift[a] = v, 0
        window, shift = tuple(window), tuple(shift)
        dims = tuple(-(-v // wv) * wv for v, wv in zip((d, h, w), window))
        mask = None
        if any(shift):
            mask = torch.from_numpy(shift_mask(dims, window, shift)).to(
                x.device)
        for j in range(depth):
            dp = []
            for _ in range(2):
                if drops is None:
                    dp.append(torch.ones(b, device=x.device))
                    continue
                keep = 1.0 - rates[k + j]
                dp.append((drops.rand((b,), n_clips) < keep).float() / keep)
            odd = j % 2 == 1
            x = swin_block(nm, P, f"{pre}.layers.{i}.blocks.{j}", x,
                           cfg["num_heads"][i], window,
                           shift if odd else (0, 0, 0), full,
                           mask if odd else None, *dp)
        k += depth
        if i < len(depths) - 1:
            if h % 2 or w % 2:
                x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
            x = torch.cat([x[:, :, 0::2, 0::2], x[:, :, 1::2, 0::2],
                           x[:, :, 0::2, 1::2], x[:, :, 1::2, 1::2]], -1)
            dn = f"{pre}.layers.{i}.downsample"
            x = lin(nm, P, dn + ".reduction", ln(P, dn + ".norm", x,
                                                  SWIN_EPS))
    return ln(P, pre + ".norm", x, SWIN_EPS)


# ---------------------------------------------------------------------- BERT

def bert(nm: Numerics, P: Params, cfg: dict, ids, mask, types,
         drops: Optional[Drops]):
    pre = "text_extractor.bert"
    b, s = ids.shape
    rate, arate = cfg["hidden_dropout"], cfg["attention_dropout"]
    e = pre + ".embeddings"
    x = (P[e + ".word_embeddings.weight"][ids]
         + P[e + ".position_embeddings.weight"][:s][None]
         + P[e + ".token_type_embeddings.weight"][types])
    x = dropout(ln(P, e + ".LayerNorm", x, TEXT_EPS), rate, drops)
    bias = (1.0 - mask.float())[:, None, None, :] * torch.finfo(
        torch.float32).min
    heads = cfg["num_heads"]
    d = cfg["hidden_size"]
    hd = d // heads
    for i in range(cfg["num_layers"]):
        L = f"{pre}.encoder.layer.{i}"

        def split(t):
            return t.reshape(b, s, heads, hd).transpose(1, 2)

        q, k, v = (split(lin(nm, P, f"{L}.attention.self.{n}", x))
                   for n in ("query", "key", "value"))
        logits = nm.mm(q, k.transpose(-1, -2)) / math.sqrt(hd) + bias
        wts = dropout(torch.softmax(logits, -1), arate, drops)
        ctx = nm.mm(wts, v).transpose(1, 2).reshape(b, s, d)
        out = dropout(lin(nm, P, f"{L}.attention.output.dense", ctx), rate,
                      drops)
        x = ln(P, f"{L}.attention.output.LayerNorm", x + out, TEXT_EPS)
        hid = gelu(lin(nm, P, f"{L}.intermediate.dense", x))
        out = dropout(lin(nm, P, f"{L}.output.dense", hid), rate, drops)
        x = ln(P, f"{L}.output.LayerNorm", x + out, TEXT_EPS)
    return x


# -------------------------------------------------------------------- fusion

def mha(nm, P, pre, query, kv, heads, rate, drops):
    w, bias = P[pre + ".in_proj_weight"], P[pre + ".in_proj_bias"]
    d = w.shape[0] // 3
    hd = d // heads

    def split(t):
        return t.reshape(t.shape[0], t.shape[1], heads, hd).transpose(1, 2)

    q = split(dense(nm, query, w[:d], bias[:d]))
    k = split(dense(nm, kv, w[d:2 * d], bias[d:2 * d]))
    v = split(dense(nm, kv, w[2 * d:], bias[2 * d:]))
    logits = nm.mm(q, k.transpose(-1, -2)) / math.sqrt(hd)
    wts = dropout(torch.softmax(logits, -1), rate, drops)
    ctx = nm.mm(wts, v)
    b, _, s, _ = ctx.shape
    return lin(nm, P, pre + ".out_proj", ctx.transpose(1, 2).reshape(b, s, d))


def fusion(nm: Numerics, P: Params, cfg: dict, video, text,
           drops: Optional[Drops]):
    """video (B, n_clips, T, HW, Dv), text (B, L, D) -> (B, num_classes)."""
    pre = "fusion_model"
    rate = cfg["drop_out_rate"]
    heads = cfg["fusion"]["num_heads"]
    if pre + ".projection_layer.weight" in P:
        video = lin(nm, P, pre + ".projection_layer", video)
    b, n, t, hw, d = video.shape
    vp = pre + ".video_pos_embed"
    x = torch.cat([P[vp + ".emb_cls"].expand(b, n, t, 1, d), video], 3)
    x = x + P[vp + ".emb_pos"] + P[vp + ".emb_len"] + P[vp + ".emb_clip"]
    video = dropout(ln(P, vp + ".layer_norm", x, TEXT_EPS).reshape(
        b, n, t * (1 + hw), d), rate, drops)
    qp = pre + ".question_pos_embed"
    x = torch.cat([P[qp + ".emb_cls"].expand(b, 1, d), text], 1)
    text = dropout(ln(P, qp + ".layer_norm", x + P[qp + ".emb_pos"],
                      TEXT_EPS), rate, drops)
    ft = pre + ".fusion_transformer"
    token = P[ft + ".summarization_token"].expand(b, 1, d)
    for i in range(n):
        memory = torch.cat([video[:, i], text], 1)
        res = token
        for j in range(cfg["fusion"]["num_layers"]):
            L = f"{ft}.transformer.layers.{j}"
            sa = mha(nm, P, L + ".self_attn", res, res, heads, rate, drops)
            res = ln(P, L + ".norm1", res + dropout(sa, rate, drops),
                     TEXT_EPS)
            ca = mha(nm, P, L + ".multihead_attn", res, memory, heads, rate,
                     drops)
            res = ln(P, L + ".norm2", res + dropout(ca, rate, drops),
                     TEXT_EPS)
            hid = dropout(gelu(lin(nm, P, L + ".linear1", res)), rate, drops)
            res = ln(P, L + ".norm3",
                     res + dropout(lin(nm, P, L + ".linear2", hid), rate,
                                   drops), TEXT_EPS)
        token = dropout(ln(P, ft + ".fusion_layer_norm", token + res,
                           TEXT_EPS), rate, drops)
    return lin(nm, P, pre + ".final_fc", token[:, 0]).reshape(b, -1)


def forward(nm: Numerics, P: Params, cfg: dict, clips, ids, mask, types,
            drops: Optional[Drops] = None):
    """uint8 clips (B, n_clips, T, H, W, 3) and question tokens (B, L) ->
    open-ended logits (B, num_classes), in float32."""
    b, n, t, h, w, c = clips.shape
    x = clips.float() / 255.0
    mean = torch.tensor(IMAGENET_MEAN, device=x.device)
    std = torch.tensor(IMAGENET_STD, device=x.device)
    x = ((x - mean) / std).reshape(b * n, t, h, w, c)
    feats = swin(nm, P, cfg["swin"], x, drops, n)
    _, tp, hp, wp, cv = feats.shape
    video = feats.reshape(b, n, tp, hp * wp, cv)
    text = bert(nm, P, cfg["bert"], ids, mask, types, drops)
    return fusion(nm, P, cfg, video, text, drops)
