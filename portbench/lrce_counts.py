"""Operations and bytes of an LRCE model's work, from the configuration's
shapes alone, whatever code does the work.

A piece is one unit of the model's work for a whole batch: its matrix
products' operations (two a multiply-add: the projections, the attention's
two products, the MLPs, the patch embedding, the merging reductions, the
text tower and the fusion), and the elements it must read and write once:
its input and output activations and its weights, read once a call.
Activations and weights move in bfloat16; weight gradients are written in
float32. A backward piece does twice its forward's products (the input's
and the weights' gradients) except the patch embedding, whose input is data
and takes no gradient; it reads the input, the output's gradient and the
weights, and writes the input's gradient and the weights' gradient.
Nothing recomputed is counted.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple

ACT = 2     # bytes of a bfloat16 activation or weight
GRAD = 4    # bytes of a float32 weight gradient


class Piece(NamedTuple):
    part: str       # "swin", "bert" or "fusion"
    name: str
    flops: float
    act_in: int     # elements read
    act_out: int    # elements written
    weights: int    # parameters read

    @property
    def bytes(self) -> float:
        return ACT * (self.act_in + self.act_out + self.weights)


def _stages(config: dict):
    """(stage, depth, channels, padded tokens, tokens, window tokens) of a
    clip at each Swin stage."""
    sw = config["swin"]
    pd, ph, pw = sw["patch_size"]
    dims = (-(-config["frame_sample_size"] // pd),
            -(-config["frame_size"] // ph), -(-config["frame_size"] // pw))
    c = sw["embed_dim"]
    for i, depth in enumerate(sw["depths"]):
        window = tuple(min(v, wv) for v, wv in zip(dims, sw["window_size"]))
        padded = tuple(-(-v // wv) * wv for v, wv in zip(dims, window))
        yield i, depth, c, math.prod(padded), math.prod(dims), \
            math.prod(window)
        dims = (dims[0], -(-dims[1] // 2), -(-dims[2] // 2))
        c *= 2


def swin_forward(config: dict, clips: int) -> List[Piece]:
    sw = config["swin"]
    pd, ph, pw = sw["patch_size"]
    f = config["frame_size"]
    t0 = (-(-config["frame_sample_size"] // pd)) * (-(-f // ph)) * (-(-f // pw))
    k = 3 * pd * ph * pw
    e = sw["embed_dim"]
    frames = config["frame_sample_size"] * f * f * 3
    out = [Piece("swin", "patch_embed", 2.0 * clips * t0 * k * e,
                 clips * frames, clips * t0 * e, k * e)]
    last = len(sw["depths"]) - 1
    for i, depth, c, tp, tok, n in _stages(config):
        hid = int(c * sw["mlp_ratio"])
        act = clips * tok * c
        attn = 2.0 * clips * tp * (3 * c * c + 2 * n * c + c * c)
        mlp = 2.0 * clips * tok * 2 * c * hid
        for j in range(depth):
            out.append(Piece("swin", f"s{i}.b{j}.attn", attn, act, act,
                             4 * c * c))
            out.append(Piece("swin", f"s{i}.b{j}.mlp", mlp, act, act,
                             2 * c * hid))
        if i < last:
            out.append(Piece("swin", f"s{i}.merge",
                             2.0 * clips * (tok // 4) * 4 * c * 2 * c,
                             act, act // 2, 8 * c * c))
    return out


def text_fusion_forward(config: dict, questions: int) -> List[Piece]:
    bt = config["bert"]
    d, L = bt["hidden_size"], config["text_seq_len"]
    ff = bt["intermediate_size"]
    out = [Piece("bert", f"layer{i}",
                 questions * (2.0 * L * d * (4 * d + 2 * ff) + 4.0 * L * L * d),
                 questions * L * d, questions * L * d, 4 * d * d + 2 * d * ff)
           for i in range(bt["num_layers"])]
    fu = config["fusion"]
    fd, dff = config["feature_dim"], fu["dim_feedforward"]
    n_clips = sum(config["temporal_scale"])
    tp = -(-config["frame_sample_size"] // config["swin"]["patch_size"][0])
    hw = math.prod(config["video_feature_res"])
    mem = tp * (1 + hw) + 1 + L
    dv = config["video_feature_dim"]
    rows = questions * n_clips * tp * hw
    if dv != fd:
        out.append(Piece("fusion", "projection", 2.0 * rows * dv * fd,
                         rows * dv, rows * fd, dv * fd))
    per = (8 * fd * fd + 4 * fd                          # self-attention
           + 4 * fd * fd + 4 * mem * fd * fd + 4 * mem * fd  # cross
           + 4 * fd * dff)                               # feed-forward
    for i in range(fu["num_layers"]):
        out.append(Piece("fusion", f"layer{i}", 1.0 * questions * n_clips * per,
                         questions * n_clips * (mem + 1) * fd,
                         questions * n_clips * fd,
                         8 * fd * fd + 2 * fd * dff))
    out.append(Piece("fusion", "final_fc",
                     2.0 * questions * fd * config["num_classes"],
                     questions * fd, questions * config["num_classes"],
                     fd * config["num_classes"]))
    return out


def backward(pieces: List[Piece]) -> List[Piece]:
    """The backward of forward pieces (module docstring)."""
    out = []
    for p in pieces:
        first = p.name == "patch_embed"
        dx = 0 if first else p.act_in
        out.append(Piece(p.part, p.name + ".bwd",
                         p.flops * (1 if first else 2),
                         p.act_in + p.act_out, dx,
                         p.weights + p.weights * GRAD // ACT))
    return out


def pieces(config: dict, questions: int, train: bool) -> List[Piece]:
    """Every piece of one training step (forward and backward), or of one
    forward, over ``questions`` questions."""
    fwd = (swin_forward(config, questions * sum(config["temporal_scale"]))
           + text_fusion_forward(config, questions))
    return fwd + backward(fwd) if train else fwd
