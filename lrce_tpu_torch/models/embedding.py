"""Positional embeddings for the LRCE fusion inputs.

Counterpart of ``lrce_tpu/models/embedding.py``: a learned CLS + position
embedding for the question, and a four-part video embedding (CLS per clip
and temporal position, spatial position, temporal position within the clip,
clip index) followed by LayerNorm (eps 1e-12) and a flatten to
(B, n_clips, T*(1+HW), D). Parameters stay f32 and are cast to the
activation dtype at use, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from lrce_tpu_torch.ops.nn import LayerNorm

LN_EPS = 1e-12


def xavier_normal(shape, generator: torch.Generator) -> torch.Tensor:
    """torch.nn.init.xavier_normal_ fans for a >= 2-D shape."""
    receptive = math.prod(shape[2:])
    std = math.sqrt(2.0 / (shape[1] * receptive + shape[0] * receptive))
    return std * torch.randn(shape, generator=generator)


class TextPosEmbed(nn.Module):
    def __init__(self, seq_len: int, dim: int, generator: torch.Generator):
        super().__init__()
        self.emb_cls = nn.Parameter(xavier_normal((1, 1, dim), generator))
        self.emb_pos = nn.Parameter(xavier_normal((1, 1 + seq_len, dim), generator))
        self.layer_norm = LayerNorm(dim, LN_EPS)

    def forward(self, text: torch.Tensor) -> torch.Tensor:
        """(B, L, D) -> (B, 1+L, D): prepend CLS, add positions, LayerNorm."""
        b, _, d = text.shape
        cls = self.emb_cls.to(text.dtype).expand(b, 1, d)
        x = torch.cat([cls, text], dim=1) + self.emb_pos.to(text.dtype)
        return self.layer_norm(x)


class VideoPosEmbed(nn.Module):
    def __init__(self, dim: int, video_feature_res: Sequence[int],
                 frame_sample_size: int, clip_size: int,
                 generator: torch.Generator):
        super().__init__()
        hw = video_feature_res[0] * video_feature_res[1]
        t = (frame_sample_size + 1) // 2
        self.emb_cls = nn.Parameter(xavier_normal((1, 1, 1, 1, dim), generator))
        self.emb_pos = nn.Parameter(xavier_normal((1, 1, 1, 1 + hw, dim), generator))
        self.emb_len = nn.Parameter(xavier_normal((1, 1, t, 1, dim), generator))
        self.emb_clip = nn.Parameter(xavier_normal((1, clip_size, 1, 1, dim), generator))
        self.layer_norm = LayerNorm(dim, LN_EPS)

    def forward(self, video: torch.Tensor) -> torch.Tensor:
        """(B, n_clips, T, HW, D) -> (B, n_clips, T*(1+HW), D)."""
        b, s, t, hw, d = video.shape
        dt = video.dtype
        cls = self.emb_cls.to(dt).expand(b, s, t, 1, d)
        x = torch.cat([cls, video], dim=3)
        x = x + self.emb_pos.to(dt)
        x = x + self.emb_len.to(dt)
        x = x + self.emb_clip.to(dt)
        return self.layer_norm(x).reshape(b, s, t * (1 + hw), d)
