"""LRCE recurrent cross-modal fusion transformer and its task heads.

Counterpart of ``lrce_tpu/models/fusion.py``: 12 post-norm decoder layers
with torch.nn.TransformerDecoderLayer semantics (self-attention,
cross-attention, GELU feed-forward, LayerNorm eps 1e-12), folded over the
clips with a shared summarization token, and the open-ended,
multiple-choice and count heads. The JAX package's two ``lax.scan``s (over
layers and over clips) are plain Python loops here.

In training, dropout (``drop_out_rate``) runs where the JAX package has
it: both attentions' weights and outputs, the feed-forward hidden and
output, the token after each clip, and the head's embedded inputs.

Kept reference quirk: ``texts_attention_mask`` is accepted but never
applied inside the fusion.
"""

from __future__ import annotations

import copy
from typing import Optional, Sequence

import torch
from torch import nn

from lrce_tpu_torch.models.embedding import TextPosEmbed, VideoPosEmbed, xavier_normal
from lrce_tpu_torch.ops.nn import (LayerNorm, Linear, MultiheadAttention,
                                   dropout, gelu)
from lrce_tpu_torch.utils import trace
from lrce_tpu_torch.utils.graphs import GraphCache

LN_EPS = 1e-12
NUM_LAYERS = 12
NUM_HEADS = 12
DIM_FEEDFORWARD = 3072


class DecoderLayer(nn.Module):
    """x <- LN(x + SA(x)); x <- LN(x + CA(x, memory)); x <- LN(x + FFN(x))."""

    def __init__(self, dim: int, dtype, generator, dff: int = DIM_FEEDFORWARD):
        super().__init__()
        self.self_attn = MultiheadAttention(dim, NUM_HEADS, dtype=dtype,
                                            generator=generator)
        self.multihead_attn = MultiheadAttention(dim, NUM_HEADS, dtype=dtype,
                                                 generator=generator)
        self.linear1 = Linear(dim, dff, dtype=dtype, generator=generator)
        self.linear2 = Linear(dff, dim, dtype=dtype, generator=generator)
        self.norm1 = LayerNorm(dim, LN_EPS)
        self.norm2 = LayerNorm(dim, LN_EPS)
        self.norm3 = LayerNorm(dim, LN_EPS)

    def forward(self, tgt: torch.Tensor, memory: torch.Tensor,
                rate: float = 0.0, training: bool = False,
                generator=None) -> torch.Tensor:
        def drop(t):
            return dropout(t, rate, training, generator)

        kw = dict(dropout_rate=rate, training=training, generator=generator)
        x = self.norm1(tgt + drop(self.self_attn(tgt, tgt, tgt, **kw)))
        x = self.norm2(x + drop(self.multihead_attn(x, memory, memory, **kw)))
        h = drop(gelu(self.linear1(x)))
        return self.norm3(x + drop(self.linear2(h)))


class TransformerDecoder(nn.Module):
    def __init__(self, dim: int, dtype, generator):
        super().__init__()
        # torch's TransformerDecoder deep-copies one layer, so every layer
        # starts from the same weights; the JAX package does the same
        layer = DecoderLayer(dim, dtype, generator)
        self.layers = nn.ModuleList(copy.deepcopy(layer)
                                    for _ in range(NUM_LAYERS))


class FusionTransformer(nn.Module):
    def __init__(self, dim: int, dtype, generator):
        super().__init__()
        self.transformer = TransformerDecoder(dim, dtype, generator)
        self.fusion_layer_norm = LayerNorm(dim, LN_EPS)
        self.summarization_token = nn.Parameter(xavier_normal((1, 1, dim), generator))

    def forward(self, video: torch.Tensor, text: torch.Tensor,
                rate: float = 0.0, training: bool = False,
                generator=None) -> torch.Tensor:
        """video (B, n_clips, L_v, D), text (B, L_t, D) -> (B, 1, D): the
        token is folded over the clips."""
        b, n_clips, _, d = video.shape
        token = self.summarization_token.to(video.dtype).expand(b, 1, d)
        for i in range(n_clips):
            with trace.span("fusion.clip"):
                memory = torch.cat([video[:, i], text], dim=1)
                res = token
                for layer in self.transformer.layers:
                    res = layer(res, memory, rate, training, generator)
                token = self.fusion_layer_norm(token + res)
                token = dropout(token, rate, training, generator)
        return token


class LRCEHead(nn.Module):
    """The open-ended head; with num_classes = 1 it is also the
    multiple-choice (one score per QA pair) and count (ReLU regression)
    head, as in the reference."""

    def __init__(self, task_type: str, feature_dim: int, num_classes: int,
                 video_feature_res: Sequence[int], video_feature_dim: int,
                 frame_sample_size: int, temporal_scale: Sequence[int],
                 text_seq_len: int, dtype, generator,
                 dropout_rate: float = 0.1):
        super().__init__()
        if task_type not in ("oe", "mc", "count"):
            raise ValueError(f"Unsupported task type {task_type}")
        self.task_type = task_type
        self.dropout_rate = dropout_rate
        self.video_pos_embed = VideoPosEmbed(feature_dim, video_feature_res,
                                             frame_sample_size,
                                             sum(temporal_scale), generator)
        self.question_pos_embed = TextPosEmbed(text_seq_len, feature_dim, generator)
        self.fusion_transformer = FusionTransformer(feature_dim, dtype, generator)
        self.final_fc = Linear(feature_dim, 1 if task_type == "count" else num_classes,
                               dtype=dtype, generator=generator)
        self.projection_layer = (
            Linear(video_feature_dim, feature_dim, dtype=dtype, generator=generator)
            if video_feature_dim != feature_dim else None)
        self.graphs = GraphCache("fusion", train=True)

    def _embed(self, video, text, training, generator):
        with trace.span("fusion.embed"):
            if self.projection_layer is not None:
                video = self.projection_layer(video)
            rate = self.dropout_rate
            return (dropout(self.video_pos_embed(video), rate, training,
                            generator),
                    dropout(self.question_pos_embed(text), rate, training,
                            generator))

    def _head(self, token: torch.Tensor) -> torch.Tensor:
        with trace.span("fusion.head"):
            return self.final_fc(token[:, 0])

    def forward(self, video: torch.Tensor, text: torch.Tensor,
                texts_attention_mask: Optional[torch.Tensor] = None,
                training: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """video (B, n_clips, T, HW, Dv); text (B, L, D), or (B, M, L, D) for
        mc. Returns (B, num_classes) for oe, (B, M) for mc, (B,) for count.
        A no-grad call on the card replays ``_forward`` from a CUDA graph,
        and a training call its forward and backward from two
        (``utils/graphs.py``)."""
        del texts_attention_mask  # reference quirk: never applied
        return self.graphs(self, self._forward, (video, text), training,
                           generator)

    def _forward(self, video, text, training: bool = False,
                 generator=None) -> torch.Tensor:
        batch = video.shape[0]
        fuse = lambda v, t: self.fusion_transformer(  # noqa: E731
            v, t, self.dropout_rate, training, generator)
        if self.task_type == "mc":
            m = text.shape[1]
            video, text = self._embed(
                video, text.reshape((batch * m,) + text.shape[2:]), training,
                generator)
            video = video.repeat_interleave(m, dim=0)
            return self._head(fuse(video, text)).reshape(batch, m)
        video, text = self._embed(video, text, training, generator)
        out = self._head(fuse(video, text))
        if self.task_type == "count":
            return torch.relu(out.reshape(batch))
        return out.reshape(batch, -1)
