"""BERT-base text encoder with HuggingFace numerics, eval and training
forward.

Counterpart of ``lrce_tpu/models/bert.py``: post-norm layers, LayerNorm eps
1e-12, exact GELU, the additive (1 - mask) * finfo.min attention mask,
written with plain matmul and softmax. In training, dropout runs where the
JAX package has it: the embeddings, the attention weights, the attention
output and the feed-forward output, drawn from the caller's generator. Module and parameter names are
HuggingFace ``BertModel``'s, so ``state_dict()`` is the reference
``text_extractor.bert.*`` checkpoint.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
from torch import nn

from lrce_tpu_torch.ops.nn import LayerNorm, Linear, dropout, gelu

LN_EPS = 1e-12


class BertConfig(NamedTuple):
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1


BERT_BASE = BertConfig()


def _embedding(n: int, d: int, generator) -> nn.Embedding:
    emb = nn.Embedding(n, d)
    with torch.no_grad():
        emb.weight.copy_(0.02 * torch.randn((n, d), generator=generator))
    return emb


class BertEmbeddings(nn.Module):
    def __init__(self, cfg: BertConfig, generator):
        super().__init__()
        self.word_embeddings = _embedding(cfg.vocab_size, cfg.hidden_size, generator)
        self.position_embeddings = _embedding(cfg.max_position_embeddings,
                                              cfg.hidden_size, generator)
        self.token_type_embeddings = _embedding(cfg.type_vocab_size,
                                                cfg.hidden_size, generator)
        self.LayerNorm = LayerNorm(cfg.hidden_size, LN_EPS)

    def forward(self, input_ids, token_type_ids):
        s = input_ids.shape[1]
        x = self.word_embeddings(input_ids)
        x = x + self.position_embeddings.weight[:s][None]
        return self.LayerNorm(x + self.token_type_embeddings(token_type_ids))


def _linear(i, o, dtype, generator):
    return Linear(i, o, dtype=dtype, init="trunc_normal", generator=generator)


class BertSelfAttention(nn.Module):
    def __init__(self, cfg: BertConfig, dtype, generator):
        super().__init__()
        d = cfg.hidden_size
        self.num_heads = cfg.num_heads
        self.attention_dropout = cfg.attention_dropout
        self.query = _linear(d, d, dtype, generator)
        self.key = _linear(d, d, dtype, generator)
        self.value = _linear(d, d, dtype, generator)

    def forward(self, x: torch.Tensor, bias: torch.Tensor,
                training: bool = False, generator=None) -> torch.Tensor:
        b, s, d = x.shape
        hd = d // self.num_heads

        def heads(t):
            return t.reshape(b, s, self.num_heads, hd).transpose(1, 2)

        q, k, v = heads(self.query(x)), heads(self.key(x)), heads(self.value(x))
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
        logits = logits / math.sqrt(hd) + bias
        weights = dropout(torch.softmax(logits, dim=-1),
                          self.attention_dropout, training, generator)
        ctx = torch.matmul(weights.to(x.dtype).float(), v.float()).to(x.dtype)
        return ctx.transpose(1, 2).reshape(b, s, d)


class BertSelfOutput(nn.Module):
    def __init__(self, cfg: BertConfig, dtype, generator):
        super().__init__()
        self.dense = _linear(cfg.hidden_size, cfg.hidden_size, dtype, generator)
        self.LayerNorm = LayerNorm(cfg.hidden_size, LN_EPS)


class BertAttention(nn.Module):
    def __init__(self, cfg: BertConfig, dtype, generator):
        super().__init__()
        self.self = BertSelfAttention(cfg, dtype, generator)
        self.output = BertSelfOutput(cfg, dtype, generator)

    def forward(self, x, bias, rate: float = 0.0, training: bool = False,
                generator=None):
        out = self.output.dense(self.self(x, bias, training, generator))
        out = dropout(out, rate, training, generator)
        return self.output.LayerNorm(x + out)


class BertIntermediate(nn.Module):
    def __init__(self, cfg: BertConfig, dtype, generator):
        super().__init__()
        self.dense = _linear(cfg.hidden_size, cfg.intermediate_size, dtype,
                             generator)


class BertOutput(nn.Module):
    def __init__(self, cfg: BertConfig, dtype, generator):
        super().__init__()
        self.dense = _linear(cfg.intermediate_size, cfg.hidden_size, dtype,
                             generator)
        self.LayerNorm = LayerNorm(cfg.hidden_size, LN_EPS)


class BertLayer(nn.Module):
    def __init__(self, cfg: BertConfig, dtype, generator):
        super().__init__()
        self.attention = BertAttention(cfg, dtype, generator)
        self.intermediate = BertIntermediate(cfg, dtype, generator)
        self.output = BertOutput(cfg, dtype, generator)

    def forward(self, x, bias, rate: float = 0.0, training: bool = False,
                generator=None):
        x = self.attention(x, bias, rate, training, generator)
        h = gelu(self.intermediate.dense(x))
        h = dropout(self.output.dense(h), rate, training, generator)
        return self.output.LayerNorm(x + h)


class BertEncoder(nn.Module):
    def __init__(self, cfg: BertConfig, dtype, generator):
        super().__init__()
        self.layer = nn.ModuleList(BertLayer(cfg, dtype, generator)
                                   for _ in range(cfg.num_layers))


class BertPooler(nn.Module):
    """Kept so the state dict is a whole BertModel checkpoint; the LRCE
    forward does not use the pooler."""

    def __init__(self, cfg: BertConfig, dtype, generator):
        super().__init__()
        self.dense = _linear(cfg.hidden_size, cfg.hidden_size, dtype, generator)


class BertModel(nn.Module):
    def __init__(self, cfg: BertConfig = BERT_BASE, *, dtype=torch.float32,
                 generator: torch.Generator, compute_dtype=None):
        super().__init__()
        self.cfg = cfg
        self.dtype = compute_dtype or dtype   # the layers' activation dtype
        self.embeddings = BertEmbeddings(cfg, generator)
        self.encoder = BertEncoder(cfg, dtype, generator)
        self.pooler = BertPooler(cfg, dtype, generator)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                token_type_ids: Optional[torch.Tensor] = None,
                training: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(B, L) token ids -> (B, L, hidden) last hidden state. The
        embeddings are f32; the layers run in the compute dtype."""
        b, s = input_ids.shape
        rate = self.cfg.hidden_dropout
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        x = self.embeddings(input_ids, token_type_ids)
        x = dropout(x, rate, training, generator).to(self.dtype)
        if attention_mask is None:
            bias = torch.zeros((b, 1, 1, s), device=x.device)
        else:
            bias = (1.0 - attention_mask.float())[:, None, None, :]
            bias = bias * torch.finfo(torch.float32).min
        for layer in self.encoder.layer:
            x = layer(x, bias, rate, training, generator)
        return x
