"""What a run feeds the program and the reference, made from ``--seed``.

- Weights: one draw of standard normals for every parameter at once, on
  the device, from a generator seeded by the run's seed; each parameter
  takes its slice, scaled: LayerNorm gains 1 + 0.02 z, biases 0.02 z,
  everything else (matrices, convolutions, embeddings, tables, tokens)
  0.02 z. The same seed gives the same weights, so the reference makes them
  again after the window instead of keeping a copy.
- Clips: uint8 bytes from one pool in host memory, made on the device from
  the seed and copied to the host once; a batch or a request takes its
  bytes at an offset drawn from the seed, so no two rows are alike.
- Questions: [CLS] words [SEP] and padding, of a length drawn between the
  traffic's bounds, with its attention mask; labels below the class count.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, NamedTuple, Tuple

import numpy as np
import torch

WEIGHT_STD = 0.02
POOL_EXTRA = 64 << 20   # bytes past a batch's, where its offset is drawn


def sub_seed(seed: int, *tags: int) -> int:
    """A 63-bit seed for one use of the run's seed (weights 1, clip pool 2,
    dropout 4, the questions of requests 5, of rank r's batches 10 + r)."""
    ss = np.random.SeedSequence([seed % 2**64, *tags])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def _is_gain(name: str, shape) -> bool:
    module = name.rsplit(".", 1)[0].rsplit(".", 1)[-1].lower()
    return (len(shape) == 1 and name.endswith(".weight")
            and "norm" in module)


def make_weights(shapes: Iterable[Tuple[str, torch.Size]], seed: int,
                 device) -> Dict[str, torch.Tensor]:
    """Float32 weights for ``(name, shape)`` pairs, in that order."""
    shapes = list(shapes)
    total = sum(math.prod(s) for _, s in shapes)
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 1))
    flat = torch.randn(total, generator=gen, device=device)
    flat.mul_(WEIGHT_STD)
    out, offset = {}, 0
    for name, shape in shapes:
        n = math.prod(shape)
        t = flat[offset:offset + n].view(shape)
        if _is_gain(name, shape):
            t.add_(1.0)
        out[name] = t
        offset += n
    return out


def make_clip_pool(nbytes: int, seed: int, device) -> np.ndarray:
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 2))
    pool = torch.randint(0, 256, (nbytes,), generator=gen, device=device,
                         dtype=torch.uint8)
    return pool.cpu().numpy()


class Question(NamedTuple):
    ids: np.ndarray      # (L,) int64
    mask: np.ndarray     # (L,) int64
    label: int


def make_question(rng: np.random.Generator, tokens: dict, seq_len: int,
                  lengths: Tuple[int, int], num_classes: int) -> Question:
    n = int(rng.integers(lengths[0], lengths[1] + 1))
    ids = np.full(seq_len, tokens["pad"], np.int64)
    ids[0], ids[n - 1] = tokens["cls"], tokens["sep"]
    ids[1:n - 1] = rng.integers(tokens["words"][0], tokens["words"][1],
                                n - 2)
    mask = np.zeros(seq_len, np.int64)
    mask[:n] = 1
    return Question(ids, mask, int(rng.integers(0, num_classes)))


class Feed:
    """Batches or requests of one run: clip bytes from a pool at seeded
    offsets, questions from a seeded generator, in a fixed order."""

    def __init__(self, config: dict, traffic: dict, questions: int, seed: int,
                 tag: int, device):
        self.config = config
        self.traffic = traffic
        self.questions = questions
        n_clips = sum(config["temporal_scale"])
        f = config["frame_size"]
        self.clip_shape = (questions, n_clips, config["frame_sample_size"],
                           f, f, 3)
        self.nbytes = math.prod(self.clip_shape)
        self.pool = make_clip_pool(self.nbytes + POOL_EXTRA, seed, device)
        self.rng = np.random.default_rng(sub_seed(seed, tag))

    def next(self) -> Tuple[np.ndarray, ...]:
        """(clips uint8, ids, mask, types, labels) in host memory."""
        off = int(self.rng.integers(0, POOL_EXTRA + 1))
        clips = self.pool[off:off + self.nbytes].reshape(self.clip_shape)
        qs: List[Question] = [
            make_question(self.rng, self.config["token_ids"],
                          self.config["text_seq_len"],
                          tuple(self.traffic["question_len"]),
                          self.config["num_classes"])
            for _ in range(self.questions)]
        ids = np.stack([q.ids for q in qs])
        mask = np.stack([q.mask for q in qs])
        labels = np.array([q.label for q in qs], np.int64)
        return clips, ids, mask, np.zeros_like(ids), labels
