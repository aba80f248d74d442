"""Fusion cost: LRCE's recurrent fusion against the reference's two
cross-encoder baselines (VQA-T and VIOLET) over doubling token lengths.

Counterpart of ``tools/flops.py`` (the reference's
``calculate_flops.py:305-372``), with the same three models in plain
PyTorch (no CUDA kernel is on this path):

  - VQA-T: a 12-layer post-norm self-attention encoder (dim 768, 12 heads,
    FFN 3072, GELU: ``models/bert.BertLayer``) over the concatenated video
    + text tokens; only the last hidden state leaves it;
  - VIOLET: the same encoder as a cross-encoder that also returns every
    layer's (B, 12, S, S) attention probabilities (the reference's
    ``output_attentions=True``), so all twelve maps are live at the end;
  - LRCE: the recurrent fusion transformer (``models/fusion.
    FusionTransformer``) over (B, 3, video_tl, dim) clips, one
    summarisation token through the clips in turn.

Per model and token length: FLOPs from ``torch.utils.flop_counter.
FlopCounterMode`` over one forward; runtime, the mean of ITERS
forwards after a warm-up (CUDA events on the card, the host clock on the
CPU); memory, the bytes of the arguments (parameters and inputs) plus, on
the card, the peak allocated during a forward above what was allocated
before it, and on the CPU the peak of the live bytes of the tensors the
forward makes (a ``TorchDispatchMode`` that counts each new storage until
its tensor dies). The claim compared: LRCE's cost grows linearly in the
video's length, a joint encoder's faster.

    python -m lrce_tpu_torch.tools.flops [--batch 1] [--steps 4]
        [--feature-dim 768]
"""

from __future__ import annotations

import argparse
import weakref
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from lrce_tpu_torch.models import bert as B
from lrce_tpu_torch.models.e2e import E2EConfig
from lrce_tpu_torch.models.fusion import FusionTransformer
from lrce_tpu_torch.tools import common
from lrce_tpu_torch.tools.synth import table
from lrce_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device

ITERS = 5       # forwards timed per cell


class Encoder(torch.nn.Module):
    """Twelve post-norm BERT layers over (B, S, dim), no padding; with
    ``attentions`` each layer's attention probabilities are returned too
    (VIOLET)."""

    def __init__(self, dim: int, generator: torch.Generator,
                 attentions: bool, num_layers: int = 12, num_heads: int = 12,
                 ffn: int = 3072):
        super().__init__()
        self.cfg = B.BertConfig(hidden_size=dim, num_layers=num_layers,
                                num_heads=num_heads, intermediate_size=ffn,
                                hidden_dropout=0.0, attention_dropout=0.0)
        self.layers = torch.nn.ModuleList(
            B.BertLayer(self.cfg, torch.float32, generator)
            for _ in range(num_layers))
        self.attentions = attentions

    def forward(self, x: torch.Tensor):
        b, s, d = x.shape
        bias = torch.zeros((b, 1, 1, s), dtype=torch.float32, device=x.device)
        h, hd = self.cfg.num_heads, d // self.cfg.num_heads
        probs = []
        for layer in self.layers:
            if self.attentions:
                att = layer.attention.self

                def heads(t):
                    return t.reshape(b, s, h, hd).transpose(1, 2)

                q, k = heads(att.query(x)), heads(att.key(x))
                logits = torch.matmul(q, k.transpose(-1, -2)) / hd ** 0.5
                probs.append(torch.softmax(logits + bias, dim=-1))
            x = layer(x, bias)
        return (x, probs) if self.attentions else x


class _LiveBytes(TorchDispatchMode):
    """The peak of the live bytes of the storages the ops inside it make:
    each new storage counts from the op that makes it until the tensor it
    came out in dies."""

    def __init__(self):
        super().__init__()
        self.live = self.peak = 0
        self._seen = set()

    def _free(self, key, nbytes):
        self._seen.discard(key)
        self.live -= nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_flatten(out)[0]:
            if not isinstance(t, torch.Tensor):
                continue
            storage = t.untyped_storage()
            key = storage.data_ptr()
            if key in self._seen or storage.nbytes() == 0:
                continue
            self._seen.add(key)
            self.live += storage.nbytes()
            self.peak = max(self.peak, self.live)
            weakref.finalize(t, self._free, key, storage.nbytes())
        return out


def _nbytes(module: torch.nn.Module, *inputs) -> int:
    return (sum(p.numel() * p.element_size() for p in module.parameters())
            + sum(x.numel() * x.element_size() for x in inputs))


def measure(module: torch.nn.Module, inputs, device: torch.device,
            iters: int) -> dict:
    """MFLOPs, runtime ms and memory MB of ``module(*inputs)``."""
    with torch.no_grad():
        flops = common.count_flops(lambda: module(*inputs), module)
        runtime = common.time_ms(lambda: module(*inputs), device, iters)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            before = torch.cuda.memory_allocated(device)
            torch.cuda.reset_peak_memory_stats(device)
            module(*inputs)
            torch.cuda.synchronize(device)
            temp = torch.cuda.max_memory_allocated(device) - before
        else:
            with _LiveBytes() as live:
                out = module(*inputs)
                del out
            temp = live.peak
    return {"mflops": flops / 1e6, "runtime_ms": runtime,
            "memory_mb": (_nbytes(module, *inputs) + temp) / 1048576}


def main(argv=None, *, device=DEFAULT_DEVICE,
         model_cfg: Optional[E2EConfig] = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--steps", type=int, default=4,
                   help="doublings of the token length")
    p.add_argument("--feature-dim", type=int,
                   default=(model_cfg or common.FLAGSHIP).feature_dim)
    args = p.parse_args(argv)
    device = resolve_device(device)

    dim = args.feature_dim
    gen = torch.Generator().manual_seed(0)
    lrce = FusionTransformer(dim, torch.float32, gen).to(device).eval()
    # distinct parameters per baseline, as the reference's two models
    vqat = Encoder(dim, gen, attentions=False).to(device).eval()
    violet = Encoder(dim, gen, attentions=True).to(device).eval()

    rows = {"lrce": [], "vqat": [], "violet": []}
    video_tl, text_tl = 31, 14
    for _ in range(args.steps):
        video_tl *= 2
        text_tl *= 2
        total = video_tl + text_tl
        vid = torch.zeros((args.batch, 3, video_tl, dim), device=device)
        txt = torch.zeros((args.batch, text_tl, dim), device=device)
        # the joint encoders see concat(video, text): the shape the
        # reference feeds both
        joint = torch.zeros((args.batch, total, dim), device=device)
        for name, module, inputs in (("lrce", lrce, (vid, txt)),
                                     ("vqat", vqat, (joint,)),
                                     ("violet", violet, (joint,))):
            m = measure(module, inputs, device, ITERS)
            rows[name].append(dict(
                token_length=total, mflops=round(m["mflops"], 1),
                runtime_ms=round(m["runtime_ms"], 3),
                memory_mb=round(m["memory_mb"], 1)))

    for name, data in rows.items():
        print(name.upper())
        print(table(data))
    return rows


if __name__ == "__main__":
    main()
