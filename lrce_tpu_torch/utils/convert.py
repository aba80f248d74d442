"""lrce_tpu params pytree -> the port's reference-named state dict.

The inverse of ``lrce_tpu.utils.torch_io.convert_e2e``: stacked blocks and
layers are unstacked, dense (in, out) weights become (out, in), the DHWIO
patch-embed kernel becomes OIDHW, and the MHA in-projection is repacked as
torch's (3D, D) ``in_proj_weight``. It reads a nested dict of numpy arrays
and needs no JAX.

Also the helpers that bring pretrained torch files to the port's names:
``load_torch_state_dict``, ``strip_prefix`` and ``inflate_swin2d`` (the
port's copies of ``lrce_tpu.utils.torch_io``'s, on tensors).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F


def _index(tree, i: int):
    """Slice i of every leaf of a stacked nested dict."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def _leading(tree) -> int:
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree.shape[0]


class _Writer:
    """Collects tensors under ``{pre}.{key}`` (under ``key`` when pre is
    empty)."""

    def __init__(self, pre: str):
        self.pre = pre
        self.sd: Dict[str, torch.Tensor] = {}

    def put(self, key: str, value) -> None:
        name = f"{self.pre}.{key}" if self.pre else key
        self.sd[name] = torch.from_numpy(np.array(value, order="C"))

    def dense(self, prefix: str, p: dict) -> None:
        self.put(f"{prefix}.weight", np.asarray(p["w"]).T)
        if "b" in p:
            self.put(f"{prefix}.bias", p["b"])

    def layer_norm(self, prefix: str, p: dict) -> None:
        self.put(f"{prefix}.weight", p["scale"])
        self.put(f"{prefix}.bias", p["bias"])

    def mha(self, prefix: str, p: dict) -> None:
        self.put(f"{prefix}.in_proj_weight", np.asarray(p["in_w"]).T)
        self.put(f"{prefix}.in_proj_bias", p["in_b"])
        self.dense(f"{prefix}.out_proj", p["out"])


def head_state_dict(head: dict, pre: str = "fusion_model") -> Dict[str, torch.Tensor]:
    """Fusion head params -> ``{pre}.*`` state dict."""
    w = _Writer(pre)
    vpe = head["video_pos_embed"]
    for k in ("emb_cls", "emb_pos", "emb_len", "emb_clip"):
        w.put(f"video_pos_embed.{k}", vpe[k])
    w.layer_norm("video_pos_embed.layer_norm", vpe["layer_norm"])
    qpe = head["question_pos_embed"]
    for k in ("emb_cls", "emb_pos"):
        w.put(f"question_pos_embed.{k}", qpe[k])
    w.layer_norm("question_pos_embed.layer_norm", qpe["layer_norm"])
    ft = head["fusion_transformer"]
    fpre = "fusion_transformer"
    for i in range(_leading(ft["layers"])):
        lp = _index(ft["layers"], i)
        lpre = f"{fpre}.transformer.layers.{i}"
        w.mha(f"{lpre}.self_attn", lp["self_attn"])
        w.mha(f"{lpre}.multihead_attn", lp["multihead_attn"])
        w.dense(f"{lpre}.linear1", lp["linear1"])
        w.dense(f"{lpre}.linear2", lp["linear2"])
        for n in ("norm1", "norm2", "norm3"):
            w.layer_norm(f"{lpre}.{n}", lp[n])
    w.layer_norm(f"{fpre}.fusion_layer_norm", ft["fusion_layer_norm"])
    w.put(f"{fpre}.summarization_token", ft["summarization_token"])
    w.dense("final_fc", head["final_fc"])
    if "projection_layer" in head:
        w.dense("projection_layer", head["projection_layer"])
    return w.sd


def bert_state_dict(p: dict, pre: str = "text_extractor.bert") -> Dict[str, torch.Tensor]:
    """BERT params -> HuggingFace-named ``{pre}.*`` state dict."""
    w = _Writer(pre)
    emb = p["embeddings"]
    w.put("embeddings.word_embeddings.weight", emb["word"])
    w.put("embeddings.position_embeddings.weight", emb["position"])
    w.put("embeddings.token_type_embeddings.weight", emb["token_type"])
    w.layer_norm("embeddings.LayerNorm", emb["layer_norm"])
    for i in range(_leading(p["layers"])):
        lp = _index(p["layers"], i)
        lpre = f"encoder.layer.{i}"
        att = lp["attention"]
        for n in ("query", "key", "value"):
            w.dense(f"{lpre}.attention.self.{n}", att[n])
        w.dense(f"{lpre}.attention.output.dense", att["output"])
        w.layer_norm(f"{lpre}.attention.output.LayerNorm",
                     att["output_layer_norm"])
        w.dense(f"{lpre}.intermediate.dense", lp["intermediate"])
        w.dense(f"{lpre}.output.dense", lp["output"])
        w.layer_norm(f"{lpre}.output.LayerNorm", lp["output_layer_norm"])
    if "pooler" in p:
        w.dense("pooler.dense", p["pooler"])
    return w.sd


def swin_state_dict(p: dict, pre: str = "video_extractor.swin") -> Dict[str, torch.Tensor]:
    """Swin params -> Video-Swin-named ``{pre}.*`` state dict."""
    w = _Writer(pre)
    pe = p["patch_embed"]
    w.put("patch_embed.proj.weight",
          np.asarray(pe["proj"]["w"]).transpose(4, 3, 0, 1, 2))
    w.put("patch_embed.proj.bias", pe["proj"]["b"])
    if "norm" in pe:
        w.layer_norm("patch_embed.norm", pe["norm"])
    for i, stage in enumerate(p["stages"]):
        for j in range(_leading(stage["blocks"])):
            bp = _index(stage["blocks"], j)
            bpre = f"layers.{i}.blocks.{j}"
            w.layer_norm(f"{bpre}.norm1", bp["norm1"])
            w.dense(f"{bpre}.attn.qkv", bp["attn"]["qkv"])
            w.dense(f"{bpre}.attn.proj", bp["attn"]["proj"])
            w.put(f"{bpre}.attn.relative_position_bias_table",
                  bp["attn"]["rel_table"])
            w.layer_norm(f"{bpre}.norm2", bp["norm2"])
            w.dense(f"{bpre}.mlp.fc1", bp["mlp"]["fc1"])
            w.dense(f"{bpre}.mlp.fc2", bp["mlp"]["fc2"])
        if "downsample" in stage:
            ds = stage["downsample"]
            w.layer_norm(f"layers.{i}.downsample.norm", ds["norm"])
            w.dense(f"layers.{i}.downsample.reduction", ds["reduction"])
    w.layer_norm("norm", p["norm"])
    return w.sd


def state_dict_from_jax(params: dict) -> Dict[str, torch.Tensor]:
    """An lrce_tpu E2E params pytree (numpy leaves) -> the port's
    reference-named state dict, loadable into ``LRCEModel``."""
    return {**head_state_dict(params["fusion_model"]),
            **bert_state_dict(params["text_extractor"]),
            **swin_state_dict(params["video_extractor"])}


# ---------------------------------------------------------------------------
# Torch checkpoint files
# ---------------------------------------------------------------------------

def unwrap_state_dict(ckpt) -> Dict[str, torch.Tensor]:
    """The state dict inside a loaded torch checkpoint: the object itself,
    or what it holds under 'model_state_dict', 'state_dict' or 'model'."""
    if isinstance(ckpt, dict):
        for key in ("model_state_dict", "state_dict", "model"):
            if key in ckpt:
                return ckpt[key]
    return ckpt


def load_torch_state_dict(path: str, device="cpu") -> Dict[str, torch.Tensor]:
    """Read a torch checkpoint file (tensors and plain containers only)
    into a flat {name: tensor} dict on ``device``."""
    ckpt = torch.load(path, map_location=device, weights_only=True)
    return dict(unwrap_state_dict(ckpt))


def strip_prefix(sd: Dict[str, torch.Tensor], prefix: str
                 ) -> Dict[str, torch.Tensor]:
    """Keep the entries under ``prefix`` and strip it ('backbone.' for the
    Video-Swin Kinetics checkpoint)."""
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def inflate_swin2d(sd: Dict[str, torch.Tensor], window_size=(8, 7, 7),
                   patch_size_d: int = 2) -> Dict[str, torch.Tensor]:
    """Inflate a 2D Swin state dict to the 3D layout, as
    ``lrce_tpu.utils.torch_io.inflate_swin2d``:

      - drop relative_position_index / attn_mask buffers (re-derived),
      - patch_embed conv (O, I, H, W) -> (O, I, D, H, W) / D,
      - bicubic-resize each relative_position_bias_table to the 3D window's
        spatial extent, then tile along the temporal axis (2*wd - 1 copies).
    """
    out: Dict[str, torch.Tensor] = {}
    wd, wh, ww = window_size
    l2 = (2 * wh - 1) * (2 * ww - 1)
    for k, v in sd.items():
        if "relative_position_index" in k or "attn_mask" in k:
            continue
        if k == "patch_embed.proj.weight" and v.ndim == 4:
            v = v[:, :, None].repeat(1, 1, patch_size_d, 1, 1) / patch_size_d
        elif "relative_position_bias_table" in k:
            l1, nh = v.shape
            if l1 != l2:
                s1 = int(round(l1 ** 0.5))
                t = v.float().permute(1, 0).reshape(1, nh, s1, s1)
                t = F.interpolate(t, size=(2 * wh - 1, 2 * ww - 1),
                                  mode="bicubic")
                v = t.reshape(nh, l2).permute(1, 0).to(v.dtype)
            v = v.repeat(2 * wd - 1, 1)
        out[k] = v.contiguous()
    return out
