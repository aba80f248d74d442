"""End-to-end LRCE model: BERT text encoder + Video Swin-B + fusion head.

Counterpart of ``lrce_tpu/models/e2e.py``:
  - uint8 frames are scaled by 1/255 in f32 and ImageNet-normalized on the
    device, in the compute dtype;
  - all clips of all questions go through Swin as one batch;
  - the multiple-choice head flattens its QA pairs into BERT's batch;
  - parameters are held in ``dtype`` and the activations computed in
    ``compute_dtype`` (f32 masters, bf16 compute for training, as
    ``lrce_tpu``'s ``compute_dtype``);
  - ``e2e_apply`` is the grad-enabled forward, with dropout and drop-path
    in training drawn from an explicit generator; ``e2e_forward`` is the
    no-grad serving entry over the same body.

Module names are the reference's (``fusion_model``, ``text_extractor.bert``,
``video_extractor.swin``), so ``LRCEModel.state_dict()`` is a reference
checkpoint.

    model = LRCEModel(E2EConfig(num_classes=1000, temporal_scale=(3,),
                                text_seq_len=32), dtype=torch.float32,
                      compute_dtype=torch.bfloat16)    # on the card
    logits = e2e_forward(model, clips, ids, mask, types)
    gen = torch.Generator(device="cuda").manual_seed(0)
    loss = f(e2e_apply(model, clips, ids, mask, types, training=True,
                       generator=gen))
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from lrce_tpu_torch.constants import IMAGENET_MEAN, IMAGENET_STD
from lrce_tpu_torch.models import bert as B
from lrce_tpu_torch.models import swin3d as S
from lrce_tpu_torch.models.fusion import LRCEHead
from lrce_tpu_torch.utils import trace
from lrce_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device


class E2EConfig(NamedTuple):
    feature_dim: int = 768
    num_classes: int = 1000
    video_feature_res: tuple = (7, 7)
    video_feature_dim: int = 1024
    frame_sample_size: int = 5
    temporal_scale: tuple = (3,)
    text_seq_len: int = 30
    task_type: str = "oe"  # oe | mc | count
    bert: B.BertConfig = B.BERT_BASE
    swin: S.SwinConfig = S.SWIN_BASE
    drop_out_rate: float = 0.1      # the fusion head's dropout


class TextExtractor(nn.Module):
    def __init__(self, cfg: B.BertConfig, dtype, generator, compute_dtype):
        super().__init__()
        self.bert = B.BertModel(cfg, dtype=dtype, generator=generator,
                                compute_dtype=compute_dtype)


class VideoExtractor(nn.Module):
    def __init__(self, cfg: S.SwinConfig, dtype, generator):
        super().__init__()
        self.swin = S.SwinTransformer3D(cfg, dtype=dtype, generator=generator)


class LRCEModel(nn.Module):
    """The whole model on ``device``: the card unless the caller asks for
    the CPU, and an error when there is no card. Weight matrices are held
    in ``dtype`` and the activations computed in ``compute_dtype`` (default:
    ``dtype``); LayerNorm parameters, biases, embeddings and position
    tables stay f32. Random weights come from ``generator``, or from a
    generator seeded with 0."""

    def __init__(self, cfg: E2EConfig, *, device=DEFAULT_DEVICE,
                 dtype=torch.float32, compute_dtype=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.cfg = cfg
        self.dtype = compute_dtype or dtype      # the activation dtype
        self.fusion_model = LRCEHead(
            cfg.task_type, cfg.feature_dim, cfg.num_classes,
            cfg.video_feature_res, cfg.video_feature_dim,
            cfg.frame_sample_size, cfg.temporal_scale, cfg.text_seq_len,
            dtype, generator, cfg.drop_out_rate)
        self.text_extractor = TextExtractor(cfg.bert, dtype, generator,
                                            self.dtype)
        self.video_extractor = VideoExtractor(cfg.swin, dtype, generator)
        self.to(device)

    def forward(self, video_clips, texts, texts_attention_mask,
                texts_type_ids, *, training: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``e2e_apply`` (a module call, so that a DDP wrapper sees the
        forward)."""
        return e2e_apply(self, video_clips, texts, texts_attention_mask,
                         texts_type_ids, training=training,
                         generator=generator)


def extract_video_features(model: LRCEModel, video_clips: torch.Tensor,
                           training: bool = False,
                           generator: Optional[torch.Generator] = None
                           ) -> torch.Tensor:
    """(B, n_clips, T, H, W, 3) channels-last uint8 or float clips ->
    (B, n_clips, ceil(T/2), H/32 * W/32, 8 * embed_dim)."""
    b, n_clips, t, h, w, c = video_clips.shape
    dt = model.dtype
    if video_clips.dtype == torch.uint8:
        video_clips = video_clips.float() / 255.0
    x = video_clips.to(dt)
    mean = torch.tensor(IMAGENET_MEAN, dtype=dt, device=x.device)
    std = torch.tensor(IMAGENET_STD, dtype=dt, device=x.device)
    x = ((x - mean) / std).reshape(b * n_clips, t, h, w, c)
    with trace.span("swin"):
        feats = model.video_extractor.swin(x, training, generator)
    _, tp, hp, wp, cdim = feats.shape
    return feats.reshape(b, n_clips, tp, hp * wp, cdim)


def extract_text_features(model: LRCEModel, texts: torch.Tensor,
                          attention_mask: torch.Tensor,
                          token_type_ids: torch.Tensor, training: bool = False,
                          generator: Optional[torch.Generator] = None
                          ) -> torch.Tensor:
    """(B, L) or (B, M, L) token ids -> last hidden states."""
    bert = model.text_extractor.bert
    if texts.ndim == 3:
        b, m, l = texts.shape
        with trace.span("bert"):
            out = bert(texts.reshape(b * m, l),
                       attention_mask.reshape(b * m, l),
                       token_type_ids.reshape(b * m, l), training, generator)
        return out.reshape(b, m, l, -1)
    with trace.span("bert"):
        return bert(texts, attention_mask, token_type_ids, training,
                    generator)


def e2e_apply(model: LRCEModel, video_clips: torch.Tensor,
              texts: torch.Tensor, texts_attention_mask: torch.Tensor,
              texts_type_ids: torch.Tensor, *, training: bool = False,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Clips + question tokens -> task logits: (B, num_classes) for oe,
    (B, M) for mc, (B,) for count. Grad-enabled; ``training`` turns on
    dropout and drop-path, drawn from ``generator`` (a generator on the
    model's device)."""
    cfg = model.cfg
    if video_clips.ndim != 6:
        raise ValueError("video_clips must be (B, n_clips, T, H, W, 3); got "
                         f"shape {tuple(video_clips.shape)}")
    if video_clips.shape[1] != sum(cfg.temporal_scale):
        raise ValueError(
            f"video_clips has {video_clips.shape[1]} clips but temporal_scale="
            f"{cfg.temporal_scale} implies {sum(cfg.temporal_scale)}")
    expected_text_ndim = 3 if cfg.task_type == "mc" else 2
    if texts.ndim != expected_text_ndim:
        raise ValueError(f"texts must have ndim {expected_text_ndim} for task "
                         f"'{cfg.task_type}'; got shape {tuple(texts.shape)}")
    if training and generator is None:
        raise ValueError("training needs a torch.Generator on the model's "
                         "device")
    with trace.span("forward"):
        trace.count("questions", video_clips.shape[0])
        trace.count("clips", video_clips.shape[0] * video_clips.shape[1])
        video = extract_video_features(model, video_clips, training,
                                       generator)
        text = extract_text_features(model, texts, texts_attention_mask,
                                     texts_type_ids, training, generator)
        with trace.span("fusion"):
            return model.fusion_model(video, text, texts_attention_mask,
                                      training, generator)


@torch.no_grad()
def e2e_forward(model: LRCEModel, video_clips: torch.Tensor,
                texts: torch.Tensor, texts_attention_mask: torch.Tensor,
                texts_type_ids: torch.Tensor) -> torch.Tensor:
    """The serving entry: ``e2e_apply`` in eval mode, without autograd."""
    return e2e_apply(model, video_clips, texts, texts_attention_mask,
                     texts_type_ids)


def config_from_args(args) -> E2EConfig:
    """An ``E2EConfig`` from a parsed namespace of ``lrce_tpu_torch.config``
    (``lrce_tpu.models.e2e.config_from_args`` without its two environment
    hooks: the CLIs take a ``model_cfg`` for a small test model in place of
    LRCE_TPU_TINY_MODEL, and the port has no Swin remat, LRCE_TPU_SWIN_REMAT:
    K4 and K5 recompute the attention and the MLP hidden in the backward).
    BERT-base at the dataset's widths, and the Video Swin tower that the
    model configuration names by its ``swin`` key (``swin3d.SWIN_CONFIGS``:
    "base", the default, or "large", Swin-L at 384 x 384, whose
    configuration also states ``frame_size`` 384, ``video_feature_res``
    [12, 12] and ``video_feature_dim`` 1536)."""
    return E2EConfig(
        feature_dim=args.feature_dim,
        num_classes=args.num_classes,
        drop_out_rate=getattr(args, "drop_out_rate", 0.1),
        video_feature_res=tuple(args.video_feature_res),
        video_feature_dim=args.video_feature_dim,
        frame_sample_size=args.frame_sample_size,
        temporal_scale=tuple(args.temporal_scale),
        text_seq_len=args.text_seq_len,
        task_type=args.task_type,
        swin=S.SWIN_CONFIGS[getattr(args, "swin", "base")],
    )
