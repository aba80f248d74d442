"""Offline feature and frame-bank extraction (the reference's legacy path).

Counterpart of ``tools/extract_features.py``, three subcommands:

  frames - per-video multi-scale clip banks (.npy, float32 (sum(scales),
           frames, H, W, 3)) for the datasets' ``is_frame_extracted`` path
           (scales 1 2 3 4 by default, so that any subset can be picked at
           train time through ``scale_idx``); host only;
  video  - clips through the Swin tower (``models/e2e.extract_video_features``,
           the CUDA kernel route unless ``--plain``) after
           ``pretrained.load_pretrained``; one .pkl per video of float32
           (n_clips, T', H/32 * W/32, 1024);
  text   - questions tokenised and encoded by BERT
           (``models/e2e.extract_text_features``); one .pkl per question of
           float32 (max_len, 768).

The model runs on the card (bf16 compute, f32 output) unless the caller
asks for the CPU, and raises where there is no card.

    python -m lrce_tpu_torch.tools.extract_features frames --videos-dir D \\
        --out-dir O [--scales 1 2 3 4]
    python -m lrce_tpu_torch.tools.extract_features video --videos-dir D \\
        --out-dir O [--batch 8]
    python -m lrce_tpu_torch.tools.extract_features text --annotation A \\
        --out-dir O [--tgif] [--max-len 30]
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
from typing import Optional

import numpy as np
import torch

from lrce_tpu_torch.constants import VIDEO_EXT
from lrce_tpu_torch.data.video_decode import get_video_clips
from lrce_tpu_torch.models.e2e import (E2EConfig, extract_text_features,
                                       extract_video_features)
from lrce_tpu_torch.pretrained import load_pretrained
from lrce_tpu_torch.tools import common
from lrce_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device


def list_videos(videos_dir: str):
    return sorted(v for v in os.listdir(videos_dir)
                  if os.path.splitext(v)[1].lower() in VIDEO_EXT)


def _dump(path: str, value: np.ndarray) -> None:
    with open(path, "wb") as fh:
        pickle.dump(value, fh)


def cmd_frames(args, device=None, model_cfg=None) -> None:
    os.makedirs(args.out_dir, exist_ok=True)
    videos = list_videos(args.videos_dir)
    for i, name in enumerate(videos):
        stem = os.path.splitext(name)[0]
        out = os.path.join(args.out_dir, f"{stem}.npy")
        if os.path.exists(out) and not args.overwrite:
            continue
        clips = get_video_clips(os.path.join(args.videos_dir, name),
                                args.frames_per_clip, args.scales,
                                (args.frame_size, args.frame_size))
        np.save(out, clips.astype(np.float32))
        if i % 50 == 0:
            print(f"[{i}/{len(videos)}] {name}")
    print(f"wrote {len(videos)} clip banks to {args.out_dir}")


def _model(args, device, model_cfg: Optional[E2EConfig], **pretrained):
    device = resolve_device(device)
    cfg = (model_cfg or E2EConfig())._replace(
        temporal_scale=tuple(getattr(args, "scales", (3,))))
    model = common.flagship(device, cfg, plain=getattr(args, "plain", False))
    return load_pretrained(model, **pretrained).eval(), device


def cmd_video(args, device=DEFAULT_DEVICE, model_cfg=None) -> None:
    model, device = _model(args, device, model_cfg, swin_path=args.swin_ckpt)
    os.makedirs(args.out_dir, exist_ok=True)
    videos = list_videos(args.videos_dir)
    names, clips = [], []

    def flush():
        if not names:
            return
        batch = torch.from_numpy(np.stack(clips)).to(device)
        with torch.no_grad():
            feats = extract_video_features(model, batch).float().cpu().numpy()
        for name, f in zip(names, feats):
            _dump(os.path.join(args.out_dir,
                               f"{os.path.splitext(name)[0]}.pkl"), f)
        names.clear()
        clips.clear()

    for i, name in enumerate(videos):
        clips.append(get_video_clips(os.path.join(args.videos_dir, name),
                                     args.frames_per_clip, args.scales,
                                     (args.frame_size, args.frame_size)))
        names.append(name)
        if len(names) == args.batch:
            flush()
        if i % 50 == 0:
            print(f"[{i}/{len(videos)}] {name}")
    flush()
    print(f"wrote features for {len(videos)} videos to {args.out_dir}")


def cmd_text(args, device=DEFAULT_DEVICE, model_cfg=None) -> None:
    from lrce_tpu_torch.data.tokenizer import load_default_tokenizer
    from lrce_tpu_torch.data.tsv import read_tsv

    model, device = _model(args, device, model_cfg, bert_path=args.bert_ckpt)
    tok = load_default_tokenizer()
    if args.tgif:
        questions = [(str(row.get("vid_id", i)), row["question"])
                     for i, row in enumerate(read_tsv(args.annotation))]
    else:
        with open(args.annotation) as f:
            qa_list = json.load(f)
        questions = [(str(qa.get("id", i)), qa["question"])
                     for i, qa in enumerate(qa_list)]

    os.makedirs(args.out_dir, exist_ok=True)
    for start in range(0, len(questions), args.batch):
        chunk = questions[start:start + args.batch]
        enc = [tok.encode(q, max_length=args.max_len) for _, q in chunk]
        ids, mask, types = (torch.from_numpy(np.stack([e[k] for e in enc]))
                            .to(device) for k in range(3))
        with torch.no_grad():
            feats = extract_text_features(model, ids, mask, types)
        for (qid, _), f in zip(chunk, feats.float().cpu().numpy()):
            _dump(os.path.join(args.out_dir, f"{qid}.pkl"), f)
    print(f"wrote features for {len(questions)} questions to {args.out_dir}")


def main(argv=None, *, device=DEFAULT_DEVICE,
         model_cfg: Optional[E2EConfig] = None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = p.add_subparsers(dest="cmd", required=True)

    pf = sub.add_parser("frames")
    pf.add_argument("--videos-dir", required=True)
    pf.add_argument("--out-dir", required=True)
    pf.add_argument("--scales", nargs="+", type=int, default=[1, 2, 3, 4])
    pf.add_argument("--frames-per-clip", type=int, default=5)
    pf.add_argument("--frame-size", type=int, default=224)
    pf.add_argument("--overwrite", action="store_true")

    pv = sub.add_parser("video")
    pv.add_argument("--videos-dir", required=True)
    pv.add_argument("--out-dir", required=True)
    pv.add_argument("--scales", nargs="+", type=int, default=[1, 2, 3])
    pv.add_argument("--frames-per-clip", type=int, default=5)
    pv.add_argument("--frame-size", type=int, default=224)
    pv.add_argument("--batch", type=int, default=8)
    pv.add_argument("--swin-ckpt", default=None)
    pv.add_argument("--plain", action="store_true", help=common.PLAIN_HELP)

    pt = sub.add_parser("text")
    pt.add_argument("--annotation", required=True)
    pt.add_argument("--out-dir", required=True)
    pt.add_argument("--tgif", action="store_true")
    pt.add_argument("--max-len", type=int, default=30)
    pt.add_argument("--batch", type=int, default=256)
    pt.add_argument("--bert-ckpt", default=None)

    args = p.parse_args(argv)
    cmd = {"frames": cmd_frames, "video": cmd_video, "text": cmd_text}
    cmd[args.cmd](args, device, model_cfg)


if __name__ == "__main__":
    main()
