"""End-to-end datasets: raw video decode + clip sampling + tokenization.

The port's copy of ``lrce_tpu/data/datasets.py``: the same items for the
same files. Map-style numpy datasets with the same item semantics as the
reference (reference lrce/dataset/e2e_dataset.py:4-317):

  __getitem__ -> (video_clips, input_ids, attention_mask, token_type_ids, gt)

  - video_clips: (sum(scales), frames_per_clip, H, W, 3) float32 [0,1]
    (channels-last; the reference emits CHW)
  - oe/count text: (max_text_token_len,) each; mc: (5, max_text_token_len)
  - gt: int64 class index (IGNORE_INDEX when out-of-vocab) or float32 count

Also includes the precomputed-frames path (`is_frame_extracted`) that reads
per-video .npy clip banks and selects scale rows (e2e_dataset.py:113-116).

The TGIF label files are read by ``data/tsv.read_tsv`` (pandas' typing
without pandas); a row is a dict where lrce_tpu takes ``.iloc[idx]``.
The native GIF / video decoders and WordPiece serve where their library
built; elsewhere PIL / cv2 and the Python tokenizer.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from lrce_tpu_torch.constants import IGNORE_INDEX, SANITY_CHECK_SIZE
from lrce_tpu_torch.data.sampling import build_scale_idx
from lrce_tpu_torch.data.tokenizer import (BertWordPieceTokenizer,
                                           load_default_tokenizer)
from lrce_tpu_torch.data.tsv import read_tsv
from lrce_tpu_torch.data.video_decode import ClipCache, get_video_clips
from lrce_tpu_torch.utils.vocab import build_common_answer_dict, parse_tgif_annot


class E2EDatasetBase:
    def __init__(
        self,
        label_path: str,
        videos_path: str,
        frames_per_clip: int = 5,
        temporal_scale: Sequence[int] = (1, 2, 3),
        frame_size: Tuple[int, int] = (224, 224),
        max_text_token_len: int = 30,
        video_dict: Optional[Dict] = None,
        sanity_check: bool = False,
        is_frame_extracted: bool = False,
        tokenizer: Optional[BertWordPieceTokenizer] = None,
        cache_items: int = 0,
        uint8_clips: bool = False,
    ):
        for path in (videos_path, label_path):
            if not os.path.exists(path):
                raise FileNotFoundError(f"Path {path} does not exist")

        self.label_path = label_path
        self.videos_path = videos_path
        self.frames_per_clip = frames_per_clip
        self.temporal_scale = list(temporal_scale)
        self.frame_size = frame_size
        self.max_text_token_len = max_text_token_len
        self.video_dict = video_dict
        self.sanity_check = sanity_check
        self.is_frame_extracted = is_frame_extracted

        self.tokenizer = (tokenizer if tokenizer is not None
                          else load_default_tokenizer())
        self.cache = ClipCache(cache_items)
        # ship raw uint8 clips to the device (4x less host->device transfer;
        # the model normalizes on the device, models/e2e.py)
        self.uint8_clips = uint8_clips

        self._load_label_file()
        self._build_answer_dict()
        self.scale_idx = build_scale_idx(self.temporal_scale)

    # -- subclass hooks ------------------------------------------------------
    def _load_label_file(self):
        raise NotImplementedError()

    def _build_answer_dict(self):
        raise NotImplementedError()

    def _get_texts(self, idx: int):
        raise NotImplementedError()

    def _get_video_name(self, idx: int) -> str:
        raise NotImplementedError()

    def _get_gt(self, idx: int):
        raise NotImplementedError()

    # -- shared --------------------------------------------------------------
    def __len__(self) -> int:
        if self.sanity_check:
            return SANITY_CHECK_SIZE
        return len(self.label_file)

    def _encode_question(self, question: str, answer: Optional[str] = None):
        return self.tokenizer.encode(question, answer,
                                     max_length=self.max_text_token_len,
                                     padding="max_length")

    def _get_video_clips(self, video_name: str) -> np.ndarray:
        return get_video_clips(os.path.join(self.videos_path, video_name),
                               self.frames_per_clip, self.temporal_scale,
                               self.frame_size, self.cache,
                               out_dtype=(np.uint8 if self.uint8_clips
                                          else np.float32))

    def _get_extracted_video_clips(self, video_name: str) -> np.ndarray:
        bank = np.load(os.path.join(self.videos_path, f"{video_name}.npy"))
        clips = bank[self.scale_idx]
        # Precomputed banks from the reference pipeline are CHW; ours are HWC.
        if clips.shape[2] == 3 and clips.shape[-1] != 3:
            clips = np.transpose(clips, (0, 1, 3, 4, 2))
        return np.ascontiguousarray(clips, np.float32)

    def __getitem__(self, idx: int):
        video_name = self._get_video_name(idx)
        if self.is_frame_extracted:
            clips = self._get_extracted_video_clips(video_name)
        else:
            clips = self._get_video_clips(video_name)
        return (clips, *self._get_texts(idx), self._get_gt(idx))


class E2EMicrosoftDataset(E2EDatasetBase):
    """MSVD-QA / MSRVTT-QA: JSON annotations + idx->video-name mapping
    (reference e2e_dataset.py:127-182)."""

    def __init__(self, train_annotation: str, val_annotation: str,
                 test_annotation: str, videos_path: str, video_dict: Dict,
                 split: str = "train", answer_vocab_k: int = 1000, **kw):
        self.split_dict = {"train": train_annotation, "val": val_annotation,
                           "test": test_annotation}
        self.answer_vocab_k = answer_vocab_k
        super().__init__(self.split_dict[split], videos_path,
                         video_dict=video_dict, **kw)

    def _load_label_file(self):
        with open(self.label_path, "r") as f:
            self.label_file = json.load(f)

    def _build_answer_dict(self):
        # Top-1000 over train+val regardless of configured num_classes
        # (reference parity quirk, e2e_dataset.py:162 vs configs num_classes).
        self.answer_dict = build_common_answer_dict(
            [self.split_dict["train"], self.split_dict["val"]],
            self.answer_vocab_k)

    def _get_texts(self, idx: int):
        return self._encode_question(self.label_file[idx]["question"])

    def _get_video_name(self, idx: int) -> str:
        name = self.video_dict[self.label_file[idx]["video_id"]]
        return name if self.is_frame_extracted else f"{name}.avi"

    def _get_gt(self, idx: int):
        answer = self.label_file[idx]["answer"]
        return np.int64(self.answer_dict.get(answer, IGNORE_INDEX))


class E2ETGIFDataset(E2EDatasetBase):
    """TGIF-QA: tab-separated CSVs, oe/mc/count tasks
    (reference e2e_dataset.py:185-317)."""

    def __init__(self, split_annotation: str, full_annotation: str,
                 videos_path: str, task_type: str = "oe", **kw):
        self.full_annotation = full_annotation
        self.task_type = task_type
        super().__init__(split_annotation, videos_path, video_dict={}, **kw)

    def _load_label_file(self):
        self.label_file = read_tsv(self.label_path)

    def _build_answer_dict(self):
        self.answer_dict, _ = parse_tgif_annot(self.full_annotation,
                                               self.task_type, k=1000)

    def _get_texts(self, idx: int):
        qa = self.label_file[idx]
        if self.task_type == "mc":
            encs = [self._encode_question(qa["question"], qa[f"a{i}"])
                    for i in range(1, 6)]
            ids = np.stack([e[0] for e in encs])
            mask = np.stack([e[1] for e in encs])
            types = np.stack([e[2] for e in encs])
            return ids, mask, types  # (5, L) each
        return self._encode_question(qa["question"])

    def _get_video_name(self, idx: int) -> str:
        name = self.label_file[idx]["gif_name"]
        return name if self.is_frame_extracted else f"{name}.gif"

    def _get_gt(self, idx: int):
        answer = self.label_file[idx]["answer"]
        if self.task_type == "count":
            return np.float32(self.answer_dict[answer])
        return np.int64(self.answer_dict.get(answer, IGNORE_INDEX))
