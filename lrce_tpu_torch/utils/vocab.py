"""Answer / video vocabularies, the port's copy of
``lrce_tpu/utils/vocab.py``: the same dicts for the same files.

Ties among answers keep their first-seen order (``Counter.most_common``),
the top-K cut is the same, and the count task maps each answer to itself.
The TGIF annotation file is read by ``data/tsv.read_tsv`` (pandas' column
typing without pandas).
"""

from __future__ import annotations

import json
import os
from collections import Counter
from functools import lru_cache
from typing import Dict, List, Tuple

import numpy as np

from lrce_tpu_torch.data.tsv import read_tsv


def build_video_dict(annotation_file: str, reverse_key: bool = False,
                     start_idx: int = 0) -> Dict:
    """Map video name -> index from a whitespace annotation file."""
    video_dict: Dict[str, int] = {}
    idx = start_idx
    with open(annotation_file, "r") as annot:
        for line in annot:
            line = line.strip("\n")
            if not line:
                continue
            video_name = line.split(" ")[0]
            if video_name not in video_dict:
                video_dict[video_name] = idx
                idx += 1
    if reverse_key:
        return {v: k for k, v in video_dict.items()}
    return video_dict


def build_answer_dict(annotation_files: List[str], reverse_key: bool = False) -> Dict:
    """All-answers vocabulary in first-seen order."""
    answer_dict: Dict = {}
    idx = 0
    for file in annotation_files:
        with open(file, "r") as f:
            for qa in json.load(f):
                if qa["answer"] not in answer_dict:
                    answer_dict[qa["answer"]] = idx
                    idx += 1
    if reverse_key:
        return {v: k for k, v in answer_dict.items()}
    return answer_dict


def build_common_answer_dict(annotation_files: List[str], k: int = 1500,
                             reverse_key: bool = False) -> Dict:
    """Top-K most common answers -> [0, K)."""
    answer_list: List = []
    for file in annotation_files:
        with open(file, "r") as f:
            qa_list = json.load(f)
            answer_list += [qa["answer"] for qa in qa_list]
    top_k = Counter(answer_list).most_common(k)
    answer_dict = {val: i for i, (val, _) in enumerate(top_k)}
    if reverse_key:
        return {v: k_ for k_, v in answer_dict.items()}
    return answer_dict


@lru_cache(maxsize=100000)
def load_npy_with_cache(path: str):
    """Cached .npy load."""
    return np.load(path)


def load_features_to_memory(video_features_path: str, text_features_path: str):
    """Preload whole offline-feature directories keyed by integer id."""
    video_features_dict, text_features_dict = {}, {}
    for file_feature in os.listdir(video_features_path):
        fid, _ = os.path.splitext(file_feature)
        video_features_dict[int(fid)] = np.load(
            os.path.join(video_features_path, file_feature))
    for file_feature in os.listdir(text_features_path):
        fid, _ = os.path.splitext(file_feature)
        text_features_dict[int(fid)] = np.load(
            os.path.join(text_features_path, file_feature))
    return video_features_dict, text_features_dict


def parse_tgif_annot(file_path: str, task_type: str = "oe", k: int = 1000
                     ) -> Tuple[Dict, Dict]:
    """Parse a TGIF annotation file (tab-separated) into (answer_dict,
    video_dict). oe: the top-K answers; mc / count: each answer maps to
    itself."""
    if not os.path.exists(file_path):
        raise FileNotFoundError(f"Path {file_path} does not exist")
    rows = read_tsv(file_path)
    video_dict = {r["gif_name"]: r["vid_id"] for r in rows}

    all_answer = [r["answer"] for r in rows]
    if task_type == "oe":
        top_k = Counter(all_answer).most_common(k)
        answer_dict = {val: i for i, (val, _) in enumerate(top_k)}
    else:
        answer_dict = {val: val for val in all_answer}
    return answer_dict, video_dict
