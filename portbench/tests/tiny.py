"""A tiny cell root for the benchmark's CPU tests: the benchmark's own
modes, metrics and count code beside a tiny configuration, its traffic and
its cells, in a temporary directory."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from portbench.registry import ROOT

CONFIG = {
    "name": "tiny", "source": "a test size", "reduced": [],
    "dataset": "msvd-qa-oe", "task_type": "oe", "num_classes": 10,
    "feature_dim": 24, "text_seq_len": 8, "frame_sample_size": 5,
    "frame_size": 32, "temporal_scale": [3], "video_feature_res": [4, 4],
    "video_feature_dim": 16, "drop_out_rate": 0.5,
    "swin": {"patch_size": [2, 4, 4], "embed_dim": 8, "depths": [2, 2],
             "num_heads": [1, 2], "window_size": [2, 4, 4], "mlp_ratio": 4.0,
             "drop_path_rate": 0.2},
    "bert": {"vocab_size": 200, "hidden_size": 24, "num_layers": 2,
             "num_heads": 2, "intermediate_size": 48,
             "max_position_embeddings": 40, "type_vocab_size": 2,
             "hidden_dropout": 0.1, "attention_dropout": 0.1},
    "fusion": {"num_layers": 12, "num_heads": 12, "dim_feedforward": 3072},
    "train": {"lr": [5e-5, 5e-5, 5e-5], "reg_strength": 0.001,
              "optimizer": "adamw", "betas": [0.9, 0.999], "eps": 1e-8,
              "weight_decay": 0.01, "param_dtype": "float32",
              "compute_dtype": "float32"},
    "token_ids": {"pad": 0, "cls": 101, "sep": 102, "words": [103, 200]},
}
TRAIN_LIMITS = {"loss_gap": 1e-4, "logits_gap": 1e-4, "grad_gap": 1e-3,
                "change_gap": 1e-3}


def cells():
    return {
        "tiny-train": {"config": "tiny", "traffic": "tiny-steps", "chips": 1,
                       "ranks": 1, "mode": "train", "reference_block": 2,
                       "limits": TRAIN_LIMITS, "why": "a test"},
        "tiny-train-2r": {"config": "tiny", "traffic": "tiny-steps",
                          "chips": 4, "ranks": 2, "mode": "train",
                          "reference_block": 2, "limits": TRAIN_LIMITS,
                          "why": "a test across two ranks"},
        "tiny-request": {"config": "tiny", "traffic": "tiny-requests",
                         "chips": 1, "ranks": 1, "mode": "request",
                         "reference_block": 3,
                         "limits": {"logits_gap": 1e-4}, "why": "a test"},
    }


def make_root(tmp: Path) -> Path:
    root = Path(tmp) / "portbench"
    for kind in ("modes", "metrics", "counts"):
        shutil.copytree(ROOT / kind, root / kind)
    shutil.copy(ROOT / "counts" / "lrce-msvd.py", root / "counts" / "tiny.py")
    for kind in ("configs", "traffic", "workloads"):
        (root / kind).mkdir(parents=True)
    (root / "configs" / "tiny.json").write_text(json.dumps(CONFIG))
    (root / "traffic" / "tiny-steps.json").write_text(json.dumps(
        {"kind": "steps", "questions": 4, "question_len": [3, 8]}))
    (root / "traffic" / "tiny-requests.json").write_text(json.dumps(
        {"kind": "closed_loop", "clients": 1, "questions": 1,
         "question_len": [3, 8]}))
    for name, cell in cells().items():
        (root / "workloads" / f"{name}.json").write_text(json.dumps(
            {"name": name, **cell}))
    shutil.copy(ROOT.parent / "BENCHMARK.json", root.parent)
    return root


def benchmark(cell: str) -> dict:
    """BENCHMARK.json with the tiny cell added to every metric of its
    kind."""
    with open(ROOT.parent / "BENCHMARK.json") as f:
        b = json.load(f)
    kind = "train" if "train" in cell else "request"
    for m in b["end_to_end"] + b["per_layer"]:
        if "workloads" in m and any(kind in w for w in m["workloads"]):
            m["workloads"] = m["workloads"] + [cell]
    return b
