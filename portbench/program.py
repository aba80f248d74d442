"""The system under test, reached through its public entry points only:
``models.e2e`` (``E2EConfig``, ``e2e_forward``), ``cli.train.build_model``,
``train.agent`` (``AgentOE`` through ``agent_factory``, ``default_args``),
``parallel.mesh`` (``init_distributed``, ``make_layout``) and
``ops.cuda_lib.build``. Nothing else of the benchmark imports the program.

The configuration states the fusion's sizes, the precision and the
optimizer; the program takes none of them as an argument, so ``model`` and
``agent`` read them back from what the program built and refuse a
configuration that it does not run as stated.
"""

from __future__ import annotations

import torch

from lrce_tpu_torch.cli.train import build_model
from lrce_tpu_torch.models import bert as B
from lrce_tpu_torch.models import fusion as F
from lrce_tpu_torch.models import swin3d as S
from lrce_tpu_torch.models.e2e import E2EConfig, e2e_forward
from lrce_tpu_torch.parallel import mesh as PM
from lrce_tpu_torch.train.agent import agent_factory, default_args

__all__ = ["build_kernels", "model", "agent", "e2e_forward", "PM"]


def build_kernels() -> float:
    """Build (or find built) the CUDA kernels; the seconds nvcc took."""
    from lrce_tpu_torch.ops import cuda_lib

    return cuda_lib.build()[1]


def model_config(config: dict) -> E2EConfig:
    sw, bt = config["swin"], config["bert"]
    swin = S.SwinConfig(
        patch_size=tuple(sw["patch_size"]), embed_dim=sw["embed_dim"],
        depths=tuple(sw["depths"]), num_heads=tuple(sw["num_heads"]),
        window_size=tuple(sw["window_size"]), mlp_ratio=sw["mlp_ratio"],
        drop_path_rate=sw["drop_path_rate"])
    bert = B.BertConfig(**{k: bt[k] for k in B.BertConfig._fields})
    return E2EConfig(
        feature_dim=config["feature_dim"], num_classes=config["num_classes"],
        video_feature_res=tuple(config["video_feature_res"]),
        video_feature_dim=config["video_feature_dim"],
        frame_sample_size=config["frame_sample_size"],
        temporal_scale=tuple(config["temporal_scale"]),
        text_seq_len=config["text_seq_len"], task_type=config["task_type"],
        bert=bert, swin=swin, drop_out_rate=config["drop_out_rate"])


def _holds(what: str, built, stated) -> None:
    if built != stated:
        raise ValueError(f"the configuration states {what} {stated!r}; the "
                         f"program built {built!r}")


def model(config: dict, device: torch.device):
    """``cli.train.build_model``'s model for the configuration: float32
    parameters, bfloat16 compute on the card."""
    net = build_model(None, device, model_config(config))
    train = config["train"]
    _holds("fusion", {"num_layers": F.NUM_LAYERS, "num_heads": F.NUM_HEADS,
                      "dim_feedforward": F.DIM_FEEDFORWARD},
           config["fusion"])
    _holds("train.param_dtype",
           sorted({str(p.dtype).split(".")[-1] for p in net.parameters()}),
           [train["param_dtype"]])
    _holds("train.compute_dtype", str(net.dtype).split(".")[-1],
           train["compute_dtype"])
    return net


def agent(net, config: dict, seed: int, layout=None):
    """The train CLI's agent for the configuration's task, without logs or
    checkpoints, at the configuration's learning rates and reg."""
    train = config["train"]
    args = default_args(config["dataset"], lr=list(train["lr"]),
                        reg_strength=train["reg_strength"],
                        drop_out_rate=config["drop_out_rate"],
                        debug_mode=True)
    out = agent_factory(config["task_type"])(net, args, log_enabled=False,
                                             seed=seed, layout=layout)
    opt = out.optimizer
    _holds("train.optimizer", type(opt).__name__.lower(), train["optimizer"])
    for key in ("betas", "eps", "weight_decay"):
        _holds(f"train.{key}",
               [list(g[key]) if key == "betas" else g[key]
                for g in opt.param_groups],
               [train[key]] * len(opt.param_groups))
    return out

