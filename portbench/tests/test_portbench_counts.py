"""The analytic count of ``counts/`` against ``FlopCounterMode`` over the
frozen reference's forward, at a small size and at the cells' own sizes
(the latter on meta tensors, which hold no memory)."""

import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import program
from portbench.reference import lrce as R
from portbench.registry import ROOT, Registry
from portbench.tests import tiny


def counted(config, questions):
    # the parameters' shapes, of the model the card's run builds; on the
    # CPU it computes in float32, which program.model refuses for the cells
    net = program.build_model(None, torch.device("cpu"),
                              program.model_config(config))
    P = {k: torch.empty(v.shape, device="meta")
         for k, v in net.named_parameters()}
    f, t = config["frame_size"], config["frame_sample_size"]
    n = sum(config["temporal_scale"])
    clips = torch.empty((questions, n, t, f, f, 3), dtype=torch.uint8,
                        device="meta")
    ids = torch.empty((questions, config["text_seq_len"]), dtype=torch.long,
                      device="meta")
    with FlopCounterMode(display=False) as fc:
        R.forward(R.Numerics(), P, config, clips, ids, ids, ids)
    return fc.get_total_flops()


@pytest.mark.parametrize("name", ["tiny", "lrce-msvd", "lrce-msvd-16f"])
def test_the_count_is_the_reference_forwards_products(name):
    if name == "tiny":
        config, pieces = tiny.CONFIG, Registry().counts("lrce-msvd").pieces
    else:
        config = json.loads((ROOT / "configs" / f"{name}.json").read_text())
        pieces = Registry().counts(name).pieces
    fwd = pieces(config, 2, train=False)
    assert sum(p.flops for p in fwd) == counted(config, 2)


def test_a_step_counts_its_backward_once_more_twice():
    config = tiny.CONFIG
    pieces = Registry().counts("lrce-msvd").pieces
    fwd = sum(p.flops for p in pieces(config, 3, train=False))
    first = [p.flops for p in pieces(config, 3, train=False)
             if p.name == "patch_embed"][0]
    step = sum(p.flops for p in pieces(config, 3, train=True))
    assert step == pytest.approx(3 * fwd - first)
