"""Video Swin-L at 384 x 384 as LRCE's video tower (``swin3d.SWIN_LARGE``),
on the CPU at a small Swin-L-shaped size, against the benchmark's plain
reference (``portbench/reference/lrce.py``: float32 tensor code that
imports nothing of the port), and the shape rules that route its stages.

The small model keeps what Swin-L forces: head_dim 32, the window
(8, 12, 12), which 5-frame clips clamp to (3, 12, 12), so N = 432 in every
window, shifted (0, 6, 6) and not at stage 0, and a last stage whose window
is the whole 12 x 12 map (no shift). Its widths are cut (C = 32 / 64, one
and two heads; the published 192 / 384 / 768 / 1536 and 6 / 12 / 24 / 48
keep head_dim 32 too), and BERT and the fusion are the tiny ones of the
other CPU tests. On the CPU the kernel wrappers run their plain versions,
so this holds the route (K1 / K3 and their backward K6 + K5 + K4 at N =
432) to the reference; the kernels themselves are held to these plain
versions on the card (``tests/test_torch_cuda_kernels.py``).
"""

import pytest
import torch

from lrce_tpu_torch.models import bert as PB
from lrce_tpu_torch.models import e2e as PE
from lrce_tpu_torch.models import swin3d as PS
from lrce_tpu_torch.ops import window_attn as WA
from lrce_tpu_torch.utils import trace
from portbench.reference import lrce as R

FRAMES, SIZE, B = 5, 96, 2      # stage 0: (3, 24, 24), four (3, 12, 12) windows
SWIN = {"patch_size": [2, 4, 4], "embed_dim": 32, "depths": [2, 2],
        "num_heads": [1, 2], "window_size": [8, 12, 12], "mlp_ratio": 4.0,
        "drop_path_rate": 0.0}
BERT = {"vocab_size": 200, "hidden_size": 24, "num_layers": 2,
        "num_heads": 2, "intermediate_size": 48,
        "max_position_embeddings": 40, "type_vocab_size": 2,
        "hidden_dropout": 0.0, "attention_dropout": 0.0}
CONFIG = {"num_classes": 10, "feature_dim": 24, "text_seq_len": 8,
          "drop_out_rate": 0.0, "swin": SWIN, "bert": BERT,
          "fusion": {"num_layers": 12, "num_heads": 12}}
# f32 on both sides: the same expressions summed in another order (the
# port's attention by windows of the kernels' plain versions, LayerNorm
# over rows in f32); relative L2 of logits of order 1
LOGITS_TOL = 1e-4
# gradients pass back through 4 Swin blocks, 2 BERT layers and 12 fusion
# layers of the same f32 expressions: relative L2 per parameter, or 1e-6
# of the largest gradient where a parameter's own is near zero
GRAD_TOL = 1e-3


def swin_cfg() -> PS.SwinConfig:
    return PS.SwinConfig(**{k: tuple(v) if isinstance(v, list) else v
                            for k, v in SWIN.items()})


def model() -> PE.LRCEModel:
    cfg = PE.E2EConfig(
        feature_dim=24, num_classes=10, video_feature_res=(12, 12),
        video_feature_dim=64, frame_sample_size=FRAMES, temporal_scale=(3,),
        text_seq_len=8, task_type="oe", drop_out_rate=0.0,
        bert=PB.BertConfig(**{k: BERT[k] for k in PB.BertConfig._fields}),
        swin=swin_cfg())
    torch.manual_seed(0)
    net = PE.LRCEModel(cfg, device="cpu")
    with torch.no_grad():       # weights of order 0.02, gains near 1
        for name, p in net.named_parameters():
            p.normal_(1.0 if p.ndim == 1 and "norm" in name.lower()
                      and name.endswith("weight") else 0.0, 0.02)
    return net


def batch():
    g = torch.Generator().manual_seed(1)
    clips = torch.randint(0, 256, (B, 3, FRAMES, SIZE, SIZE, 3), generator=g,
                          dtype=torch.uint8)
    ids = torch.randint(103, 200, (B, 8), generator=g)
    mask = torch.ones((B, 8), dtype=torch.long)
    mask[:, 6:] = 0
    types = torch.zeros((B, 8), dtype=torch.long)
    labels = torch.tensor([3, 7])
    return clips, ids, mask, types, labels


def rel(a, b) -> float:
    return float((a - b).norm() / b.norm())


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_the_small_model_hits_swin_l_windows():
    """Stage 0 at (3, 24, 24): (3, 12, 12) windows of 432 tokens, shifted
    (0, 6, 6) in odd blocks; the last stage at (3, 12, 12): one window, no
    shift."""
    w0, s0 = PS.get_window_size((3, 24, 24), (8, 12, 12), (4, 6, 6))
    w1, s1 = PS.get_window_size((3, 12, 12), (8, 12, 12), (4, 6, 6))
    assert (w0, s0) == ((3, 12, 12), (0, 6, 6))
    assert (w1, s1) == ((3, 12, 12), (0, 0, 0))
    assert PS.SWIN_LARGE.embed_dim // PS.SWIN_LARGE.num_heads[0] == 32
    assert all(PS.SWIN_LARGE.embed_dim * 2 ** i // h == 32
               for i, h in enumerate(PS.SWIN_LARGE.num_heads))


@pytest.mark.parametrize("train", [False, True], ids=["forward", "step"])
def test_port_matches_the_plain_reference(train):
    """The forward logits (eval) or one training step's loss (cross entropy
    of the logits) and every parameter's gradient, port against the
    reference on the same weights and inputs."""
    net = model()
    clips, ids, mask, types, labels = batch()
    P = {k: v.detach().clone().requires_grad_(train)
         for k, v in net.named_parameters()}
    with torch.set_grad_enabled(train):
        ref = R.forward(R.Numerics(), P, CONFIG, clips, ids, mask, types)
    if not train:
        got = PE.e2e_forward(net, clips, ids, mask, types)
        assert got.shape == ref.shape == (B, 10)
        assert rel(got, ref) < LOGITS_TOL
        return
    gen = torch.Generator().manual_seed(2)
    got = PE.e2e_apply(net, clips, ids, mask, types, training=True,
                       generator=gen)
    loss = torch.nn.functional.cross_entropy(got, labels)
    ref_loss = torch.nn.functional.cross_entropy(ref, labels)
    assert abs(loss.item() - ref_loss.item()) < LOGITS_TOL * ref_loss.item()
    loss.backward()
    ref_loss.backward()

    def grad(p):    # a parameter that the forward does not read has none
        return torch.zeros_like(p) if p.grad is None else p.grad

    top = max(float(grad(p).norm()) for p in P.values())
    assert top > 0
    for name, p in net.named_parameters():
        want = grad(P[name])
        err = float((grad(p) - want).norm())
        assert err <= GRAD_TOL * max(float(want.norm()), 1e-6 * top), name


@pytest.mark.parametrize("n,hd,ok,cta", [
    (432, 32, True, "attn_fwd_big_kernel"),
    (432, 16, True, "attn_fwd_big_kernel"),
    (448, 32, True, "attn_fwd_big_kernel"),
    (392, 32, True, "attn_fwd_big_kernel"),
    (147, 32, True, "attn_fwd_kernel"),
    (1152, 32, False, None),
    (432, 64, False, None)])
def test_shape_rules(n, hd, ok, cta):
    """Swin-L's N = 432 takes the mma.sync CTA forward and K4's pair
    backward; the unclamped (8, 12, 12) window (N = 1152) and head_dim 64
    no kernel, forward or backward."""
    assert WA.attn_fwd_cta(n, hd) == cta
    assert WA.attn_supported(n, hd) is ok


@pytest.mark.parametrize("c,heads,ok", [(192, 6, True), (768, 24, True),
                                        (1024, 32, True), (1536, 48, True),
                                        (2048, 64, False), (1536, 32, True),
                                        (80, 5, False), (96, 4, False)])
def test_kernel_width_rule(c, heads, ok):
    """C a multiple of 32 up to 1536 and head_dim a multiple of 16: the
    rule that ``check_kernel_args`` and the route both read."""
    assert WA.kernel_width_supported(c, heads) is ok


def _spy_routes(monkeypatch):
    """The route each block takes, with every route stubbed out (the
    stage's own arithmetic is not what is tested here)."""
    seen = []

    def stub(name, ret):
        def f(*a, **k):
            seen.append(name)
            return ret(*a)
        monkeypatch.setattr(PS, name, f)

    stub("swin_block", lambda blk, x: x)
    stub("fused_swin_block", lambda x, *a: x)
    stub("fused_swin_pair", lambda x, *a: x)
    stub("fused_window_attention_hsplit", lambda x, *a: torch.zeros_like(x))
    stub("fused_ln_mlp", lambda x, *a: x)
    monkeypatch.setattr(PS.Mlp, "forward", lambda self, x: x)
    return seen


K2_LN_MLP = ["fused_window_attention_hsplit", "fused_ln_mlp"] * 2


@pytest.mark.parametrize("c,heads,dims,grad,k7,want", [
    # Swin-L's stage 3: one (3, 12, 12) window, no shift, K2 either way,
    # then LN2 + MLP through fused_ln_mlp, whose forward is the plain
    # version: K7 takes C <= 1024
    (1536, 48, (3, 12, 12), True, 0, K2_LN_MLP),
    (1536, 48, (3, 12, 12), False, 0, K2_LN_MLP),
    # C = 1536 on a (3, 24, 24) map: the shifted block rolls around K2
    (1536, 48, (3, 24, 24), True, 0, K2_LN_MLP),
    # Swin-L's stage 2 and Swin-B's stage 3: fused_ln_mlp's forward is K7
    (768, 24, (3, 24, 24), True, 2, K2_LN_MLP),
    # wider than any kernel takes: the plain block
    (2048, 64, (3, 12, 12), False, 0, ["swin_block"] * 2),
    # the unclamped (8, 12, 12) window, N = 1152: the plain block
    (64, 2, (8, 12, 12), True, 0, ["swin_block"] * 2),
    (64, 2, (8, 12, 12), False, 0, ["swin_block"] * 2),
    # a (4, 12, 12) window, N = 576, past the 448 tokens any kernel takes:
    # the plain block without grad too
    (64, 2, (4, 12, 12), False, 0, ["swin_block"] * 2),
    # N = 432 at stage 0 widths: K1 and K3 in either mode
    (192, 6, (3, 24, 24), True, 0, ["fused_swin_block", "fused_swin_pair"]),
    (768, 24, (3, 24, 24), False, 2, K2_LN_MLP),
    (1024, 32, (3, 12, 12), True, 2, K2_LN_MLP),
    (1024, 32, (3, 12, 12), False, 2, K2_LN_MLP),
], ids=["c1536-grad", "c1536-nograd", "c1536-lnmlp", "c768-lnmlp",
        "c2048", "n1152-grad", "n1152-nograd", "n576-nograd", "c192-n432",
        "c768-nograd",
        "c1024-grad", "c1024-nograd"])
def test_stage_route(monkeypatch, c, heads, dims, grad, k7, want):
    """The route never sends a stage to a kernel that refuses it. It is
    chosen by shape alone: every K2-route block (C > 512) runs LN2 + MLP
    through ``fused_ln_mlp``, which the tracer counts, with the blocks whose
    forward is K7 (C <= 1024) apart."""
    cfg = PS.SwinConfig(embed_dim=c, depths=(2,), num_heads=(heads,),
                        window_size=(8, 12, 12))
    with torch.device("meta"):
        layer = PS.BasicLayer(c, 2, heads, cfg, False, torch.float32,
                              None)
        x = torch.empty((1, *dims, c))
    seen = _spy_routes(monkeypatch)
    trace.enable(detail=True)
    try:
        with torch.set_grad_enabled(grad):
            layer(x, True, PS.DeviceConstants())
    finally:
        trace.disable()
        counters = trace.drain()[1]
    assert seen == want
    assert counters.get("swin.wide_mlp_fused", 0) == want.count("fused_ln_mlp")
    assert counters.get("swin.wide_mlp_k7", 0) == k7


def test_a_model_config_names_the_tower(tmp_path, monkeypatch):
    """The train CLI's model config selects Swin-L by its ``swin`` key, and
    its frames by ``frame_size``; without them, Swin-B at 224."""
    import json
    import pickle

    from lrce_tpu_torch import config as PC
    from lrce_tpu_torch.cli import train as CT

    cfg = PC.load_model_config("msvd-qa-oe")
    argv = ["--dataset", "msvd-qa-oe", "--dataset-dir", str(tmp_path)]
    base = PC.parse_arg_train(argv)
    assert PE.config_from_args(base).swin == PS.SWIN_BASE
    cfg.update(swin="large", frame_size=384, video_feature_res=[12, 12],
               video_feature_dim=1536)
    (tmp_path / "msvd-qa-oe.json").write_text(json.dumps(cfg))
    large = PC.parse_arg_train(argv, config_dir=str(tmp_path))
    e2e = PE.config_from_args(large)
    assert e2e.swin == PS.SWIN_LARGE and e2e.video_feature_dim == 1536
    seen = {}

    class Spy:
        def __init__(self, *a, **k):
            seen.update(k)

    with open(tmp_path / "idx-video-mapping.pkl", "wb") as f:
        pickle.dump({}, f)
    monkeypatch.setattr(CT, "E2EMicrosoftDataset", Spy)
    CT.build_datasets(large, splits=("train",))
    assert seen["frame_size"] == (384, 384)
    CT.build_datasets(base, splits=("train",))
    assert seen["frame_size"] == (224, 224)
