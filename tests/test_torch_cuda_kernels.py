"""The CUDA kernels K1, K3, K2 against their plain PyTorch versions on the
card, bf16, at a small geometry. Every test needs a GPU and skips without
one. The file imports no JAX, so it runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_cuda_kernels.py -m cuda

Tolerance: relative L2 1e-2 and max |kernel - plain| <= 2e-2 * max |plain|,
a few bf16 ulps: both sides round at the same points but sum in other
orders, and the plain GEMMs round their product once more before the bias.
"""

import numpy as np
import pytest
import torch

from lrce_tpu_torch.models.swin3d import compute_shift_mask
from lrce_tpu_torch.ops import swin_block as SB
from lrce_tpu_torch.ops import window_attn as WA

B, D, H, W, C, HEADS = 2, 2, 6, 9, 64, 4
WINDOW = (2, 3, 3)
SHIFT = (1, 1, 1)
N = WINDOW[0] * WINDOW[1] * WINDOW[2]
NWIN = (D // WINDOW[0], H // WINDOW[1], W // WINDOW[2])

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (sm_90a) and nvcc")
    return torch.device("cuda")


def _args(rng, dev, k=None, masked=False, dp_shape=None):
    """x and the wrappers' arguments after x, on the card: weight matrices
    bf16 (nn.Linear layout), the rest f32."""
    lead = () if k is None else (k,)

    def mat(o, i):
        a = rng.normal(size=lead + (o, i)) / np.sqrt(i)
        return torch.tensor(a, dtype=torch.float32, device=dev).bfloat16()

    def vec(m, scale, base=0.0):
        a = base + scale * rng.normal(size=lead + (m,))
        return torch.tensor(a, dtype=torch.float32, device=dev)

    def dp():
        if dp_shape is None:
            return None
        a = rng.binomial(1, 0.7, dp_shape) / 0.7
        return torch.tensor(a, dtype=torch.float32, device=dev)

    mask = None
    if masked:
        m = compute_shift_mask((D, H, W), WINDOW, SHIFT).reshape(*NWIN, N, N)
        mask = torch.from_numpy(m).to(dev)
    x = torch.tensor(rng.normal(size=(B, D, H, W, C)), dtype=torch.float32,
                     device=dev).bfloat16()
    rel = torch.tensor(rng.normal(size=lead + (HEADS, N, N)),
                       dtype=torch.float32, device=dev)
    return x, [vec(C, 0.2, 1.0), vec(C, 0.1), mat(3 * C, C), vec(3 * C, 0.02),
               mat(C, C), vec(C, 0.02), rel, mask, vec(C, 0.2, 1.0),
               vec(C, 0.1), mat(4 * C, C), vec(4 * C, 0.02), mat(C, 4 * C),
               vec(C, 0.02), dp(), dp()]


def _close(got, want):
    torch.cuda.synchronize()
    g, w = got.float(), want.float()
    assert torch.isfinite(g).all()
    assert ((g - w).norm() / w.norm()).item() < 1e-2
    assert (g - w).abs().max().item() < 2e-2 * w.abs().max().item()


@pytest.mark.parametrize("masked,dp", [(False, False), (True, True)])
def test_k1(dev, masked, dp):
    x, args = _args(np.random.default_rng(0), dev, masked=masked,
                    dp_shape=(B, 1) if dp else None)
    before = SB.fused_swin_block.launches
    got = SB.fused_swin_block(x, *args, WINDOW, HEADS)
    assert SB.fused_swin_block.launches == before + 1
    _close(got, SB.swin_block_plain(x, *args, WINDOW, HEADS))


@pytest.mark.parametrize("shifts", [(SHIFT,), ((0, 0, 0), SHIFT)],
                         ids=["k1", "k2"])
def test_k3(dev, shifts):
    x, args = _args(np.random.default_rng(1), dev, k=len(shifts), masked=True,
                    dp_shape=(len(shifts), B))
    got = SB.fused_swin_pair(x, *args, WINDOW, HEADS, shifts)
    _close(got, SB.swin_pair_plain(x, *args, WINDOW, HEADS, shifts))


@pytest.mark.parametrize("masked", [False, True])
def test_k2(dev, masked):
    x, args = _args(np.random.default_rng(2), dev, masked=masked)
    got = WA.fused_window_attention_hsplit(x, *args[:8], WINDOW, HEADS)
    _close(got, WA.window_attention_plain(x, *args[:8], WINDOW, HEADS))


def test_kernels_refuse_f32(dev):
    x, args = _args(np.random.default_rng(3), dev)
    args = [None if a is None else a.float() for a in args]
    with pytest.raises(TypeError, match="bfloat16"):
        SB.fused_swin_block(x.float(), *args, WINDOW, HEADS)
