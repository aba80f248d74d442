"""The CUDA kernels K1-K8 against their plain PyTorch versions on the card,
bf16, at a small geometry (K7 and K5 also at C = 1024, K8 at C = 128), the
K1 / K3 / K2 / K7 autograd.Functions' gradients against torch autograd
through the plain versions, and the prefetcher's side-stream copies against
blocking ones. Every test needs a GPU and skips without one. The file
imports no JAX, so it runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_cuda_kernels.py -m cuda

Tolerance: relative L2 1e-2 and max |kernel - plain| <= 2e-2 * max |plain|,
a few bf16 ulps: both sides round at the same points but sum in other
orders, so an intermediate that lands near a bf16 rounding boundary rounds
the other way now and then. Gradients: relative L2 3e-2 and max-abs
6e-2 * max |plain|: the custom backward rounds at the JAX kernels' points
(dctx, pb, dS, dq/dk/dv, dpre, the recomputed h1), which autograd through
the plain forward does not, and a weight gradient sums thousands of such
products.
"""

import numpy as np
import pytest
import torch

from lrce_tpu_torch.data.prefetch import device_prefetch
from lrce_tpu_torch.models.swin3d import compute_shift_mask
from lrce_tpu_torch.ops import mlp as M
from lrce_tpu_torch.ops import nn as NN
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


def _close(got, want, rel=1e-2, max_rel=2e-2):
    torch.cuda.synchronize()
    g, w = got.float(), want.float()
    assert torch.isfinite(g).all()
    assert ((g - w).norm() / w.norm()).item() < rel
    assert (g - w).abs().max().item() < max_rel * w.abs().max().item()


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


SHIFT0 = (0, 0, 0)


@pytest.mark.parametrize("masked", [False, True], ids=["unshifted", "shifted"])
def test_k6(dev, masked):
    x, args = _args(np.random.default_rng(4), dev, masked=masked)
    shift = SHIFT if masked else SHIFT0
    before = WA.fused_window_attention.launches
    got = WA.fused_window_attention(x, *args[:8], WINDOW, HEADS, 1e-5, shift)
    assert WA.fused_window_attention.launches == before + 1
    _close(got, WA.window_attention_plain(x, *args[:8], WINDOW, HEADS, 1e-5,
                                          shift))


@pytest.mark.parametrize("masked", [False, True], ids=["unshifted", "shifted"])
def test_k4(dev, masked):
    rng = np.random.default_rng(5)
    x, args = _args(rng, dev, masked=masked)
    g = torch.tensor(rng.normal(size=x.shape), dtype=torch.float32,
                     device=dev).bfloat16()
    shift = SHIFT if masked else SHIFT0
    bwd_args = (x, g, *args[:5], args[6], args[7], WINDOW, HEADS, 1e-5,
                shift)
    before = WA.window_attention_bwd.launches
    got = WA.window_attention_bwd(*bwd_args)
    assert WA.window_attention_bwd.launches == before + 1
    for a, b in zip(got, WA.window_attention_bwd_plain(*bwd_args)):
        _close(a, b)


@pytest.mark.parametrize("dp", [False, True])
def test_k5(dev, dp):
    rng = np.random.default_rng(6)
    x, args = _args(rng, dev, dp_shape=(B,) if dp else None)
    g = torch.tensor(rng.normal(size=x.shape), dtype=torch.float32,
                     device=dev).bfloat16()
    mlp_args = (x, g, *args[8:13], args[15], 1e-5)
    before = SB.mlp_bwd.launches
    got = SB.mlp_bwd(*mlp_args)
    assert SB.mlp_bwd.launches == before + 1
    for a, b in zip(got, SB.mlp_bwd_plain(*mlp_args)):
        _close(a, b)


def _grads(fn, x, params):
    x = x.detach().requires_grad_()
    leaves = [p.detach().requires_grad_() for p in params]
    out = fn(x, leaves)
    gen = torch.Generator(device=out.device).manual_seed(8)
    out.backward(torch.randn(out.shape, generator=gen, device=out.device,
                             dtype=out.dtype))
    return [x.grad] + [t.grad for t in leaves]


@pytest.mark.parametrize("kind", ["k1", "k3", "k2"])
def test_block_function_grads(dev, kind):
    """The custom backward (K6 + K5 + K4) against autograd through the
    plain version, the same bf16 inputs."""
    rng = np.random.default_rng(7)
    if kind == "k2":
        x, args = _args(rng, dev)
        weights = args[:7]

        def run(fn):
            return lambda x_, w: fn(x_, *w, None, WINDOW, HEADS)

        got = _grads(run(WA.fused_window_attention_hsplit), x, weights)
        want = _grads(run(WA.window_attention_plain), x, weights)
    else:
        k = 1
        x, args = _args(rng, dev, k=k, masked=True, dp_shape=(k, B))
        mask, dp1, dp2 = args[7], args[14], args[15]
        weights = args[:7] + args[8:14]
        if kind == "k1":
            weights = [w[0] for w in weights]

            def run(fn):
                return lambda x_, w: fn(x_, *w[:7], mask, *w[7:], dp1[0],
                                        dp2[0], WINDOW, HEADS)

            got = _grads(run(SB.fused_swin_block), x, weights)
            want = _grads(run(SB.swin_block_plain), x, weights)
        else:
            def run(fn):
                return lambda x_, w: fn(x_, *w[:7], mask, *w[7:], dp1, dp2,
                                        WINDOW, HEADS, (SHIFT,))

            got = _grads(run(SB.fused_swin_pair), x, weights)
            want = _grads(run(SB.swin_pair_plain), x, weights)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        _close(a, b, rel=3e-2, max_rel=6e-2)


def test_matmul_f32_backward_matches_the_upcast_product(dev):
    """aten::mm.dtype through _MatmulF32 against the upcast f32 product that
    the CPU runs, for an f32 cotangent that is not bf16-exact: the forward
    equal up to summation order, dx and dw within one bf16 ulp; without
    grad mode the same forward."""
    rng = np.random.default_rng(9)
    x = torch.tensor(rng.normal(size=(300, 96)), dtype=torch.float32)
    w = torch.tensor(rng.normal(size=(80, 96)) / 10, dtype=torch.float32)
    c = torch.tensor(rng.normal(size=(300, 80)), dtype=torch.float32)
    outs, grads = [], []
    for d in (dev, torch.device("cpu")):
        xt = x.to(d).bfloat16().requires_grad_()
        wt = w.to(d).bfloat16().requires_grad_()
        y = NN.matmul_f32(xt, wt)
        (y * c.to(d)).sum().backward()
        outs.append(y.detach().cpu())
        grads.append((xt.grad.float().cpu(), wt.grad.float().cpu()))
        if d.type == "cuda":
            with torch.no_grad():
                assert torch.equal(NN.matmul_f32(xt, wt), y.detach())
    torch.testing.assert_close(outs[0], outs[1], rtol=1e-5, atol=1e-5)
    for got, want in zip(*grads):
        assert (got - want).abs().le(want.abs() * 2.0 ** -7).all()


# ---------------------------------------------------------------------------
# K7, K8, and K5 at stage-3 width
# ---------------------------------------------------------------------------

def _mlp_args(rng, dev, shape, ff):
    """x, g, [ln_s, ln_b, w1, b1, w2, b2], dp (B,) on the card."""
    c = shape[-1]

    def f32(a):
        return torch.tensor(a, dtype=torch.float32, device=dev)

    x = f32(rng.normal(size=shape)).bfloat16()
    g = f32(rng.normal(size=shape)).bfloat16()
    args = [f32(1.0 + 0.2 * rng.normal(size=c)), f32(0.1 * rng.normal(size=c)),
            f32(rng.normal(size=(ff, c)) / np.sqrt(c)).bfloat16(),
            f32(0.02 * rng.normal(size=ff)),
            f32(rng.normal(size=(c, ff)) / np.sqrt(ff)).bfloat16(),
            f32(0.02 * rng.normal(size=c))]
    dp = f32(rng.binomial(1, 0.7, shape[0]) / 0.7)
    return x, g, args, dp


# (B, D, H, W, C), FF: the narrow test geometry; stage 3 with a row tail
# (T = 441 is no multiple of the 128-row GEMM tile) and rows enough for
# more than one slab of whole samples
K7_SHAPES = {"c64": ((2, 2, 6, 9, 64), 256), "stage3": ((3, 3, 7, 7, 1024), 4096),
             "stage3-slabs": ((16, 3, 7, 7, 1024), 4096)}


@pytest.mark.parametrize("with_dp", [False, True], ids=["no-dp", "dp"])
@pytest.mark.parametrize("shape", list(K7_SHAPES))
def test_k7(dev, shape, with_dp):
    dims, ff = K7_SHAPES[shape]
    x, _, args, dp = _mlp_args(np.random.default_rng(10), dev, dims, ff)
    dp = dp if with_dp else None
    before = SB.fused_ln_mlp.launches
    with torch.no_grad():
        got = SB.fused_ln_mlp(x, *args, dp)
    assert SB.fused_ln_mlp.launches == before + 1
    _close(got, SB.ln_mlp_plain(x, *args, dp))
    if shape == "stage3-slabs":
        t = dims[0] * dims[1] * dims[2] * dims[3]
        assert SB.mlp_slab_rows(t, ff, t // dims[0], with_dp) < t


@pytest.mark.parametrize("shape", [((2, 2, 6, 9, 64), 256),
                                   ((2, 3, 56, 56, 128), 512)],
                         ids=["c64", "stage0"])
def test_k8(dev, shape):
    dims, ff = shape
    x, _, args, _ = _mlp_args(np.random.default_rng(11), dev, dims, ff)
    before = M.fused_mlp.launches
    with torch.no_grad():
        got = M.fused_mlp(x, *args)
    assert M.fused_mlp.launches == before + 1
    _close(got, M.fused_mlp_plain(x, *args))


def test_k5_at_stage3_width(dev):
    x, g, args, dp = _mlp_args(np.random.default_rng(12), dev,
                               (3, 3, 7, 7, 1024), 4096)
    k5 = (x, g, *args[:5], dp, 1e-5)
    before = SB.mlp_bwd.launches
    got = SB.mlp_bwd(*k5)
    assert SB.mlp_bwd.launches == before + 1
    for a, b in zip(got, SB.mlp_bwd_plain(*k5)):
        _close(a, b)


@pytest.mark.parametrize("shape", ["c64", "stage3"])
def test_fused_ln_mlp_grads(dev, shape):
    """K7's custom backward (K5 + the LN2 input backward) against autograd
    through the plain version."""
    dims, ff = K7_SHAPES[shape]
    x, _, args, dp = _mlp_args(np.random.default_rng(13), dev, dims, ff)
    before = SB.mlp_bwd.launches
    got = _grads(lambda x_, w: SB.fused_ln_mlp(x_, *w, dp), x, args)
    assert SB.mlp_bwd.launches == before + 1
    want = _grads(lambda x_, w: SB.ln_mlp_plain(x_, *w, dp), x, args)
    for a, b in zip(got, want):
        _close(a, b, rel=3e-2, max_rel=6e-2)


def test_fused_mlp_grads_and_refusals(dev):
    dims, ff = K7_SHAPES["c64"]
    x, _, args, _ = _mlp_args(np.random.default_rng(14), dev, dims, ff)
    got = _grads(lambda x_, w: M.fused_mlp(x_, *w), x, args)
    want = _grads(lambda x_, w: M.fused_mlp_plain(x_, *w), x, args)
    for a, b in zip(got, want):
        _close(a, b, rel=3e-2, max_rel=6e-2)
    with pytest.raises(TypeError, match="bfloat16"):
        M.fused_mlp(x.float(), *(a.float() for a in args))
    with pytest.raises(ValueError, match="shape"):
        SB.fused_ln_mlp(x, *args, torch.ones(5, device=dev))


# ---------------------------------------------------------------------------
# the prefetcher
# ---------------------------------------------------------------------------

def test_prefetch_on_a_side_stream_equals_a_blocking_copy(dev):
    rng = np.random.default_rng(15)
    batches = [(rng.integers(0, 256, (4, 3, 5, 64, 64, 3), dtype=np.uint8),
                rng.integers(0, 30000, (4, 32)), rng.normal(size=(4,)))
               for _ in range(6)]
    seen = 0
    for got, want in zip(device_prefetch(iter(batches), dev, depth=2), batches):
        # consume on the current stream right away, as a train step does
        sums = [t.double().sum() for t in got]
        for t, s, a in zip(got, sums, want):
            blocking = torch.from_numpy(a).to(dev)
            assert t.device.type == "cuda" and t.dtype == blocking.dtype
            assert torch.equal(t, blocking)
            assert s.item() == blocking.double().sum().item()
        seen += 1
    assert seen == len(batches)
