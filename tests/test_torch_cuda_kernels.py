"""The CUDA kernels K1-K8 against their plain PyTorch versions on the card,
bf16, at a small geometry (K7 and K5 also at C = 1024, K7 at one request's
and one train step's T with one launch a call and bit-identical repeats,
K8 at C = 128, 256 and 512 likewise; the
shared wgmma GEMMs on their own at ragged shapes; K4 and K5 at the
flagship's stage 0 and stage 3 widths and twice over for bit-identity; the
attention-forward CTA on its own at the flagship's window and at the edges
of its range, and the WMMA CTA that takes the shapes beyond it), the
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
from lrce_tpu_torch.ops import gemm as G
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


def _kernel_launches(fn):
    """fn's result and the kernels one call of it launched (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    return out, sum(1 for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA)


# (B, D, H, W, C), FF: the narrow test geometry; stage 3 at 3 clips (T = 441:
# an odd sample count and a row tail past the 128-row tile), at one request
# (6 clips, fc2 split over FF) and at a train step (48 clips, unsplit)
K7_SHAPES = {"c64": ((2, 2, 6, 9, 64), 256), "stage3": ((3, 3, 7, 7, 1024), 4096),
             "stage3-6clips": ((6, 3, 7, 7, 1024), 4096),
             "stage3-48clips": ((48, 3, 7, 7, 1024), 4096)}


@pytest.mark.parametrize("with_dp", [False, True], ids=["no-dp", "dp"])
@pytest.mark.parametrize("shape", list(K7_SHAPES))
def test_k7(dev, shape, with_dp):
    """One launch a call, within the limits of the plain version, and a
    second call equal to the first bit for bit."""
    dims, ff = K7_SHAPES[shape]
    x, _, args, dp = _mlp_args(np.random.default_rng(10), dev, dims, ff)
    dp = dp if with_dp else None
    before = SB.fused_ln_mlp.launches
    with torch.no_grad():
        got = SB.fused_ln_mlp(x, *args, dp)
        again, kernels = _kernel_launches(lambda: SB.fused_ln_mlp(x, *args, dp))
    assert SB.fused_ln_mlp.launches == before + 2
    assert kernels == 1
    _close(got, SB.ln_mlp_plain(x, *args, dp))
    assert torch.equal(got, again)


@pytest.mark.parametrize("shape", [((2, 2, 6, 9, 64), 256),
                                   ((2, 3, 56, 56, 128), 512),
                                   ((2, 3, 28, 28, 256), 1024),
                                   ((3, 3, 7, 7, 512), 2048)],
                         ids=["c64", "stage0", "c256", "c512"])
def test_k8(dev, shape):
    """C = 128 / 256 on the back half's core, the other widths on K7's
    kernel (``mlp_route``): one launch a call, bit-identical repeats."""
    dims, ff = shape
    x, _, args, _ = _mlp_args(np.random.default_rng(11), dev, dims, ff)
    before = M.fused_mlp.launches
    with torch.no_grad():
        got = M.fused_mlp(x, *args)
        again, kernels = _kernel_launches(lambda: M.fused_mlp(x, *args))
    assert M.fused_mlp.launches == before + 2
    assert kernels == 1
    _close(got, M.fused_mlp_plain(x, *args))
    assert torch.equal(got, again)


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


# ---------------------------------------------------------------------------
# the shared GEMMs on their own, K5 and K4 at the flagship widths
# ---------------------------------------------------------------------------

def _bf(rng, dev, shape, scale=1.0):
    return torch.tensor(scale * rng.normal(size=shape), dtype=torch.float32,
                        device=dev).bfloat16()


# (M, N, K): row tails against the 128-row tile (441 = 3 x 128 + 57, 882,
# 7056 = 55 x 128 + 16), the narrowest and widest N and K of the flagship;
# fewer tiles than SMs (441 x 192) and many per consumer warpgroup
GEMM_SHAPES = [(441, 384, 128), (882, 4096, 128), (7056, 384, 4096),
               (441, 4096, 4096), (441, 192, 64), (7056, 1024, 512),
               (28224, 512, 2048)]
# the qkv products of stages 0 and 1 at 6 clips (the 128 x 128 tile, many
# tiles per SM of the persistent grid) and the four of stage 2 at 48 clips
# (the 128 x 256 tile)
GEMM_STAGE_SHAPES = [(56448, 384, 128), (14112, 768, 256), (28224, 1536, 512),
                     (28224, 512, 512), (28224, 2048, 512)]
GEMM_CASES = [(m, False) for m in G.EPI_MODES] + [(G.EPI_ATTN_OUT, True)]


@pytest.mark.parametrize("mode,b_kn", GEMM_CASES,
                         ids=["bias", "bias-gelu", "attn-out", "mlp-out",
                              "attn-out-kn"])
@pytest.mark.parametrize("shape", GEMM_SHAPES + GEMM_STAGE_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_gemm_epilogues_at_ragged_shapes(dev, shape, mode, b_kn):
    m, n, k = shape
    rng = np.random.default_rng(20)
    a = _bf(rng, dev, (m, k))
    b = _bf(rng, dev, (k, n) if b_kn else (n, k), 1.0 / np.sqrt(k))
    bias = torch.tensor(0.1 * rng.normal(size=n), dtype=torch.float32,
                        device=dev)
    res = _bf(rng, dev, (m, n))
    dp_rows = 147
    dp = torch.tensor(rng.binomial(1, 0.7, -(-m // dp_rows)) / 0.7,
                      dtype=torch.float32, device=dev)
    kw = dict(mode=mode, bias=bias, b_kn=b_kn)
    if mode in (G.EPI_ATTN_OUT, G.EPI_MLP_OUT):
        kw.update(dp=dp, dp_rows=dp_rows, res=res)
    before = G.gemm_bf16.launches
    got = G.gemm_bf16(a, b, **kw)
    assert G.gemm_bf16.launches == before + 1
    _close(got, G.gemm_bf16_plain(a, b, **kw))


@pytest.mark.parametrize("shape,splits", [((3001, 384, 128), None),
                                          ((3001, 384, 128), 1),
                                          ((882, 4096, 1024), None),
                                          ((7056, 64, 192), 5)],
                         ids=["ragged", "one-split", "stage3", "narrow"])
def test_gemm_tn_at_a_ragged_token_count(dev, shape, splits):
    m, n, k = shape
    rng = np.random.default_rng(21)
    g, a = _bf(rng, dev, (m, n)), _bf(rng, dev, (m, k))
    got = G.gemm_tn(g, a, splits)
    _close(got, G.gemm_tn_plain(g, a), rel=1e-4, max_rel=1e-4)
    assert torch.equal(got, G.gemm_tn(g, a, splits))


# stage 0 (FF = 512: four column tiles) and a ragged token count
@pytest.mark.parametrize("with_dp", [False, True], ids=["no-dp", "dp"])
@pytest.mark.parametrize("dims,ff", [((3, 3, 14, 7, 128), 512),
                                     ((3, 3, 7, 7, 1024), 4096)],
                         ids=["c128", "c1024"])
def test_k5_at_flagship_widths_twice(dev, dims, ff, with_dp):
    x, g, args, dp = _mlp_args(np.random.default_rng(22), dev, dims, ff)
    k5 = (x, g, *args[:5], dp if with_dp else None, 1e-5)
    got = SB.mlp_bwd(*k5)
    for a, b in zip(got, SB.mlp_bwd_plain(*k5)):
        _close(a, b)
    for a, b in zip(got, SB.mlp_bwd(*k5)):
        assert torch.equal(a, b)    # fixed-order sums: bit-identical


def _k4_case(rng, dev, dims, heads, window, shift):
    b, d, h, w, c = dims
    n = window[0] * window[1] * window[2]
    x, g = _bf(rng, dev, dims), _bf(rng, dev, dims)

    def vec(m, scale, base=0.0):
        return torch.tensor(base + scale * rng.normal(size=m),
                            dtype=torch.float32, device=dev)

    mask = None
    if any(shift):
        nwin = (d // window[0], h // window[1], w // window[2])
        mask = torch.from_numpy(compute_shift_mask((d, h, w), window, shift)
                                .reshape(*nwin, n, n)).to(dev)
    return (x, g, vec(c, 0.2, 1.0), vec(c, 0.1),
            _bf(rng, dev, (3 * c, c), 1.0 / np.sqrt(c)), vec(3 * c, 0.02),
            _bf(rng, dev, (c, c), 1.0 / np.sqrt(c)),
            vec((heads, n, n), 1.0), mask, window, heads, 1e-5, shift)


# stage 0: 5 clips x 8 windows = 40 windows against 33 groups of 4 heads on
# 132 SMs, and stage 3: 5 windows against 4 groups of 32 heads: window
# counts that are no multiple of the groups
@pytest.mark.parametrize("shift", [(0, 0, 0), (0, 3, 3)],
                         ids=["unmasked", "masked"])
@pytest.mark.parametrize("dims,heads", [((5, 3, 28, 14, 128), 4),
                                        ((5, 3, 7, 7, 1024), 32)],
                         ids=["stage0", "stage3"])
def test_k4_at_flagship_widths_twice(dev, dims, heads, shift):
    case = _k4_case(np.random.default_rng(23), dev, dims, heads, (3, 7, 7),
                    shift)
    nwin = dims[0] * (dims[2] // 7) * (dims[3] // 7)
    assert nwin % WA.attn_bwd_groups(nwin, heads, WA.sm_count(case[0]))
    got = WA.window_attention_bwd(*case)
    for a, b in zip(got, WA.window_attention_bwd_plain(*case)):
        _close(a, b)
    for a, b in zip(got, WA.window_attention_bwd(*case)):
        assert torch.equal(a, b)    # fixed-order sums: bit-identical


# ---------------------------------------------------------------------------
# the attention-forward CTA on its own
# ---------------------------------------------------------------------------

def _core_case(rng, dev, clips, nwin_clip, n, hd, heads, mask_kind):
    """qkv (clips * nwin_clip, n, 3C) bf16, rel_bias, mask on the card. The
    mask: None, "labels" (0 / -100 by random region labels, as a shift mask),
    "dense" (arbitrary values), or "mixed" (one window of a label mask made
    three-valued, so only that window reads the dense mask)."""
    c = heads * hd
    qkv = _bf(rng, dev, (clips * nwin_clip, n, 3 * c))
    rel = torch.tensor(rng.normal(size=(heads, n, n)), dtype=torch.float32,
                       device=dev)
    mask = None
    if mask_kind == "dense":
        mask = rng.normal(size=(nwin_clip, n, n)) * 3.0
    elif mask_kind in ("labels", "mixed"):
        lab = rng.integers(0, 3, size=(nwin_clip, n))
        mask = np.where(lab[:, :, None] != lab[:, None, :], -100.0, 0.0)
        if mask_kind == "mixed":
            i, j = np.argwhere(mask[0] != 0)[0]
            mask[0, i, j] = -50.0
    if mask is not None:
        mask = torch.tensor(mask, dtype=torch.float32, device=dev)
    return qkv, rel, mask, heads


# (clips, windows per clip, N, head_dim, heads): the flagship's window at
# stage 0 width with more windows than the 33 groups of a 132-SM card and a
# count that is no multiple of them; stage 3 (32 heads, fewer windows than
# groups); N = 98 (window (2, 7, 7)); a full 160-token window; N = 8 with
# head_dim 16; one window
CORE_SHAPES = {"n147-hd32": (5, 8, 147, 32, 4), "stage3": (3, 1, 147, 32, 32),
               "n98-hd32": (2, 4, 98, 32, 8), "n160": (2, 2, 160, 32, 4),
               "n8-hd16": (3, 4, 8, 16, 2), "one-window": (1, 1, 147, 32, 4),
               "n147-hd16": (2, 2, 147, 16, 4)}


@pytest.mark.parametrize("mask_kind", [None, "labels", "dense", "mixed"],
                         ids=["unmasked", "labels", "dense", "mixed"])
@pytest.mark.parametrize("shape", list(CORE_SHAPES))
def test_attn_core(dev, shape, mask_kind):
    case = _core_case(np.random.default_rng(30), dev, *CORE_SHAPES[shape],
                      mask_kind)
    before = WA.window_attention_core.launches
    got = WA.window_attention_core(*case)
    assert WA.window_attention_core.launches == before + 1
    _close(got, WA.window_attention_core_plain(*case))
    assert torch.equal(got, WA.window_attention_core(*case))    # no atomics
    if mask_kind in ("labels", "mixed"):
        off = WA.mask_label_args(case[2])[1]
        assert int(torch.isnan(off).sum()) == (mask_kind == "mixed")
    if mask_kind == "dense":
        assert bool(torch.isnan(WA.mask_label_args(case[2])[1]).all())


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("n,hd,heads", [(392, 32, 2), (147, 64, 2),
                                        (98, 48, 2)],
                         ids=["n392", "hd64", "hd48"])
def test_attn_core_beyond_the_new_kernels_range(dev, n, hd, heads, masked):
    """N > 160 or a head_dim other than 16 or 32 runs the WMMA CTA."""
    case = _core_case(np.random.default_rng(31), dev, 2, 2, n, hd, heads,
                      "labels" if masked else None)
    _close(WA.window_attention_core(*case),
           WA.window_attention_core_plain(*case))


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_k6_with_the_constructor_window(dev, masked):
    """K6 on a 16-frame clip's window (8, 7, 7), N = 392: the shape rule of
    the attention launcher takes the WMMA CTA, and nothing raises."""
    rng = np.random.default_rng(32)
    window, shift = (8, 7, 7), ((4, 3, 3) if masked else SHIFT0)
    case = _k4_case(rng, dev, (1, 8, 14, 14, 64), 2, window, shift)
    x, _, ln_s, ln_b, qkv_w, qkv_b, proj_w, rel, mask = case[:9]
    proj_b = torch.tensor(0.02 * rng.normal(size=64), dtype=torch.float32,
                          device=dev)
    args = (x, ln_s, ln_b, qkv_w, qkv_b, proj_w, proj_b, rel, mask, window, 2,
            1e-5, shift)
    _close(WA.fused_window_attention(*args), WA.window_attention_plain(*args))


@pytest.mark.parametrize("gather,shift", [(False, SHIFT0), (True, SHIFT0),
                                          (True, SHIFT)],
                         ids=["token-order", "window-order", "shifted"])
def test_ln_rows(dev, gather, shift):
    x, args = _args(np.random.default_rng(34), dev)
    before = G.ln_rows.launches
    got = G.ln_rows(x, args[0], args[1], WINDOW, shift, 1e-5, gather)
    assert G.ln_rows.launches == before + 1
    _close(got, G.ln_rows_plain(x, args[0], args[1], WINDOW, shift, 1e-5,
                                gather))


def test_attn_core_refuses_f32(dev):
    qkv, rel, _, heads = _core_case(np.random.default_rng(33), dev, 1, 1, 147,
                                    32, 4, None)
    with pytest.raises(TypeError, match="bfloat16"):
        WA.window_attention_core(qkv.float(), rel, None, heads)
    with pytest.raises(ValueError, match="multiple of 16"):
        WA.window_attention_core(qkv[..., :3 * 4 * 24].contiguous(), rel, None,
                                 heads)


# ---------------------------------------------------------------------------
# K1 / K3's one-launch back half (csrc/back_half.cu) at stages 0 and 1, and
# a train step at N = 392, where K4 refuses the geometry
# ---------------------------------------------------------------------------

def _back_half_case(rng, dev, dims, with_dp):
    b, d, h, w, c = dims
    ff = 4 * c

    def vec(m, scale, base=0.0):
        return torch.tensor(base + scale * rng.normal(size=m),
                            dtype=torch.float32, device=dev)

    dp = [torch.tensor(rng.binomial(1, 0.7, b) / 0.7, dtype=torch.float32,
                       device=dev) if with_dp else None for _ in range(2)]
    return (_bf(rng, dev, (b * d * h * w, c)), _bf(rng, dev, dims),
            _bf(rng, dev, (c, c), 1.0 / np.sqrt(c)), vec(c, 0.02),
            vec(c, 0.2, 1.0), vec(c, 0.1), _bf(rng, dev, (ff, c), 1.0 / np.sqrt(c)),
            vec(ff, 0.02), _bf(rng, dev, (c, ff), 1.0 / np.sqrt(ff)),
            vec(c, 0.02), *dp)


# the flagship's widths of stages 0 and 1 with its window; 1176 and 294
# rows are no multiple of the 128-row tile
@pytest.mark.parametrize("with_dp", [False, True], ids=["no-dp", "dp"])
@pytest.mark.parametrize("shift", [(0, 0, 0), (0, 3, 3)],
                         ids=["unshifted", "shifted"])
@pytest.mark.parametrize("dims", [(2, 3, 14, 14, 128), (2, 3, 7, 7, 256)],
                         ids=["c128", "c256"])
def test_back_half_at_flagship_widths_twice(dev, dims, shift, with_dp):
    args = _back_half_case(np.random.default_rng(30), dev, dims, with_dp)
    before = SB.swin_back_half.launches
    got = SB.swin_back_half(*args, (3, 7, 7), shift)
    assert SB.swin_back_half.launches == before + 1
    _close(got, SB.back_half_plain(*args, (3, 7, 7), shift))
    assert torch.equal(got, SB.swin_back_half(*args, (3, 7, 7), shift))


@pytest.mark.parametrize("c,heads", [(128, 4), (256, 8)])
def test_k1_k3_at_stages_0_1_run_the_back_half(dev, c, heads):
    rng = np.random.default_rng(31)
    dims = (2, 3, 14, 14, c)
    x = _bf(rng, dev, dims)
    n = 147

    def vec(m, scale, base=0.0):
        return torch.tensor(base + scale * rng.normal(size=m),
                            dtype=torch.float32, device=dev)

    wts = [vec(c, 0.2, 1.0), vec(c, 0.1), _bf(rng, dev, (3 * c, c), c ** -0.5),
           vec(3 * c, 0.02), _bf(rng, dev, (c, c), c ** -0.5), vec(c, 0.02),
           vec((heads, n, n), 1.0), vec(c, 0.2, 1.0), vec(c, 0.1),
           _bf(rng, dev, (4 * c, c), c ** -0.5), vec(4 * c, 0.02),
           _bf(rng, dev, (c, 4 * c), (4 * c) ** -0.5), vec(c, 0.02)]
    mask = torch.from_numpy(compute_shift_mask((3, 14, 14), (3, 7, 7),
                                               (0, 3, 3))
                            .reshape(1, 2, 2, n, n)).to(dev)
    before = SB.swin_back_half.launches
    with torch.no_grad():
        k1 = (x, *wts[:7], None, *wts[7:], None, None, (3, 7, 7), heads)
        _close(SB.fused_swin_block(*k1), SB.swin_block_plain(*k1))
        k3 = (x, *(t[None] for t in wts[:7]), mask,
              *(t[None] for t in wts[7:]), None, None, (3, 7, 7), heads,
              ((0, 3, 3),))
        _close(SB.fused_swin_pair(*k3), SB.swin_pair_plain(*k3))
    assert SB.swin_back_half.launches == before + 2


def test_train_step_at_n392_matches_the_plain_route(dev):
    """16-frame clips: the window (8, 7, 7) holds N = 392 tokens at stages
    0-2, which K4 refuses, so those stages take the plain block with grad
    on; stage 3 (N = 128) takes the kernels. Loss and per-stage gradients
    within chip_smoke's route-parity limits (1e-2, 1e-1)."""
    from lrce_tpu_torch.models import swin3d as PS

    cfg = PS.SwinConfig(embed_dim=64, depths=(2, 2, 2, 2),
                        num_heads=(2, 4, 8, 16), drop_path_rate=0.0)
    model = PS.SwinTransformer3D(cfg, dtype=torch.bfloat16,
                                 generator=torch.Generator().manual_seed(0))
    model = model.to(dev)
    x = torch.randn((2, 16, 112, 112, 3),
                    generator=torch.Generator().manual_seed(1)).to(dev)
    x = x.bfloat16()
    before = (SB.fused_swin_block.launches, WA.window_attention_bwd.launches)

    # a fixed random projection of the output: the mean square of a
    # LayerNorm's output would not depend on its input
    proj = None

    def run(use_kernels):
        nonlocal proj
        model.use_kernels = use_kernels
        model.zero_grad(set_to_none=True)
        out = model(x).float()
        if proj is None:
            proj = torch.randn(out.shape, generator=torch.Generator()
                               .manual_seed(2)).to(dev)
        loss = (out * proj).mean() + out.square().mean()
        loss.backward()
        grads = [torch.cat([p.grad.float().reshape(-1) for p in layer.parameters()])
                 for layer in model.layers]
        return loss.item(), grads

    lk, gk = run(True)
    assert SB.fused_swin_block.launches > before[0]          # stage 3
    assert WA.window_attention_bwd.launches > before[1]
    lp, gp = run(False)
    assert np.isfinite(lk) and abs(lk - lp) <= 1e-2 * abs(lp)
    for a, b in zip(gk, gp):
        assert torch.isfinite(a).all()
        assert ((a - b).norm() / b.norm()).item() <= 1e-1
