"""The attention CTA's own entry (lrce_tpu_torch/ops/window_attn.py:
``window_attention_core``), on the CPU: its plain version inside the plain
versions of K6 / K2 against the body they had before the CTA got an entry of
its own (bit for bit) and against the JAX Pallas kernel
``fused_window_attention`` in interpret mode; the label form of the shift
mask that the CUDA kernel is handed; the grid helpers (both forward CTAs,
and which CTA a shape takes); the 16-frame window (N = 392) against the
Pallas kernel; and what the wrapper refuses. chip_smoke.py and
tests/test_torch_cuda_kernels.py hold the CUDA kernels to the plain version
on the card.

Tolerance against JAX 1e-4 (rtol and atol), f32: both sides compute the same
f32 expressions (LayerNorm, products, an exact softmax) and differ in
summation order, a few f32 ulps on outputs of order 1. Against the earlier
body: exact.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lrce_tpu.ops import pallas_window_attn as PWA
from lrce_tpu_torch.models.swin3d import compute_shift_mask
from lrce_tpu_torch.ops import window_attn as WA
from lrce_tpu_torch.ops.nn import dense, layer_norm, matmul_f32

TOL = dict(rtol=1e-4, atol=1e-4)
B, D, H, W, C, HEADS = 2, 2, 6, 9, 64, 4
WINDOW = (2, 3, 3)
SHIFT = (1, 1, 1)
N = WINDOW[0] * WINDOW[1] * WINDOW[2]
NWIN = (D // WINDOW[0], H // WINDOW[1], W // WINDOW[2])
SMS = 132   # an H100
# (tokens, C, heads) of the flagship's stages at 48 clips
STAGES = [(451584, 128, 4), (112896, 256, 8), (28224, 512, 16),
          (7056, 1024, 32)]


def _inputs(seed, dtype=torch.float32):
    """x and the weights in the port's layout (nn.Linear matrices), torch."""
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.from_numpy(a.astype(np.float32)).to(dtype)

    x = t(rng.normal(size=(B, D, H, W, C)))
    return x, dict(
        ln_s=t(1.0 + 0.2 * rng.normal(size=C)).float(),
        ln_b=t(0.1 * rng.normal(size=C)).float(),
        qkv_w=t(rng.normal(size=(3 * C, C)) / np.sqrt(C)),
        qkv_b=t(0.02 * rng.normal(size=3 * C)).float(),
        proj_w=t(rng.normal(size=(C, C)) / np.sqrt(C)),
        proj_b=t(0.02 * rng.normal(size=C)).float(),
        rel_bias=t(rng.normal(size=(HEADS, N, N))).float())


def _mask():
    return torch.from_numpy(compute_shift_mask((D, H, W), WINDOW, SHIFT)
                            .reshape(*NWIN, N, N))


def _earlier_attention_proj_f32(win, qkv_w, qkv_b, proj_w, proj_b, rel_bias,
                                mask, num_heads):
    """``attention_proj_f32`` as it was before it went through
    ``window_attention_core_plain``: the test's own reference."""
    nb, n, c = win.shape
    hd = c // num_heads
    dt = win.dtype
    qkv = dense(win, qkv_w, qkv_b).reshape(nb, n, 3, num_heads, hd)
    qkv = qkv.permute(2, 0, 3, 1, 4)
    q = (qkv[0].float() * (1.0 / math.sqrt(hd))).to(dt)
    k, v = qkv[1], qkv[2]
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
    if mask is None:
        logits = logits + rel_bias[None]
    else:
        nw = mask.shape[0] * mask.shape[1] * mask.shape[2]
        add = rel_bias[None, None] + mask.reshape(nw, n, n)[None, :, None]
        logits = (logits.reshape(nb // nw, nw, num_heads, n, n)
                  + add).reshape(nb, num_heads, n, n)
    e = torch.exp(logits - logits.amax(-1, keepdim=True))
    weights = e * (1.0 / e.sum(-1, keepdim=True))
    ctx = torch.matmul(weights.to(dt).float(), v.float()).to(dt)
    ctx = ctx.transpose(1, 2).reshape(nb, n, num_heads * hd)
    return matmul_f32(ctx, proj_w) + proj_b.float()


def _earlier_window_attention_plain(x, p, mask, shift):
    y = layer_norm(WA.roll_shift(x, shift, -1), p["ln_s"], p["ln_b"], 1e-5)
    out = _earlier_attention_proj_f32(
        WA.window_partition(y, WINDOW), p["qkv_w"], p["qkv_b"], p["proj_w"],
        p["proj_b"], p["rel_bias"], mask, HEADS).to(x.dtype)
    return WA.roll_shift(WA.window_reverse(out, WINDOW, B, D, H, W), shift, 1)


@pytest.fixture
def one_torch_thread():
    """One intra-op thread, so that both plain forms run the CPU matmul's
    same blocking whatever else the process runs beside them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.usefixtures("one_torch_thread")
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_plain_through_the_core_is_the_earlier_plain_bit_for_bit(masked,
                                                                 dtype):
    x, p = _inputs(0, dtype)
    mask, shift = (_mask(), SHIFT) if masked else (None, WA.NO_SHIFT)
    got = WA.window_attention_plain(
        x, p["ln_s"], p["ln_b"], p["qkv_w"], p["qkv_b"], p["proj_w"],
        p["proj_b"], p["rel_bias"], mask, WINDOW, HEADS, 1e-5, shift)
    assert torch.equal(got, _earlier_window_attention_plain(x, p, mask, shift))


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_core_between_ln_qkv_and_proj_matches_pallas(masked):
    """LN1, partition and qkv, then ``window_attention_core`` (on the CPU
    its plain version), then proj and reverse, against the Pallas kernel of
    K6 on the same pre-rolled input."""
    x, p = _inputs(1)
    mask = _mask() if masked else None
    sentinel = np.zeros((1,) * 5, np.float32)
    want = PWA.fused_window_attention(
        jnp.asarray(x.numpy()), jnp.asarray(p["ln_s"].numpy()),
        jnp.asarray(p["ln_b"].numpy()), jnp.asarray(p["qkv_w"].numpy().T),
        jnp.asarray(p["qkv_b"].numpy()), jnp.asarray(p["proj_w"].numpy().T),
        jnp.asarray(p["proj_b"].numpy()), jnp.asarray(p["rel_bias"].numpy()),
        jnp.asarray(sentinel if mask is None else mask.numpy()), WINDOW, HEADS,
        1e-5, True)
    win = WA.window_partition(layer_norm(x, p["ln_s"], p["ln_b"], 1e-5),
                              WINDOW)
    before = WA.window_attention_core.launches
    ctx = WA.window_attention_core(dense(win, p["qkv_w"], p["qkv_b"]),
                                   p["rel_bias"], mask, HEADS)
    assert WA.window_attention_core.launches == before   # CPU: plain version
    assert tuple(ctx.shape) == (win.shape[0], N, C)
    out = matmul_f32(ctx, p["proj_w"]) + p["proj_b"]
    got = WA.window_reverse(out, WINDOW, B, D, H, W)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# the 16-frame window (8, 7, 7), N = 392, at a narrow width: one clip of
# (8, 14, 14) tokens, four windows
WINDOW16 = (8, 7, 7)
N16 = 392
DIMS16 = (1, 8, 14, 14)
C16, HEADS16 = 32, 2


@pytest.mark.parametrize("shift", [(0, 0, 0), (0, 3, 3)],
                         ids=["unmasked", "shifted"])
def test_core_at_the_16_frame_window_matches_pallas(shift):
    """At N = 392 (the window the forward's attn_fwd_big_kernel takes on the
    card): LN1, partition and qkv, then ``window_attention_core`` (on the
    CPU its plain version), then proj and reverse, against the Pallas kernel
    of K6 on the same input rolled by -shift, with the shift mask of
    (8, 14, 14) when shifted. Tolerance: TOL, f32."""
    rng = np.random.default_rng(16)

    def f32(a):
        return torch.from_numpy(np.asarray(a, np.float32))

    x = f32(np.roll(rng.normal(size=(*DIMS16, C16)),
                    [-v for v in shift], (1, 2, 3)))
    p = dict(ln_s=f32(1.0 + 0.2 * rng.normal(size=C16)),
             ln_b=f32(0.1 * rng.normal(size=C16)),
             qkv_w=f32(rng.normal(size=(3 * C16, C16)) / np.sqrt(C16)),
             qkv_b=f32(0.02 * rng.normal(size=3 * C16)),
             proj_w=f32(rng.normal(size=(C16, C16)) / np.sqrt(C16)),
             proj_b=f32(0.02 * rng.normal(size=C16)),
             rel_bias=f32(rng.normal(size=(HEADS16, N16, N16))))
    nwin = tuple(d // w for d, w in zip(DIMS16[1:], WINDOW16))
    mask = None
    if any(shift):
        mask = torch.from_numpy(compute_shift_mask(DIMS16[1:], WINDOW16, shift)
                                .reshape(*nwin, N16, N16))
    sentinel = np.zeros((1,) * 5, np.float32)
    want = PWA.fused_window_attention(
        jnp.asarray(x.numpy()), jnp.asarray(p["ln_s"].numpy()),
        jnp.asarray(p["ln_b"].numpy()), jnp.asarray(p["qkv_w"].numpy().T),
        jnp.asarray(p["qkv_b"].numpy()), jnp.asarray(p["proj_w"].numpy().T),
        jnp.asarray(p["proj_b"].numpy()), jnp.asarray(p["rel_bias"].numpy()),
        jnp.asarray(sentinel if mask is None else mask.numpy()), WINDOW16,
        HEADS16, 1e-5, True)
    win = WA.window_partition(layer_norm(x, p["ln_s"], p["ln_b"], 1e-5),
                              WINDOW16)
    ctx = WA.window_attention_core(dense(win, p["qkv_w"], p["qkv_b"]),
                                   p["rel_bias"], mask, HEADS16)
    assert tuple(ctx.shape) == (win.shape[0], N16, C16)
    out = matmul_f32(ctx, p["proj_w"]) + p["proj_b"]
    got = WA.window_reverse(out, WINDOW16, *DIMS16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_core_on_the_cpu_is_its_plain_version():
    x, p = _inputs(2)
    qkv = dense(WA.window_partition(x, WINDOW), p["qkv_w"], p["qkv_b"])
    for mask in (None, _mask(), _mask().reshape(-1, N, N)):
        assert torch.equal(
            WA.window_attention_core(qkv, p["rel_bias"], mask, HEADS),
            WA.window_attention_core_plain(qkv, p["rel_bias"], mask, HEADS))


# the flagship's stages 0-2 at 224 x 224 and 5 frames, and a (2, 14, 14) map
# with window (2, 7, 7), whose shift is (0, 3, 3) as well
LABEL_CASES = [((3, 56, 56), (3, 7, 7), (0, 3, 3)),
               ((3, 28, 28), (3, 7, 7), (0, 3, 3)),
               ((3, 14, 14), (3, 7, 7), (0, 3, 3)),
               ((2, 14, 14), (2, 7, 7), (0, 3, 3)),
               ((4, 6, 9), (2, 3, 3), (1, 1, 1))]


@pytest.mark.parametrize("dims,window,shift", LABEL_CASES,
                         ids=["stage0", "stage1", "stage2", "d2-14x14", "small"])
def test_mask_labels_reproduce_the_shift_mask(dims, window, shift):
    mask = torch.from_numpy(compute_shift_mask(dims, window, shift))
    nwin, n, _ = mask.shape
    labels, off = WA.shift_mask_labels(mask)
    assert labels.dtype == torch.int32 and off.dtype == torch.float32
    assert tuple(labels.shape) == (nwin, -(-n // 16) * 16)
    assert tuple(off.shape) == (nwin,)
    assert not torch.isnan(off).any()           # every window takes labels
    assert bool((labels[:, n:] == 0).all())
    assert torch.equal(WA.shift_mask_from_labels(labels[:, :n], off), mask)
    # the same from the (nd, nh, nw, N, N) form the kernels are given
    nd, nh, nw = (d // w for d, w in zip(dims, window))
    l5, o5 = WA.shift_mask_labels(mask.reshape(nd, nh, nw, n, n))
    assert torch.equal(l5, labels) and torch.equal(o5, off)
    # windows away from the wrapped edge add nothing
    assert bool((off[(mask == 0).flatten(1).all(-1)] == 0).all())


@pytest.mark.parametrize("case", ["three-valued", "not-transitive",
                                  "nonzero-diagonal", "nan"])
def test_a_mask_that_is_not_two_valued_by_labels_is_detected(case):
    mask = torch.from_numpy(compute_shift_mask((4, 6, 9), (2, 3, 3),
                                               (1, 1, 1))).clone()
    bad = 3                     # a window on the wrapped edge
    assert bool((mask[bad] != 0).any())
    if case == "three-valued":
        i, j = (mask[bad] != 0).nonzero()[0].tolist()
        mask[bad, i, j] = -50.0
    elif case == "not-transitive":
        i, j = (mask[bad] != 0).nonzero()[0].tolist()
        mask[bad, i, j] = 0.0   # i may see j, but j not i
    elif case == "nonzero-diagonal":
        mask[bad, 0, 0] = -100.0
    else:
        mask[bad, 1, 2] = float("nan")
    labels, off = WA.shift_mask_labels(mask)
    assert bool(torch.isnan(off[bad]))          # this window reads the mask
    others = [w for w in range(mask.shape[0]) if w != bad]
    assert not torch.isnan(off[others]).any()
    n = mask.shape[-1]
    assert torch.equal(
        WA.shift_mask_from_labels(labels[others, :n], off[others]),
        mask[others])


def test_mask_labels_are_made_once_per_mask():
    # a copy: the write below must not reach compute_shift_mask's cached
    # array, which later tests in the same process read
    mask = _mask().clone()
    first = WA.mask_label_args(mask)
    again = WA.mask_label_args(mask.reshape(-1, N, N).reshape(*NWIN, N, N))
    assert first[0] is again[0] and first[1] is again[1]
    mask[0, 0, 0, 0, 1] = -7.0      # an in-place write is a new mask
    changed = WA.mask_label_args(mask)
    assert changed[0] is not first[0]
    assert bool(torch.isnan(changed[1][0]))
    assert WA.mask_label_args(None) == (None, None)


@pytest.mark.parametrize("t,c,heads", STAGES)
def test_attn_fwd_groups_fill_the_card_once(t, c, heads):
    nwin = t // 147
    groups = WA.attn_fwd_groups(nwin, heads, SMS)
    assert 1 <= groups <= nwin
    assert groups * heads <= SMS            # one CTA per SM, never more
    assert (groups + 1) * heads > SMS or groups == nwin


@pytest.mark.parametrize("nwin,heads,sms,want", [
    (1, 4, 132, 1), (6, 32, 132, 4), (3072, 4, 132, 33), (2, 32, 16, 1),
    (40, 4, 132, 33), (5, 32, 132, 4), (384, 4, 132, 33), (24, 16, 132, 8)])
def test_attn_fwd_groups_values(nwin, heads, sms, want):
    assert WA.attn_fwd_groups(nwin, heads, sms) == want


@pytest.mark.parametrize("n,hd,cta", [
    (147, 32, "attn_fwd_kernel"), (160, 16, "attn_fwd_kernel"),
    (8, 16, "attn_fwd_kernel"), (161, 32, "attn_fwd_big_kernel"),
    (200, 16, "attn_fwd_big_kernel"), (392, 32, "attn_fwd_big_kernel"),
    (400, 32, "attn_fwd_big_kernel"), (401, 32, "attn_fwd_big_kernel"),
    (432, 32, "attn_fwd_big_kernel"), (448, 16, "attn_fwd_big_kernel"),
    (449, 32, None), (1152, 32, None), (147, 64, None), (392, 48, None)])
def test_attn_fwd_cta_by_shape(n, hd, cta):
    """Two CTAs take head_dim 16 / 32 up to 448 tokens; no CTA takes any
    other shape, and the one rule says so."""
    assert WA.attn_fwd_cta(n, hd) == cta
    assert WA.attn_supported(n, hd) is (cta is not None)


@pytest.mark.parametrize("n,blocks", [(161, 3), (176, 3), (200, 3),
                                      (245, 4), (392, 5), (400, 5),
                                      (401, 7), (432, 7), (448, 7)])
def test_attn_fwd_blocks(n, blocks):
    """80-row query blocks of the window padded to 16 rows up to 400 padded
    tokens, 64-row blocks past it; the last one ragged except at N = 392 /
    400 / 448."""
    rows = 80 if n <= 400 else 64
    assert WA.attn_fwd_block_rows(n) == rows
    assert WA.attn_fwd_blocks(n) == blocks
    assert (blocks - 1) * rows < -(-n // 16) * 16
    assert -(-n // 16) * 16 <= blocks * rows


def test_attn_fwd_big_smem_fits_an_sm_at_np400():
    """The CTA's shared memory at the largest window it takes (Np = 400):
    80 bias rows of 400 f32 (128,000 B), k twice and v (76,800), q of 80
    rows (5,120), the labels twice (3,200), two halves' (max, sum) of 80
    rows (1,280) and the upper half's f32 ctx (10,240): 224,640 bytes,
    inside the 232,448 a CTA may take; less at head_dim 16."""
    assert WA.attn_fwd_big_smem_bytes(400, 32) == 224640
    assert WA.attn_fwd_big_smem_bytes(392, 32) == 224640
    assert WA.attn_fwd_big_smem_bytes(400, 16) == 178560
    assert WA.attn_fwd_big_smem_bytes(400, 32) <= 227 * 1024


@pytest.mark.parametrize("n,hd,want", [(432, 32, 210304), (448, 32, 217600),
                                      (432, 16, 162688)])
def test_attn_fwd_big_smem_fits_an_sm_past_np400(n, hd, want):
    """Past 400 padded tokens the CTA takes 64 rows: at N = 432 and
    head_dim 32, 64 bias rows of 432 f32 (110,592 B), k twice and v
    (82,944), q (4,096), the labels twice (3,456), (max, sum) (1,024) and
    the upper ctx (8,192). 80 rows would take 241,280 B, past the 232,448
    a CTA may take."""
    assert WA.attn_fwd_big_smem_bytes(n, hd) == want <= WA.SMEM_PER_CTA
    assert 80 * 432 * 4 + 3 * 432 * 64 + 80 * 64 + 2 * 432 * 4 + 2 * 80 * 8 \
        + 80 * 128 > WA.SMEM_PER_CTA


def test_attn_fwd_big_constants_match_the_source():
    """The Python helpers' rows, key parts and token limits are the ones
    ``csrc/attn_fwd.cu`` launches with."""
    import re

    from lrce_tpu_torch.ops import cuda_lib
    src = (cuda_lib.CSRC / "attn_fwd.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert 16 * const("FB_ROW_WARPS") == WA.ATTN_FWD_BLOCK_ROWS
    assert 16 * const("FB_WIDE_ROW_WARPS") == WA.ATTN_FWD_WIDE_BLOCK_ROWS
    assert const("FB_WIDE_NP") == WA.ATTN_FWD_WIDE_TOKENS
    assert const("FB_SPLITS") == WA.ATTN_FWD_KEY_SPLITS
    assert const("FB_MAX_NP") == WA.ATTN_MAX_TOKENS
    assert 8 * const("FW_MAX_NB") == WA.ATTN_FWD_SMALL_TOKENS


# (tokens, C, heads) of the flagship's stages at 48 clips of 16 frames
STAGES16 = [(1204224, 128, 4), (301056, 256, 8), (75264, 512, 16),
            (18816, 1024, 32)]


@pytest.mark.parametrize("t,c,heads,want", [
    (s[0], s[1], s[2], w) for s, w in zip(STAGES16, (33, 13, 8, 4))])
def test_attn_fwd_big_groups_at_n392(t, c, heads, want):
    """At N = 392 on 132 SMs (5 query blocks): the groups whose waves x
    (windows a CTA + 1) is least, and no other count does better."""
    nwin = t // 392

    def cost(g):
        return -(-g * heads * 5 // SMS) * (-(-nwin // g) + 1)

    groups = WA.attn_fwd_big_groups(nwin, heads, SMS, 5)
    assert groups == want
    assert all(cost(groups) <= cost(g) for g in range(1, nwin + 1))
    assert WA.attn_fwd_launch_groups(nwin, 392, c // heads, heads,
                                     SMS) == groups


@pytest.mark.parametrize("nwin,heads,sms,want", [
    (1, 4, 132, 1), (2, 32, 132, 1), (6, 32, 132, 2), (24, 16, 132, 3),
    (384, 4, 132, 13), (96, 32, 132, 4), (5, 2, 16, 1)])
def test_attn_fwd_big_groups_values(nwin, heads, sms, want):
    groups = WA.attn_fwd_big_groups(nwin, heads, sms, 5)
    assert groups == want and 1 <= groups <= nwin


@pytest.mark.parametrize("t,c,heads", STAGES)
def test_the_5_frame_grid_is_unchanged(t, c, heads):
    """Windows of at most 160 tokens keep attn_fwd_kernel's groups."""
    nwin = t // 147
    assert WA.attn_fwd_launch_groups(nwin, 147, c // heads, heads,
                                     SMS) == WA.attn_fwd_groups(nwin, heads,
                                                                SMS)


def test_core_refuses_what_its_kernel_does_not_take():
    """The checks that run before any launch. Shapes are checked on every
    route; a tensor that is not on the CPU never takes the plain version:
    f32 raises on the kernel route, and so does a device without CUDA."""
    x, p = _inputs(3)
    qkv = dense(WA.window_partition(x, WINDOW), p["qkv_w"], p["qkv_b"])
    rel = p["rel_bias"]
    with pytest.raises(ValueError, match="qkv must be"):
        WA.window_attention_core(qkv[0], rel, None, HEADS)
    with pytest.raises(ValueError, match="qkv must be"):
        WA.window_attention_core(qkv[..., :-1], rel, None, HEADS)
    with pytest.raises(ValueError, match="expected shape"):
        WA.window_attention_core(qkv, rel[:, :-1], None, HEADS)
    with pytest.raises(ValueError, match="mask"):
        WA.window_attention_core(qkv, rel, _mask()[..., :-1], HEADS)
    with pytest.raises(ValueError, match="mask"):     # 12 windows, 5 masks
        WA.window_attention_core(qkv, rel, torch.zeros(5, N, N), HEADS)
    meta = dict(device="meta")
    with pytest.raises(TypeError, match="bfloat16"):
        WA.window_attention_core(torch.empty(qkv.shape, **meta),
                                 torch.empty(rel.shape, **meta), None, HEADS)
    with pytest.raises(TypeError, match="float32"):
        WA.window_attention_core(
            torch.empty(qkv.shape, dtype=torch.bfloat16, **meta),
            torch.empty(rel.shape, dtype=torch.bfloat16, **meta), None, HEADS)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        WA.window_attention_core(
            torch.empty(qkv.shape, dtype=torch.bfloat16, **meta),
            torch.empty(rel.shape, **meta), None, HEADS)
