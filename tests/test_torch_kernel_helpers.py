"""Host-side helpers of the port's CUDA kernels, on the CPU: the grid and
split pickers of K4 / K5, their workspace shapes, the build module's source
lists, digest and ctypes signatures (held against the C prototypes parsed
from ``csrc/*.cu``), and the plain versions of the two shared GEMMs against
float64 numpy products (tolerance: one bf16 rounding of the output, 2^-8
relative, for the bf16 GEMM; 1e-5 for the f32 weight-gradient GEMM, whose
operands are bf16-exact)."""

import ctypes
import re

import numpy as np
import pytest
import torch

from lrce_tpu_torch.ops import cuda_lib
from lrce_tpu_torch.ops import gemm as G
from lrce_tpu_torch.ops import swin_block as SB
from lrce_tpu_torch.ops import window_attn as WA

SMS = 132   # an H100
# (tokens, C, heads) of the flagship's stages at 48 clips
STAGES = [(451584, 128, 4), (112896, 256, 8), (28224, 512, 16),
          (7056, 1024, 32)]


@pytest.mark.parametrize("t,c,heads", STAGES)
def test_attn_bwd_groups_fill_the_card_once(t, c, heads):
    nwin = t // 147
    groups = WA.attn_bwd_groups(nwin, heads, SMS)
    assert 1 <= groups <= nwin
    assert groups * heads <= SMS            # one CTA per SM, never more
    assert (groups + 1) * heads > SMS or groups == nwin


@pytest.mark.parametrize("nwin,heads,sms,want", [
    (1, 4, 132, 1), (6, 32, 132, 4), (3072, 4, 132, 33), (2, 32, 16, 1),
    (40, 4, 132, 33), (5, 32, 132, 4)])
def test_attn_bwd_groups_values(nwin, heads, sms, want):
    assert WA.attn_bwd_groups(nwin, heads, sms) == want


@pytest.mark.parametrize("t,c,heads", STAGES)
def test_splitk_splits_cover_two_ctas_per_sm(t, c, heads):
    for n, k in ((3 * c, c), (c, c), (4 * c, c), (c, 4 * c)):
        splits = WA.splitk_splits(t, n, k, SMS)
        tiles = -(-n // WA.SPLITK_TILE) * -(-k // WA.SPLITK_TILE)
        assert splits >= 1
        assert t // splits >= WA.SPLITK_MIN_ROWS
        assert splits == 1 or (splits - 1) * tiles < 2 * SMS


@pytest.mark.parametrize("m,n,k,want", [
    (100, 384, 128, 1), (451584, 384, 128, 88), (451584, 128, 128, 264),
    (7056, 4096, 1024, 2), (882, 1024, 4096, 2), (441, 64, 64, 1),
    (3001, 384, 128, 11)])
def test_splitk_splits_values(m, n, k, want):
    assert WA.splitk_splits(m, n, k, SMS) == want


@pytest.mark.parametrize("t,want", [(1, 1), (128, 1), (129, 2), (441, 4),
                                    (7056, 56), (451584, 3528)])
def test_mlp_bwd_col_rows_one_per_token_tile(t, want):
    assert SB.mlp_bwd_col_rows(t) == want


@pytest.mark.parametrize("t,c,heads", STAGES)
def test_workspace_shapes(t, c, heads):
    ff, splits, groups = 4 * c, 3, 5
    bf, f32 = SB.mlp_bwd_workspace_shapes(t, c, ff, splits)
    assert bf == ((t, c), (t, ff), (t, ff))
    assert f32 == ((SB.mlp_bwd_col_rows(t), ff), (splits, ff * c))
    # no f32 (T, FF) array among K5's workspaces
    assert all(np.prod(sh) < t * ff for sh in f32)
    bf, f32 = WA.attn_bwd_workspace_shapes(t, c, heads, 147, groups, splits)
    assert bf == ((t, c), (t, 3 * c), (t, c), (t, c), (t, c), (t, 3 * c))
    assert f32 == ((groups, heads, 147, 147), (groups, 3 * c),
                   (splits, 3 * c, c), (0, 4))


# (tokens, C, heads) of the flagship's stages at 48 clips of 16 frames: the
# window (8, 7, 7), N = 392, at every stage
STAGES16 = [(1204224, 128, 4), (301056, 256, 8), (75264, 512, 16),
            (18816, 1024, 32)]


@pytest.mark.parametrize("n,blocks", [(147, 1), (160, 1), (161, 3),
                                      (196, 3), (245, 4), (392, 5),
                                      (400, 5)])
def test_attn_bwd_blocks(n, blocks):
    assert WA.attn_bwd_blocks(n) == blocks


@pytest.mark.parametrize("t,c,heads", STAGES16)
def test_attn_bwd_pair_workspaces_at_n392(t, c, heads):
    """The pair's bias partials take a row per (group, 80-row block) and its
    statistics four floats per (window, head, row of the padded window)."""
    groups, splits = 3, 2
    bf, f32 = WA.attn_bwd_workspace_shapes(t, c, heads, 392, groups, splits)
    assert bf == ((t, c), (t, 3 * c), (t, c), (t, c), (t, c), (t, 3 * c))
    assert f32 == ((groups, heads, 392, 392), (groups * 5, 3 * c),
                   (splits, 3 * c, c), (t // 392 * heads * 400, 4))


@pytest.mark.parametrize("t,c,heads,want", [
    (s[0], s[1], s[2], w) for s, w in zip(STAGES16, (106, 53, 27, 14))])
def test_attn_bwd_pair_groups_give_16_ctas_an_sm(t, c, heads, want):
    """At N = 392 on 132 SMs: about 16 x 132 CTAs of heads x 5 blocks a
    group, never more groups than windows."""
    nwin = t // 392
    groups = WA.attn_bwd_groups(nwin, heads, SMS, WA.attn_bwd_blocks(392))
    assert groups == want
    assert (groups - 1) * heads * 5 < 16 * SMS <= groups * heads * 5
    assert WA.attn_bwd_groups(2, heads, SMS, 5) == 2   # never past the windows


_CTYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
           "int": ctypes.c_int, "float": ctypes.c_float}


def _c_prototypes():
    """{name: [ctypes of the parameters]} of every ``int lrce_*(...)`` entry
    point in csrc/*.cu."""
    out = {}
    for path in sorted(cuda_lib.CSRC.glob("*.cu")):
        text = re.sub(r"//[^\n]*", "", path.read_text())
        for name, params in re.findall(r"\bint (lrce_\w+)\(([^)]*)\)\s*{", text):
            types = []
            for param in params.split(","):
                decl = " ".join(param.split())
                types.append(_CTYPES[decl.rsplit(" ", 1)[0]])
            out[name] = types
    return out


def test_every_c_entry_point_has_a_signature():
    assert set(_c_prototypes()) == set(cuda_lib._SIGNATURES)


@pytest.mark.parametrize("name", sorted(cuda_lib._SIGNATURES))
def test_signatures_match_the_c_prototypes(name):
    assert cuda_lib._SIGNATURES[name] == _c_prototypes()[name]


def test_sources_and_headers_list_every_file_of_csrc():
    assert sorted(cuda_lib.SOURCES) == sorted(
        p.name for p in cuda_lib.CSRC.glob("*.cu"))
    assert sorted(cuda_lib.HEADERS) == sorted(
        p.name for p in cuda_lib.CSRC.glob("*.cuh"))
    for name in cuda_lib.SOURCES + cuda_lib.HEADERS:
        for inc in re.findall(r'#include "([^"]+)"',
                              (cuda_lib.CSRC / name).read_text()):
            assert inc in cuda_lib.HEADERS


@pytest.mark.parametrize("attr", ["ARCH_FLAGS", "COMPILE_FLAGS", "LINK_FLAGS"])
def test_digest_follows_the_flags(monkeypatch, attr):
    before = cuda_lib._digest()
    monkeypatch.setattr(cuda_lib, attr, getattr(cuda_lib, attr) + ("-lfoo",))
    assert cuda_lib._digest() != before


def _np_bf16(rng, shape, scale=1.0):
    t = torch.tensor(scale * rng.normal(size=shape),
                     dtype=torch.float32).bfloat16()
    return t, t.float().numpy().astype(np.float64)


def _gelu64(x):
    from math import erf, sqrt
    return x * 0.5 * (1.0 + np.vectorize(erf)(x / sqrt(2.0)))


@pytest.mark.parametrize("mode,b_kn", [(m, False) for m in G.EPI_MODES]
                         + [(G.EPI_ATTN_OUT, True)])
def test_gemm_bf16_on_the_cpu_is_its_plain_version(mode, b_kn):
    rng = np.random.default_rng(mode + 10 * b_kn)
    m, n, k, dp_rows = 37, 24, 16, 10
    a, a64 = _np_bf16(rng, (m, k))
    b, b64 = _np_bf16(rng, (k, n) if b_kn else (n, k), 0.25)
    res, res64 = _np_bf16(rng, (m, n))
    bias = torch.tensor(0.1 * rng.normal(size=n), dtype=torch.float32)
    dp = torch.tensor([0.0, 1.25, 1.25, 0.0], dtype=torch.float32)
    kw = dict(mode=mode, bias=bias, b_kn=b_kn)
    if mode in (G.EPI_ATTN_OUT, G.EPI_MLP_OUT):
        kw.update(dp=dp, dp_rows=dp_rows, res=res)
    before = G.gemm_bf16.launches
    got = G.gemm_bf16(a, b, **kw)
    assert G.gemm_bf16.launches == before      # no kernel on the CPU
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (m, n)
    assert torch.equal(got, G.gemm_bf16_plain(a, b, **kw))
    want = a64 @ (b64 if b_kn else b64.T) + bias.numpy().astype(np.float64)
    if mode == G.EPI_BIAS_GELU:
        want = _gelu64(want)
    if mode in (G.EPI_ATTN_OUT, G.EPI_MLP_OUT):
        want = want * np.repeat(dp.numpy(), dp_rows)[:m, None] + res64
    err = np.abs(got.float().numpy() - want)
    # EPI_ATTN_OUT rounds twice (the product, then the sum with res)
    assert (err <= 2.0 ** -7 * np.maximum(np.abs(want), 1.0)).all()


def test_gemm_tn_on_the_cpu_is_its_plain_version():
    rng = np.random.default_rng(3)
    g, g64 = _np_bf16(rng, (301, 24))
    a, a64 = _np_bf16(rng, (301, 16))
    got = G.gemm_tn(g, a)
    assert got.dtype == torch.float32 and tuple(got.shape) == (24, 16)
    np.testing.assert_allclose(got.numpy(), g64.T @ a64, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("gather,shift", [(False, (0, 0, 0)),
                                          (True, (0, 0, 0)),
                                          (True, (1, 1, 2))],
                         ids=["token-order", "window-order", "shifted"])
def test_ln_rows_on_the_cpu_is_its_plain_version(gather, shift):
    rng = np.random.default_rng(5)
    window = (2, 3, 3)
    x, x64 = _np_bf16(rng, (2, 2, 6, 9, 32))
    gamma = torch.tensor(1 + 0.2 * rng.normal(size=32), dtype=torch.float32)
    beta = torch.tensor(0.1 * rng.normal(size=32), dtype=torch.float32)
    before = G.ln_rows.launches
    got = G.ln_rows(x, gamma, beta, window, shift, 1e-5, gather)
    assert G.ln_rows.launches == before        # no kernel on the CPU
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (216, 32)
    assert torch.equal(got, G.ln_rows_plain(x, gamma, beta, window, shift,
                                            1e-5, gather))
    d = x64 - x64.mean(-1, keepdims=True)
    want = (d / np.sqrt((d * d).mean(-1, keepdims=True) + 1e-5)
            * gamma.numpy().astype(np.float64) + beta.numpy())
    if gather:
        want = np.roll(want, tuple(-v for v in shift), axis=(1, 2, 3))
        want = want.reshape(2, 1, 2, 2, 3, 3, 3, 32).transpose(
            0, 1, 3, 5, 2, 4, 6, 7)
    err = np.abs(got.float().numpy() - want.reshape(-1, 32))
    assert (err <= 2.0 ** -8 * np.maximum(np.abs(want.reshape(-1, 32)),
                                          1.0)).all()


def test_mlp_bwd_and_attn_bwd_refuse_what_their_kernels_do_not_take():
    """The checks that run before any launch: a non-CPU, non-CUDA device and
    a wrong dtype raise (a CUDA tensor never falls back to the plain
    version)."""
    x = torch.zeros((1, 1, 2, 2, 32), device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        SB.mlp_bwd(x, x, *(torch.zeros(1, device="meta"),) * 5, None)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        G.gemm_bf16(torch.zeros((8, 8), device="meta", dtype=torch.bfloat16),
                    torch.zeros((8, 8), device="meta", dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        G.gemm_tn(torch.zeros((8, 8), device="meta", dtype=torch.bfloat16),
                  torch.zeros((8, 8), device="meta", dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        G.ln_rows(x, torch.zeros(32, device="meta"),
                  torch.zeros(32, device="meta"))
