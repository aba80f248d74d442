"""The port's Video Swin 3D (lrce_tpu_torch/models/swin3d.py) against
lrce_tpu/models/swin3d.py on the same weights and inputs, f32 on the CPU.

The JAX side runs its XLA path (the Pallas kernels route only on a TPU or
in interpret mode). The port runs both of its routes: the kernel route,
whose wrappers take their plain versions on the CPU, and the plain route.

Tolerance 1e-4 (rtol and atol): a few f32 ulps per op, through up to six
blocks, patch merging and the final LayerNorm on outputs of order 1.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lrce_tpu.models import swin3d as S
from lrce_tpu_torch.models import swin3d as PS
from lrce_tpu_torch.ops.window_attn import window_partition, window_reverse
from lrce_tpu_torch.utils.convert import swin_state_dict

TOL = dict(rtol=1e-4, atol=1e-4)
JCFG = S.SwinConfig(embed_dim=32, depths=(2, 2, 2), num_heads=(2, 2, 4),
                    window_size=(2, 3, 3), drop_path_rate=0.0)
PCFG = PS.SwinConfig(embed_dim=32, depths=(2, 2, 2), num_heads=(2, 2, 4),
                     window_size=(2, 3, 3))


@pytest.fixture(scope="module")
def models():
    params = jax.tree.map(np.asarray, S.swin_init(jax.random.PRNGKey(0), JCFG))
    # give LN parameters and biases non-trivial values (init has 1 / 0)
    rng = np.random.default_rng(0)
    params = jax.tree.map(
        lambda a: a + rng.normal(0, 0.05, a.shape).astype(a.dtype), params)
    model = PS.SwinTransformer3D(PCFG, generator=torch.Generator().manual_seed(0))
    model.load_state_dict(swin_state_dict(params, ""))
    return params, model


@pytest.mark.parametrize("x_size,window,shift", [
    ((3, 56, 56), (8, 7, 7), (4, 3, 3)),
    ((3, 7, 7), (8, 7, 7), (4, 3, 3)),
    ((10, 5, 9), (8, 7, 7), (4, 3, 3)),
])
def test_window_size_clamp(x_size, window, shift):
    assert PS.get_window_size(x_size, window, shift) == \
        S.get_window_size(x_size, window, shift)


@pytest.mark.parametrize("window", [(8, 7, 7), (2, 3, 3)])
def test_relative_position_index(window):
    np.testing.assert_array_equal(PS.relative_position_index(window),
                                  S.relative_position_index(window))


@pytest.mark.parametrize("dims,window,shift", [
    ((3, 56, 56), (3, 7, 7), (0, 3, 3)),
    ((2, 6, 9), (2, 3, 3), (1, 1, 1)),
])
def test_shift_mask(dims, window, shift):
    np.testing.assert_array_equal(PS.compute_shift_mask(dims, window, shift),
                                  S.compute_shift_mask(dims, window, shift))


def test_window_partition_and_reverse():
    x = np.random.default_rng(1).normal(size=(2, 4, 6, 9, 5)).astype(np.float32)
    window = (2, 3, 3)
    got = window_partition(torch.from_numpy(x), window)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(S.window_partition(jnp.asarray(x), window)))
    back = window_reverse(got, window, 2, 4, 6, 9)
    np.testing.assert_array_equal(back.numpy(), x)


def test_patch_embed_pads_time(models):
    params, model = models
    x = np.random.default_rng(2).normal(size=(2, 5, 16, 20, 3)).astype(np.float32)
    want = S.patch_embed(params["patch_embed"], jnp.asarray(x), JCFG)
    with torch.no_grad():
        got = model.patch_embed(torch.from_numpy(x))
    assert tuple(got.shape) == (2, 3, 4, 5, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_patch_merging_odd_sizes(models):
    params, model = models
    x = np.random.default_rng(3).normal(size=(2, 2, 5, 7, 32)).astype(np.float32)
    want = S.patch_merging(params["stages"][0]["downsample"], jnp.asarray(x))
    with torch.no_grad():
        got = model.layers[0].downsample(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("route,shape", [
    ("kernels", (2, 4, 48, 48, 3)),      # every stage window-aligned
    ("plain", (2, 4, 48, 48, 3)),
    ("k2", (2, 4, 48, 48, 3)),           # stages 1-2 through K2, shifted included
    ("kernels", (1, 3, 40, 40, 3)),      # T pads 3 -> 4; padded stages go plain
])
def test_swin_forward(models, monkeypatch, route, shape):
    params, model = models
    x = np.random.default_rng(4).normal(size=shape).astype(np.float32)
    want = np.asarray(S.swin_forward(params, jnp.asarray(x), JCFG))
    if route == "k2":
        monkeypatch.setattr(PS, "BLOCK_KERNEL_MAX_C", 32)
    monkeypatch.setattr(model, "use_kernels", route != "plain")
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


def test_kernel_route_calls_each_wrapper(models, monkeypatch):
    """Routing: unshifted blocks of C <= BLOCK_KERNEL_MAX_C go to K1, shifted
    ones to K3 with k = 1, wider stages to K2, padded stages to none."""
    from lrce_tpu_torch.ops import swin_block as SB
    from lrce_tpu_torch.ops import window_attn as WA

    _, model = models
    calls = {"K1": 0, "K3": 0, "K2": 0}

    def counting(key, fn):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(PS, "fused_swin_block", counting("K1", SB.fused_swin_block))
    monkeypatch.setattr(PS, "fused_swin_pair", counting("K3", SB.fused_swin_pair))
    monkeypatch.setattr(PS, "fused_window_attention_hsplit",
                        counting("K2", WA.fused_window_attention_hsplit))
    monkeypatch.setattr(PS, "BLOCK_KERNEL_MAX_C", 64)
    x = torch.randn((1, 4, 48, 48, 3))
    with torch.no_grad():
        model(x)
    # stage 0 (C=32) and 1 (C=64): one unshifted + one shifted each;
    # stage 2 (C=128, no shift at its 2x3x3 size): K2 twice
    assert calls == {"K1": 2, "K3": 2, "K2": 2}
