"""Weights carried across: lrce_tpu_torch.utils.convert.state_dict_from_jax
is the exact inverse of lrce_tpu.utils.torch_io.convert_e2e, and the port's
own state_dict() is a reference checkpoint that convert_e2e reads."""

import numpy as np
import pytest
import torch

import jax

from lrce_tpu.models import e2e as E
from lrce_tpu.utils.torch_io import convert_e2e
from lrce_tpu_torch.models import e2e as PE
from lrce_tpu_torch.utils.convert import state_dict_from_jax
from tests.test_torch_e2e import tiny_configs, tiny_inputs


def _same_tree(a, b):
    ka, kb = jax.tree.structure(a), jax.tree.structure(b)
    assert ka == kb, (ka, kb)
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        assert x.shape == y.shape and x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("task", ["oe", "mc", "count"])
def test_round_trip_is_exact(task):
    jcfg, _ = tiny_configs(task)
    params = jax.tree.map(np.asarray, E.e2e_init(jax.random.PRNGKey(1), jcfg))
    sd = state_dict_from_jax(params)
    back = convert_e2e({k: v.numpy() for k, v in sd.items()})
    _same_tree(back, params)


@pytest.mark.parametrize("task", ["oe", "mc", "count"])
def test_state_dict_keys_are_the_models(task):
    jcfg, pcfg = tiny_configs(task)
    params = jax.tree.map(np.asarray, E.e2e_init(jax.random.PRNGKey(2), jcfg))
    sd = state_dict_from_jax(params)
    model = PE.LRCEModel(pcfg)
    assert set(sd) == set(model.state_dict())
    for k, v in model.state_dict().items():
        assert tuple(v.shape) == tuple(sd[k].shape), k


def test_port_state_dict_loads_into_jax():
    """A randomly initialized port model, exported with state_dict() and
    read by convert_e2e, gives lrce_tpu the same logits (5e-4, as the
    end-to-end test)."""
    jcfg, pcfg = tiny_configs("oe")
    model = PE.LRCEModel(pcfg, generator=torch.Generator().manual_seed(3))
    params = convert_e2e({k: v.numpy() for k, v in model.state_dict().items()})
    clips, ids, mask, types = tiny_inputs("oe", seed=4)
    want = np.asarray(E.e2e_forward(params, clips, ids.astype(np.int32),
                                    mask.astype(np.int32),
                                    types.astype(np.int32), jcfg))
    got = PE.e2e_forward(model, *(torch.from_numpy(a)
                                  for a in (clips, ids, mask, types)))
    np.testing.assert_allclose(got.numpy(), want, rtol=5e-4, atol=5e-4)


def test_bf16_model_keeps_norms_and_biases_f32():
    jcfg, pcfg = tiny_configs("oe")
    params = jax.tree.map(np.asarray, E.e2e_init(jax.random.PRNGKey(5), jcfg))
    model = PE.LRCEModel(pcfg, dtype=torch.bfloat16)
    model.load_state_dict(state_dict_from_jax(params))
    sd = model.state_dict()
    blk = "video_extractor.swin.layers.0.blocks.0"
    assert sd[f"{blk}.attn.qkv.weight"].dtype == torch.bfloat16
    assert sd[f"{blk}.attn.qkv.bias"].dtype == torch.float32
    assert sd[f"{blk}.norm1.weight"].dtype == torch.float32
    assert sd[f"{blk}.attn.relative_position_bias_table"].dtype == torch.float32
    # loading rounds a matrix to bf16 the way the JAX package's astype does
    w = params["video_extractor"]["stages"][0]["blocks"]["attn"]["qkv"]["w"][0]
    np.testing.assert_array_equal(
        sd[f"{blk}.attn.qkv.weight"].float().numpy(),
        np.asarray(jax.numpy.asarray(w.T).astype(jax.numpy.bfloat16)
                   .astype(jax.numpy.float32)))
