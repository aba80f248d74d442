"""The port's BERT, positional embeddings, fusion decoder and task heads
against lrce_tpu's on the same weights and inputs, f32 on the CPU.

Tolerance 1e-4 (rtol and atol): a few f32 ulps per op; the heads chain 12
decoder layers over 3 clips, each ending in a LayerNorm that keeps values
of order 1.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lrce_tpu.models import bert as B
from lrce_tpu.models import embedding as EMB
from lrce_tpu.models import fusion as F
from lrce_tpu_torch.models import bert as PB
from lrce_tpu_torch.models import embedding as PEMB
from lrce_tpu_torch.models import fusion as PF
from lrce_tpu_torch.utils.convert import bert_state_dict, head_state_dict

TOL = dict(rtol=1e-4, atol=1e-4)
GEN = torch.Generator().manual_seed(0)


def _perturb(tree, seed):
    """Non-trivial LN parameters and biases (init leaves them 1 and 0)."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: np.asarray(a) + rng.normal(0, 0.05, np.shape(a)).astype(np.float32),
        tree)


def test_bert_encoder_with_padding_mask():
    jcfg = B.BertConfig(vocab_size=100, hidden_size=48, num_layers=2,
                        num_heads=4, intermediate_size=96,
                        max_position_embeddings=40)
    pcfg = PB.BertConfig(vocab_size=100, hidden_size=48, num_layers=2,
                         num_heads=4, intermediate_size=96,
                         max_position_embeddings=40)
    params = _perturb(B.bert_init(jax.random.PRNGKey(0), jcfg), 1)
    model = PB.BertModel(pcfg, generator=GEN)
    model.load_state_dict(bert_state_dict(params, ""))
    rng = np.random.default_rng(2)
    ids = rng.integers(0, 100, (3, 12))
    mask = np.ones((3, 12), np.int64)
    mask[1, 7:] = 0
    types = rng.integers(0, 2, (3, 12))
    want = B.bert_encode(params, jnp.asarray(ids), jnp.asarray(mask),
                         jnp.asarray(types), jcfg)
    with torch.no_grad():
        got = model(*(torch.from_numpy(a) for a in (ids, mask, types)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _load(module, params):
    sd = {}
    for k, v in params.items():
        if isinstance(v, dict):
            sd.update({f"{k}.{kk}": vv for kk, vv in _flat_ln(v).items()})
        else:
            sd[k] = torch.from_numpy(np.array(v))
    module.load_state_dict(sd)


def _flat_ln(p):
    return {"weight": torch.from_numpy(np.array(p["scale"])),
            "bias": torch.from_numpy(np.array(p["bias"]))}


def test_text_pos_embed():
    params = _perturb(EMB.text_pos_embed_init(jax.random.PRNGKey(3), 6, 24), 4)
    mod = PEMB.TextPosEmbed(6, 24, GEN)
    _load(mod, params)
    x = np.random.default_rng(5).normal(size=(2, 6, 24)).astype(np.float32)
    want = EMB.text_pos_embed(params, jnp.asarray(x))
    with torch.no_grad():
        got = mod(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_video_pos_embed():
    params = _perturb(EMB.video_pos_embed_init(jax.random.PRNGKey(6), 24, (2, 3),
                                               5, clip_size=3), 7)
    mod = PEMB.VideoPosEmbed(24, (2, 3), 5, 3, GEN)
    _load(mod, params)
    x = np.random.default_rng(8).normal(size=(2, 3, 3, 6, 24)).astype(np.float32)
    want = EMB.video_pos_embed(params, jnp.asarray(x))
    with torch.no_grad():
        got = mod(torch.from_numpy(x))
    assert tuple(got.shape) == (2, 3, 21, 24)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_decoder_layer():
    head = _perturb(F.lrce_open_ended_init(jax.random.PRNGKey(9), 24, 5,
                                           (2, 3), 24, 5, [1], 4), 10)
    params = jax.tree.map(lambda a: a[0], head["fusion_transformer"]["layers"])
    pre = "fusion_transformer.transformer.layers.0."
    sd = {k[len(pre):]: v for k, v in head_state_dict(head, "").items()
          if k.startswith(pre)}
    layer = PF.DecoderLayer(24, torch.float32, GEN)
    layer.load_state_dict(sd)
    rng = np.random.default_rng(11)
    tgt = rng.normal(size=(2, 1, 24)).astype(np.float32)
    mem = rng.normal(size=(2, 17, 24)).astype(np.float32)
    want = F.decoder_layer(params, jnp.asarray(tgt), jnp.asarray(mem))
    with torch.no_grad():
        got = layer(torch.from_numpy(tgt), torch.from_numpy(mem))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("task", ["oe", "mc", "count"])
def test_heads(task):
    dim, vdim, classes, ts, qlen = 24, 32, 7, (1, 2), 6
    key = jax.random.PRNGKey(12)
    if task == "oe":
        params = F.lrce_open_ended_init(key, dim, classes, (2, 3), vdim, 5,
                                        list(ts), qlen)
        fn = F.lrce_open_ended
    elif task == "mc":
        params = F.lrce_multiple_choice_init(key, dim, 1, (2, 3), vdim, 5,
                                             list(ts), qlen)
        fn = F.lrce_multiple_choice
    else:
        params = F.lrce_count_init(key, dim, (2, 3), vdim, 5, list(ts), qlen)
        fn = F.lrce_count
    params = _perturb(params, 13)
    head = PF.LRCEHead(task, dim, 1 if task == "mc" else classes, (2, 3), vdim,
                       5, ts, qlen, torch.float32, GEN)
    head.load_state_dict(head_state_dict(params, ""))
    rng = np.random.default_rng(14)
    video = rng.normal(size=(2, 3, 3, 6, vdim)).astype(np.float32)
    tshape = (2, 4, qlen, dim) if task == "mc" else (2, qlen, dim)
    text = rng.normal(size=tshape).astype(np.float32)
    want = np.asarray(fn(params, jnp.asarray(video), jnp.asarray(text)))
    with torch.no_grad():
        got = head(torch.from_numpy(video), torch.from_numpy(text)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)
