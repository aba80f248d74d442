"""The port's tensor primitives (lrce_tpu_torch/ops/nn.py) against
lrce_tpu/ops/nn.py on the same numpy inputs, in f32 on the CPU.

Tolerance 1e-5 (rtol and atol): the two compute the same f32 expressions
and differ only in summation order inside the matrix products and the
LayerNorm reductions, a few f32 ulps at these sizes."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lrce_tpu.ops import nn as JN
from lrce_tpu_torch.ops import nn as PN

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_gelu_is_exact_erf():
    x = np.random.default_rng(0).normal(0, 3, (64, 33)).astype(np.float32)
    np.testing.assert_allclose(PN.gelu(_t(x)).numpy(),
                               np.asarray(JN.gelu(jnp.asarray(x))), **TOL)


def test_gelu_of_bf16_saves_only_its_input():
    """A bf16 GELU with a gradient keeps its bf16 input for the backward
    (not the f32 intermediates autograd would keep) and gives the forward
    and the gradient of the f32 ops' autograd: the same f32 math, in
    another order, rounded once to bf16 (at most one bf16 ulp apart)."""
    gen = torch.Generator().manual_seed(0)
    x = (3 * torch.randn((64, 96), generator=gen)).bfloat16()
    g = torch.randn((64, 96), generator=gen).bfloat16()
    saved = []
    a = x.clone().requires_grad_()
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(t) or t, lambda t: t):
        y = PN.gelu(a)
    assert [(t.dtype, t.shape) for t in saved] == [(torch.bfloat16, x.shape)]
    y.backward(g)
    b = x.clone().requires_grad_()
    xf = b.float()
    want = (xf * 0.5 * (1.0 + torch.erf(xf / np.sqrt(2.0)))).to(b.dtype)
    want.backward(g)
    assert torch.equal(y, want)
    ulp = 2.0 ** -7 * b.grad.float().abs().clamp_min(2.0 ** -126)
    assert bool(((a.grad.float() - b.grad.float()).abs() <= ulp).all())


@pytest.mark.parametrize("bias", [True, False])
def test_dense(bias):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 7, 24)).astype(np.float32)
    w = rng.normal(size=(24, 40)).astype(np.float32) / 5
    b = rng.normal(size=(40,)).astype(np.float32)
    p = {"w": jnp.asarray(w)}
    if bias:
        p["b"] = jnp.asarray(b)
    want = np.asarray(JN.dense(p, jnp.asarray(x)))
    got = PN.dense(_t(x), _t(w.T), _t(b) if bias else None).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("eps", [1e-5, 1e-12])
def test_layer_norm(eps):
    rng = np.random.default_rng(2)
    x = rng.normal(3, 2, size=(5, 6, 48)).astype(np.float32)
    s = rng.normal(1, 0.1, size=(48,)).astype(np.float32)
    b = rng.normal(0, 0.1, size=(48,)).astype(np.float32)
    want = np.asarray(JN.layer_norm({"scale": jnp.asarray(s),
                                     "bias": jnp.asarray(b)},
                                    jnp.asarray(x), eps=eps))
    got = PN.layer_norm(_t(x), _t(s), _t(b), eps).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_dropout_is_identity_in_eval():
    x = torch.randn(4, 5)
    assert PN.dropout(x, 0.1, training=False) is x
    g = torch.Generator().manual_seed(0)
    y = PN.dropout(x, 0.5, training=True, generator=g)
    kept = y != 0
    torch.testing.assert_close(y[kept], x[kept] / 0.5)


@pytest.mark.parametrize("mask_kind", ["none", "bool", "additive"])
def test_mha(mask_kind):
    rng = np.random.default_rng(3)
    b, sq, sk, d, heads = 2, 3, 9, 24, 4
    q = rng.normal(size=(b, sq, d)).astype(np.float32)
    kv = rng.normal(size=(b, sk, d)).astype(np.float32)
    in_w = rng.normal(size=(d, 3 * d)).astype(np.float32) / 5
    in_b = rng.normal(size=(3 * d,)).astype(np.float32) / 10
    out_w = rng.normal(size=(d, d)).astype(np.float32) / 5
    out_b = rng.normal(size=(d,)).astype(np.float32) / 10
    mask_np = None
    if mask_kind == "bool":
        mask_np = np.ones((b, sk), bool)
        mask_np[1, 6:] = False
    elif mask_kind == "additive":
        mask_np = rng.normal(size=(b, 1, sq, sk)).astype(np.float32)
    params = {"in_w": jnp.asarray(in_w), "in_b": jnp.asarray(in_b),
              "out": {"w": jnp.asarray(out_w), "b": jnp.asarray(out_b)}}
    want = np.asarray(JN.mha(params, jnp.asarray(q), jnp.asarray(kv),
                             jnp.asarray(kv), heads,
                             mask=None if mask_np is None else jnp.asarray(mask_np)))
    got = PN.mha(_t(q), _t(kv), _t(kv), _t(in_w.T), _t(in_b), _t(out_w.T),
                 _t(out_b), heads,
                 mask=None if mask_np is None else _t(mask_np)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_modules_carry_reference_names():
    g = torch.Generator().manual_seed(0)
    m = PN.MultiheadAttention(24, 4, generator=g)
    assert set(m.state_dict()) == {"in_proj_weight", "in_proj_bias",
                                   "out_proj.weight", "out_proj.bias"}
    lin = PN.Linear(8, 4, bias=False, dtype=torch.bfloat16, generator=g)
    assert set(lin.state_dict()) == {"weight"}
    assert lin.weight.dtype == torch.bfloat16
    assert set(PN.LayerNorm(8, 1e-5).state_dict()) == {"weight", "bias"}
