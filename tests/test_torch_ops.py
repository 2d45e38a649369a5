"""Basic ops of the PyTorch port against the JAX package on the same seeded
inputs, FP32 policy. Tolerance rtol=atol=1e-5 unless stated: both compute
in float32 and differ only in summation order."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radialog_tpu.ops import attention as ja
from radialog_tpu.ops import image as jimg
from radialog_tpu.ops import layers as jl
from radialog_tpu.ops import rotary as jr
from radialog_tpu_torch.ops import attention as ta
from radialog_tpu_torch.ops import image as timg
from radialog_tpu_torch.ops import layers as tl
from radialog_tpu_torch.ops import rotary as tr

TOL = dict(rtol=1e-5, atol=1e-5)
RNG = np.random.default_rng(0)


def _t(x):
    return torch.from_numpy(np.array(x))


def _n(x):
    return np.asarray(x)


def test_norms_gelu_linear_embedding():
    x = RNG.normal(size=(2, 5, 16)).astype(np.float32)
    p = {"scale": RNG.normal(size=16).astype(np.float32),
         "bias": RNG.normal(size=16).astype(np.float32)}
    tp = {k: _t(v) for k, v in p.items()}
    np.testing.assert_allclose(tl.layernorm(tp, _t(x), 1e-6).numpy(),
                               _n(jl.layernorm(p, jnp.asarray(x), 1e-6)), **TOL)
    np.testing.assert_allclose(tl.rmsnorm(tp["scale"], _t(x)).numpy(),
                               _n(jl.rmsnorm(jnp.asarray(p["scale"]), jnp.asarray(x))), **TOL)
    np.testing.assert_allclose(tl.gelu_exact(_t(x)).numpy(),
                               _n(jl.gelu_exact(jnp.asarray(x))), **TOL)
    lp = {"w": RNG.normal(size=(16, 8)).astype(np.float32),
          "b": RNG.normal(size=8).astype(np.float32)}
    np.testing.assert_allclose(tl.linear({k: _t(v) for k, v in lp.items()}, _t(x)).numpy(),
                               _n(jl.linear(lp, jnp.asarray(x))), **TOL)
    table = RNG.normal(size=(10, 4)).astype(np.float32)
    ids = np.asarray([[1, 9, 0]], np.int32)
    np.testing.assert_array_equal(tl.embedding_lookup(_t(table), _t(ids)).numpy(),
                                  _n(jl.embedding_lookup(jnp.asarray(table), jnp.asarray(ids))))


@pytest.mark.parametrize("kernel,stride,padding", [(3, 1, "SAME"), (1, 2, "SAME"),
                                                   (7, 2, 3), (3, 2, 1), (3, 2, "SAME")])
def test_conv2d_nhwc(kernel, stride, padding):
    x = RNG.normal(size=(2, 9, 11, 3)).astype(np.float32)
    p = {"w": RNG.normal(size=(kernel, kernel, 3, 5)).astype(np.float32),
         "b": RNG.normal(size=5).astype(np.float32)}
    got = tl.conv2d({k: _t(v) for k, v in p.items()}, _t(x), stride, padding).numpy()
    ref = _n(jl.conv2d(p, jnp.asarray(x), stride, padding))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_batchnorm_eval_and_pools():
    x = RNG.normal(size=(2, 8, 8, 4)).astype(np.float32)
    p = {"scale": RNG.normal(size=4).astype(np.float32), "bias": RNG.normal(size=4).astype(np.float32)}
    s = {"mean": RNG.normal(size=4).astype(np.float32),
         "var": RNG.random(4).astype(np.float32) + 0.5, "count": np.zeros((), np.float32)}
    got = tl.batchnorm({k: _t(v) for k, v in p.items()}, {k: _t(v) for k, v in s.items()}, _t(x))
    ref, _ = jl.batchnorm(p, s, jnp.asarray(x), train=False)
    np.testing.assert_allclose(got.numpy(), _n(ref), **TOL)
    np.testing.assert_allclose(tl.max_pool2d(_t(x), 3, 2, 1).numpy(),
                               _n(jl.max_pool2d(jnp.asarray(x), 3, 2, 1)), **TOL)
    np.testing.assert_allclose(tl.avg_pool2d(_t(x), 4).numpy(),
                               _n(jl.avg_pool2d(jnp.asarray(x), 4)), **TOL)
    np.testing.assert_allclose(tl.global_avg_pool(_t(x)).numpy(),
                               _n(jl.global_avg_pool(jnp.asarray(x))), **TOL)


def test_mha_and_shared_prefix_and_biases():
    q = RNG.normal(size=(2, 3, 4, 8)).astype(np.float32)
    k = RNG.normal(size=(2, 6, 4, 8)).astype(np.float32)
    v = RNG.normal(size=(2, 6, 4, 8)).astype(np.float32)
    k0 = RNG.normal(size=(5, 4, 8)).astype(np.float32)
    v0 = RNG.normal(size=(5, 4, 8)).astype(np.float32)
    valid = np.asarray([[1, 1, 1, 1, 0, 0], [1, 1, 1, 1, 1, 1]])
    jb = ja.padding_mask_bias(jnp.asarray(valid))
    tb = ta.padding_mask_bias(_t(valid))
    np.testing.assert_array_equal(tb.numpy(), _n(jb))
    np.testing.assert_array_equal(ta.causal_mask_bias(3, 6, offset=2).numpy(),
                                  _n(ja.causal_mask_bias(3, 6, offset=2)))
    np.testing.assert_allclose(ta.mha(_t(q), _t(k), _t(v), bias=tb).numpy(),
                               _n(ja.mha(*map(jnp.asarray, (q, k, v)), bias=jb)), **TOL)
    got = ta.mha_shared_prefix(_t(q), _t(k0), _t(v0), _t(k), _t(v), bias1=tb).numpy()
    ref = _n(ja.mha_shared_prefix(*map(jnp.asarray, (q, k0, v0, k, v)), bias1=jb))
    np.testing.assert_allclose(got, ref, **TOL)


def test_rope():
    cos, sin = tr.rope_tables(16, 32)
    jcos, jsin = jr.rope_tables(16, 32)
    np.testing.assert_allclose(cos.numpy(), _n(jcos), **TOL)
    x = RNG.normal(size=(2, 3, 4, 16)).astype(np.float32)
    pos = np.asarray([[0, 5, 31], [2, 3, 4]], np.int32)
    np.testing.assert_allclose(tr.apply_rope(_t(x), cos, sin, _t(pos)).numpy(),
                               _n(jr.apply_rope(jnp.asarray(x), jcos, jsin, jnp.asarray(pos))),
                               **TOL)


def test_image_preprocessing():
    img = RNG.integers(0, 256, size=(60, 80), dtype=np.uint8)
    np.testing.assert_array_equal(timg.preprocess_cxr_np(img, 40, 32),
                                  jimg.preprocess_cxr_np(img, 40, 32))
    u8 = RNG.integers(0, 256, size=(2, 8, 8), dtype=np.uint8)
    np.testing.assert_array_equal(timg.expand_cxr_u8(_t(u8)).numpy(),
                                  _n(jimg.expand_cxr_u8(jnp.asarray(u8))))
    # antialiased bilinear resize: same triangle filter, weights summed in
    # another order — measured within 1e-4 of a grey level, held to 1e-6
    got = timg.preprocess_cxr(_t(img), 40, 32).numpy()
    ref = _n(jimg.preprocess_cxr(jnp.asarray(img), 40, 32))
    assert got.shape == ref.shape == (32, 32, 3)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
