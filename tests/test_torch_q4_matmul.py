"""W4A8 matmul of the PyTorch port against the JAX package on the CPU.

The packer runs the JAX package's numpy operations in the same order, so
codes, group scales and group offsets are held bitwise, at K values that
exercise every group geometry: 64 (padded to one group of 128), 128, 200
(padded to 256), 640 (one group of 640) and 2560 (padded to 3072: five
groups of 512 and a sixth of zeros only).

``q4_matmul_plain`` against the JAX kernel in Pallas interpret mode and
against ``q4_matmul_reference``: each group's integer sum is exact on every
side, so only f32 operations can differ: whether XLA fuses a multiply and an
add, and, for the reference, its sum over all groups at once with the offset
product added afterwards. The bound is rtol = 1e-5 with atol = 1e-5 of the
largest output (a few f32 ulps of the largest partial sum)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radialog_tpu.models import llama as jl
from radialog_tpu.ops import q4_matmul as jq4
from radialog_tpu.ops.quant import quantize_llama_host as jquantize
from radialog_tpu_torch import bridge
from radialog_tpu_torch.models import llama as tl
from radialog_tpu_torch.ops import q4_matmul as tq4
from radialog_tpu_torch.ops.layers import FP32, linear
from radialog_tpu_torch.ops.q8_matmul import PackedQ8
from radialog_tpu_torch.ops.quant import quantize_llama_host

from test_torch_llama import packed_tree

SHAPES = [(64, 96), (128, 64), (200, 40), (640, 72), (2560, 48)]


def jax_untiled(p):
    """A JAX PackedQ4 un-tiled: (codes (K_padded, N) int8, gscale, goff)."""
    w_t = np.asarray(p.w_t)
    kt, nt, bk2, bn = w_t.shape
    wi = w_t.transpose(0, 2, 1, 3).reshape(kt * bk2, nt * bn).astype(np.int32)
    codes = np.stack([((wi & 15) ^ 8) - 8, wi >> 4], axis=1).reshape(2 * kt * bk2, nt * bn)
    goff = None if p.goff is None else np.asarray(p.goff)[:, :p.n]
    return codes[:, :p.n].astype(np.int8), np.asarray(p.gscale)[:, :p.n], goff


def _weights(k, n, seed=0):
    rng = np.random.default_rng(seed + k)
    w = rng.normal(size=(k, n)).astype(np.float32) * 0.02
    w[:, 0] *= 5.0                      # an outlier channel
    w[k // 2:, 1] = 0.0                 # a half-empty channel
    return w


def assert_same_pack(mine, theirs, k):
    codes, gscale, goff = jax_untiled(theirs)
    assert mine.group == theirs.group and mine.k == k and mine.n == theirs.n
    np.testing.assert_array_equal(tq4.unpack_q4(mine.w).numpy().T, codes[:k])
    np.testing.assert_array_equal(mine.gscale.numpy(), gscale)
    if goff is None:
        assert mine.goff is None
    else:
        np.testing.assert_array_equal(mine.goff.numpy(), goff)


@pytest.mark.parametrize("mode", ["asym", "sym"])
@pytest.mark.parametrize("k,n", SHAPES)
def test_pack_q4_bitwise(k, n, mode):
    w = _weights(k, n)
    theirs = jq4.pack_q4(w, mode=mode)
    mine = tq4.pack_q4(w, mode=mode)
    assert mine.w.shape == (n, k // 2) and mine.w.dtype == torch.int8
    assert mine.gscale.shape[0] == -(-k // jq4.pick_bk(k)) * jq4.pick_bk(k) // mine.group
    assert_same_pack(mine, theirs, k)
    # the bridge un-tiles the JAX leaf into the same tensors
    carried = bridge.packed_q4(packed_tree(theirs), k, device="cpu")
    assert torch.equal(carried.w, mine.w) and torch.equal(carried.gscale, mine.gscale)
    assert carried.group == mine.group
    assert (carried.goff is None) == (mode == "sym")
    if mode == "asym":
        assert torch.equal(carried.goff, mine.goff)


def test_pack_q4_geometry_and_errors():
    assert [tq4.pick_bk(k) for k in (64, 200, 640, 2560, 4096, 11008)] == \
        [jq4.pick_bk(k) for k in (64, 200, 640, 2560, 4096, 11008)]
    assert tq4.pack_q4(_weights(2560, 8)).gscale.shape == (6, 8)   # a last group of zeros
    assert tq4.pack_q4(_weights(640, 8)).group == 640
    with pytest.raises(ValueError):
        tq4.pack_q4(_weights(64, 8), mode="other")
    with pytest.raises(ValueError):
        tq4.pack_q4(np.zeros((7, 8), np.float32))


@pytest.mark.parametrize("mode", ["asym", "sym"])
@pytest.mark.parametrize("k,n", SHAPES)
def test_q4_matmul_plain_matches_jax(k, n, mode):
    w = _weights(k, n, seed=1)
    bias = np.random.default_rng(k).normal(size=(n,)).astype(np.float32)
    x = np.random.default_rng(n).normal(size=(3, 5, k)).astype(np.float32)
    theirs = jq4.pack_q4(w, mode=mode, b=jnp.asarray(bias))
    theirs = jq4.PackedQ4(jnp.asarray(theirs.w_t), jnp.asarray(theirs.gscale), theirs.n,
                          theirs.group, theirs.b,
                          None if theirs.goff is None else jnp.asarray(theirs.goff))
    mine = tq4.pack_q4(w, mode=mode, b=bias)
    got = tq4.q4_matmul(torch.from_numpy(x), mine).numpy()
    assert got.shape == (3, 5, n)
    np.testing.assert_array_equal(got, tq4.q4_matmul_plain(torch.from_numpy(x), mine).numpy())
    kernel = np.asarray(jq4.q4_matmul_packed(jnp.asarray(x), theirs, out_dtype=jnp.float32,
                                             interpret=True))
    reference = np.asarray(jq4.q4_matmul_reference(jnp.asarray(x), theirs))
    tol = dict(rtol=1e-5, atol=1e-5 * float(np.abs(reference).max()))
    np.testing.assert_allclose(got, kernel, **tol)
    np.testing.assert_allclose(got, reference, **tol)
    # the bias is added after the rescale
    nobias = tq4.q4_matmul(torch.from_numpy(x), dataclasses.replace(mine, b=None)).numpy()
    np.testing.assert_allclose(got - nobias, np.broadcast_to(bias, got.shape), atol=1e-5)


def test_q4_acc_group_order_and_exact_sums():
    """The accumulator adds the groups in K order, one rounded multiply and
    one rounded add each, which a float64 evaluation in that order pins."""
    rng = np.random.default_rng(5)
    k, n, m, group = 1024, 24, 7, 512
    x8 = rng.integers(-127, 128, (m, k)).astype(np.int8)
    codes = rng.integers(-8, 8, (k, n)).astype(np.int8)
    packed = ((codes[1::2].astype(np.uint8) << 4) | (codes[0::2].astype(np.uint8) & 15)
              ).astype(np.int8).T.copy()
    gs = rng.uniform(0.5, 1.5, (2, n)).astype(np.float32)
    go = rng.uniform(-1, 1, (2, n)).astype(np.float32)
    np.testing.assert_array_equal(tq4.unpack_q4(torch.from_numpy(packed)).numpy().T, codes)
    got = tq4.q4_matmul_acc(torch.from_numpy(x8), torch.from_numpy(packed),
                            torch.from_numpy(gs), torch.from_numpy(go), group).numpy()
    want = np.zeros((m, n), np.float32)
    for g in range(2):
        xs = x8[:, g * group:(g + 1) * group].astype(np.int64)
        dot = (xs @ codes[g * group:(g + 1) * group].astype(np.int64)).astype(np.float32)
        upd = dot * gs[g][None] + xs.sum(1).astype(np.float32)[:, None] * go[g][None]
        want = want + upd
    np.testing.assert_array_equal(got, want)


def test_linear_dispatches_on_packed_q4():
    mine = tq4.pack_q4(_weights(128, 32))
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(2, 128)).astype(np.float32))
    assert torch.equal(linear(mine, x, FP32), tq4.q4_matmul(x, mine))
    assert mine.to("cpu").w.data_ptr() == mine.w.data_ptr()


@pytest.mark.parametrize("mode", ["asym", "sym"])
def test_quantize_llama_host_bits4_matches_jax_tree(mode):
    params = jax.tree_util.tree_map(np.asarray,
                                    jl.llama_init(jax.random.PRNGKey(0), jl.TINY_LLAMA))
    qp = jquantize(params, bits=4, w4_mode=mode)
    mine = quantize_llama_host(params, device="cpu", bits=4, w4_mode=mode)
    carried = bridge.llama_serving(packed_tree(qp), tl.TINY_LLAMA, device="cpu")
    k_of = {"wqkv": 64, "wo": 64, "gateup": 64, "down": 128}
    for i in range(jl.TINY_LLAMA.num_layers):
        for name, k in k_of.items():
            assert isinstance(mine["layers"][i][name], tq4.PackedQ4)
            assert_same_pack(mine["layers"][i][name], qp["layers"][i][name], k)
            assert torch.equal(carried["layers"][i][name].w, mine["layers"][i][name].w)
            assert torch.equal(carried["layers"][i][name].gscale,
                               mine["layers"][i][name].gscale)
    # the lm_head stays int8 at bits=4
    assert isinstance(mine["lm_head"], PackedQ8) and isinstance(carried["lm_head"], PackedQ8)
    assert torch.equal(mine["lm_head"].w, carried["lm_head"].w)
    with pytest.raises(ValueError):
        quantize_llama_host(params, device="cpu", bits=3)


def test_random_serving_params_bits4_layout():
    from radialog_tpu_torch.ops.quant import random_serving_params
    cfg = tl.TINY_LLAMA
    for mode in ("asym", "sym"):
        p = random_serving_params(cfg, torch.Generator().manual_seed(0), device="cpu", bits=4,
                                  w4_mode=mode)
        down = p["layers"][0]["down"]
        assert down.w.shape == (64, 64) and down.group == 128 and down.gscale.shape == (1, 64)
        assert (down.goff is None) == (mode == "sym")
        codes = tq4.unpack_q4(down.w)
        assert int(codes.min()) >= (-8 if mode == "asym" else -7) and int(codes.max()) <= 7
        assert isinstance(p["lm_head"], PackedQ8)
        x = torch.randn(3, 128, generator=torch.Generator().manual_seed(1))
        assert torch.isfinite(linear(down, x, FP32)).all()
