"""W8A8 matmul of the PyTorch port (radialog_tpu_torch/ops/q8_matmul.py)
against the JAX package's q8_matmul_reference and its Pallas kernel in
interpret mode. The bar is BITWISE: the int32 accumulator is exact in any
order (K * 127^2 < 2^31), the quantizers round identically, and the f32
epilogue multiplies in the same order ((acc * xs) * ws)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radialog_tpu.ops import q8_matmul as jq8
from radialog_tpu_torch import bridge
from radialog_tpu_torch.ops import q8_matmul as tq8

# (M, K, N): the Vicuna-7B depths 4096 and 11008 (K=11008 is no multiple of
# the TPU's 2048 tile, so the JAX pack pads K), odd N like lm_head's 32001
SHAPES = [(3, 4096, 40), (5, 11008, 33), (4, 64, 129), (1, 4096, 7)]


def _packed_dict(p):
    return {"w_t": np.asarray(p.w_t), "scale": np.asarray(p.scale), "n": p.n,
            "b": None if p.b is None else np.asarray(p.b)}


def _inputs(m, k, n, seed):
    rng = np.random.default_rng(seed)
    w = (rng.normal(size=(k, n)) * k ** -0.5).astype(np.float32)
    x = rng.normal(size=(m, k)).astype(np.float32)
    x[0, :3] = [0.0, 127.5 / 127, -0.5]   # exact ties for the half-even rounding
    return x, w


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_pack_matches_jax_bitwise(m, k, n):
    _, w = _inputs(m, k, n, 0)
    mine = tq8.pack_q8(w)
    theirs = bridge.packed_q8(_packed_dict(jq8.pack_q8(w)), k)
    assert mine.w.shape == (n, k) and mine.w.dtype == torch.int8
    assert torch.equal(mine.w, theirs.w)
    assert torch.equal(mine.scale, theirs.scale)


def test_quantize_act_matches_jax_bitwise():
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(7, 300)) * 3).astype(np.float32)
    x[1] = 0.0                                # all-zero row: the 1e-8 floor
    x[2, :4] = [1.0, -1.0, 0.5 / 127, 1.5 / 127]
    x8, xs = tq8.quantize_act(torch.from_numpy(x))
    j8, js = jq8.quantize_act(jnp.asarray(x))
    np.testing.assert_array_equal(x8.numpy(), np.asarray(j8))
    np.testing.assert_array_equal(xs.numpy(), np.asarray(js))


@pytest.mark.parametrize("m,k,n", SHAPES)
@pytest.mark.parametrize("bias", [False, True])
def test_q8_matmul_matches_jax_reference_bitwise(m, k, n, bias):
    x, w = _inputs(m, k, n, 2)
    b = np.linspace(-1, 1, n).astype(np.float32) if bias else None
    jp = jq8.pack_q8(w, b=None if b is None else jnp.asarray(b))
    tp = bridge.packed_q8(_packed_dict(jp), k)
    ref = np.asarray(jq8.q8_matmul_reference(jnp.asarray(x), jp, out_dtype=jnp.float32))
    got = tq8.q8_matmul(torch.from_numpy(x), tp, out_dtype=torch.float32).numpy()
    np.testing.assert_array_equal(got, ref)
    # the int32 accumulator alone, against an int64 numpy product
    x8, _ = tq8.quantize_act(torch.from_numpy(x))
    acc = tq8.q8_matmul_int32(x8, tp.w).numpy()
    np.testing.assert_array_equal(
        acc, x8.numpy().astype(np.int64) @ tp.w.numpy().astype(np.int64).T)


@pytest.mark.parametrize("m,k,n", [(3, 4096, 40), (5, 11008, 33)])
def test_q8_matmul_matches_pallas_interpret_bitwise(m, k, n):
    x, w = _inputs(m, k, n, 3)
    jp = jq8.pack_q8(w)
    ref = np.asarray(jq8.q8_matmul_packed(jnp.asarray(x), jp, out_dtype=jnp.float32,
                                          interpret=True))
    got = tq8.q8_matmul(torch.from_numpy(x), bridge.packed_q8(_packed_dict(jp), k),
                        out_dtype=torch.float32).numpy()
    np.testing.assert_array_equal(got, ref)


def test_split_rule_fills_the_card_at_decode():
    # decode shapes with few output tiles split K; prefill shapes do not
    assert tq8._splits(56, 4096, 4096) > 1
    assert tq8._splits(56, 4096, 11008) > 1
    assert tq8._splits(56 * 80, 4096, 4096) == 1
    assert tq8._splits(56, 32001, 4096) == 1
