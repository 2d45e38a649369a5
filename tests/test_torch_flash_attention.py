"""Flash attention of the PyTorch port (radialog_tpu_torch/ops/flash_attention.py,
the plain version of K3) against the JAX package's Pallas kernel run in
interpret mode, on the same inputs and block sizes.

Tolerances: in f32, atol=rtol=1e-5 (both walk the same blocks with the same
online update; only the order of the f32 sums inside a block differs). In
bf16, outputs are compared in f32 at atol=rtol=1e-2: the products are
exact in f32 on both sides, but an ulp of difference in p can flip its
bf16 rounding before p @ v, and the output's own bf16 step near 1 is
3.9e-3. lse is f32 on both sides: atol=1e-5, rtol=1e-6."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radialog_tpu.ops.flash_attention import _fwd_call
from radialog_tpu.ops.flash_attention import flash_attention as jflash
from radialog_tpu_torch.ops import flash_attention as tfa

TOL = {"float32": dict(atol=1e-5, rtol=1e-5), "bfloat16": dict(atol=1e-2, rtol=1e-2)}


def _inputs(b, t, s, h, d, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32)
            for shape in ((b, t, h, d), (b, s, h, d), (b, s, h, d))]


def _to(x, dtype):
    return jnp.asarray(x, getattr(jnp, dtype)), torch.from_numpy(x).to(getattr(torch, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,t,h,d,lens,causal,blk", [
    (2, 40, 2, 16, [40, 40], True, 16),      # T not a multiple of the block
    (3, 40, 2, 16, [40, 23, 1], True, 16),   # ragged, one length below T
    (2, 72, 4, 32, [72, 50], False, 32),     # non-causal
    (1, 300, 2, 16, [300], True, 256),       # the default block, T > 256
])
def test_plain_matches_pallas_interpret(dtype, b, t, h, d, lens, causal, blk):
    q, k, v = _inputs(b, t, t, h, d)
    (jq, tq), (jk, tk), (jv, tv) = (_to(x, dtype) for x in (q, k, v))
    lengths = np.asarray(lens, np.int32)
    ref = np.asarray(jflash(jq, jk, jv, jnp.asarray(lengths), causal=causal, bq=blk, bk=blk,
                            interpret=True).astype(jnp.float32))
    got = tfa.flash_attention(tq, tk, tv, torch.from_numpy(lengths), causal=causal)
    if blk != 256:
        got = tfa.flash_attention_plain(tq, tk, tv, torch.from_numpy(lengths),
                                        causal=causal, bq=blk, bk=blk)
    assert got.dtype == tq.dtype
    np.testing.assert_allclose(got.float().numpy(), ref, **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lse_matches_pallas_interpret(dtype):
    b, t, h, d, blk = 3, 40, 2, 16, 16
    q, k, v = _inputs(b, t, t, h, d, seed=1)
    lengths = np.asarray([40, 17, 3], np.int32)
    tp = 48                                   # padded to the block multiple

    def padded(x):
        x = np.pad(x, ((0, 0), (0, tp - t), (0, 0), (0, 0))).transpose(0, 2, 1, 3)
        return jnp.asarray(x, getattr(jnp, dtype))

    _, jlse = _fwd_call(padded(q), padded(k), padded(v), jnp.asarray(lengths), True,
                        d ** -0.5, blk, blk, True, True)
    ref = np.asarray(jlse)[:, :, :t, 0]
    tq, tk, tv = (_to(x, dtype)[1] for x in (q, k, v))
    _, lse = tfa.flash_attention_plain(tq, tk, tv, torch.from_numpy(lengths), with_lse=True,
                                       bq=blk, bk=blk)
    assert lse.shape == (b, h, t) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), ref, atol=1e-5, rtol=1e-6)


def test_zero_length_lane_is_zero_with_dead_lse():
    """What the JAX docstring states for a lane of length 0 (its arithmetic
    gives the mean of the zero-padded V blocks instead; no caller passes a
    zero length)."""
    q, k, v = (torch.from_numpy(x) for x in _inputs(2, 8, 8, 2, 16, seed=2))
    out, lse = tfa.flash_attention(q, k, v, torch.tensor([0, 5], dtype=torch.int32),
                                   with_lse=True)
    assert torch.equal(out[0], torch.zeros_like(out[0]))
    assert bool((lse[0] == tfa.LSE_DEAD).all())
    assert bool(torch.isfinite(out[1]).all()) and bool((lse[1] < 1e29).all())


def test_wrapper_takes_the_plain_version_on_the_cpu(monkeypatch):
    calls = []
    monkeypatch.setattr(tfa, "flash_attention_kernel", lambda *a, **kw: calls.append(1))
    q = torch.zeros(1, 4, 1, 16)
    tfa.flash_attention(q, q, q, torch.tensor([4], dtype=torch.int32))
    assert not calls
