"""int8 flash-decode of the PyTorch port (radialog_tpu_torch/ops/flash_decode.py)
against the JAX package's Pallas kernel run in interpret mode, on the same
int8 cache, with the same block size (bs=8), with and without the shared
prefix.

Tolerance: atol=rtol=2e-3 (outputs are O(1)). Both walk the same blocks in
the same order, so the int32 scores are exact and the f32 softmax agrees to
a few ulp; the one coarse step is pv = bf16(p * vs), where an ulp-level
difference in p can flip a bf16 rounding (a 2^-8 relative step on one
term's weight)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radialog_tpu.models.llama import quantize_kv as jquantize_kv
from radialog_tpu.ops.flash_decode import flash_decode_int8 as jflash
from radialog_tpu_torch import bridge
from radialog_tpu_torch.models.llama import quantize_kv
from radialog_tpu_torch.ops import flash_decode as tfd

L, B, S, H, D = 2, 3, 16, 4, 8
P0, P0P = 5, 8
TOL = dict(atol=2e-3, rtol=2e-3)


def _cache(seed):
    rng = np.random.default_rng(seed)
    k8, ks = jquantize_kv(jnp.asarray(rng.normal(size=(L, B, S, H, D)), jnp.float32))
    v8, vs = jquantize_kv(jnp.asarray(rng.normal(size=(L, B, S, H, D)), jnp.float32))
    k0, ks0 = jquantize_kv(jnp.asarray(rng.normal(size=(P0P, H, D)), jnp.float32))
    v0, vs0 = jquantize_kv(jnp.asarray(rng.normal(size=(P0P, H, D)), jnp.float32))
    q = rng.normal(size=(B, H, D)).astype(np.float32)
    j = dict(k8=k8.reshape(L, B, S, H * D), ks=ks, v8=v8.reshape(L, B, S, H * D), vs=vs,
             shared=(k0.reshape(P0P, H * D), ks0, v0.reshape(P0P, H * D), vs0))
    t = bridge.to_torch({name: (tuple(np.asarray(x) for x in a) if name == "shared"
                                else np.asarray(a)) for name, a in j.items()})
    return q, j, t


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("lengths,step", [([5, 16, 9], 2), ([0, 3, 12], 0), ([1, 1, 1], 3)])
def test_static_slot_matches_pallas_interpret(shared, lengths, step):
    q, j, t = _cache(7)
    prompt_pad, li = 12, 1
    lens = np.asarray(lengths, np.int32)
    kw_j = dict(shared=(tuple(x[None] for x in j["shared"])), p0=P0) if shared else {}
    kw_t = dict(shared=t["shared"], p0=P0) if shared else {}
    ref = np.asarray(jflash(jnp.asarray(q), j["k8"], j["ks"], j["v8"], j["vs"],
                            jnp.asarray(lens), prompt_pad, step, layer_idx=li, bs=8,
                            interpret=True, **kw_j))
    got = tfd.flash_decode_int8(torch.from_numpy(q), t["k8"], t["ks"], t["v8"], t["vs"],
                                torch.from_numpy(lens), prompt_pad, step, layer_idx=li,
                                bs=8, **kw_t).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, **TOL)


def test_per_lane_intervals_match_pallas_interpret():
    q, j, t = _cache(9)
    lens = np.asarray([4, 0, 7], np.int32)
    iv = [np.asarray(x, np.int32) for x in ([8, 4, 9], [10, 6, 12], [0, 14, 0], [-1, 15, -1])]
    ref = np.asarray(jflash(jnp.asarray(q), j["k8"], j["ks"], j["v8"], j["vs"],
                            jnp.asarray(lens), layer_idx=0, bs=8, interpret=True,
                            gen_intervals=tuple(jnp.asarray(x) for x in iv)))
    got = tfd.flash_decode_int8(torch.from_numpy(q), t["k8"], t["ks"], t["v8"], t["vs"],
                                torch.from_numpy(lens), layer_idx=0, bs=8,
                                gen_intervals=tuple(torch.from_numpy(x) for x in iv)).numpy()
    np.testing.assert_allclose(got, ref, **TOL)


def test_q_quantization_is_quantize_kv_at_f32_scales():
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(5, 4, 16)).astype(np.float32))
    q8, qs = tfd.quantize_q(x)
    k8, ks = quantize_kv(x, torch.float32)
    assert torch.equal(q8, k8) and torch.equal(qs, ks)


def test_empty_lane_without_prefix_is_zero_not_nan():
    _, _, t = _cache(5)
    q = torch.ones(B, H, D)
    out = tfd.flash_decode_int8(q, t["k8"], t["ks"], t["v8"], t["vs"],
                                torch.zeros(B, dtype=torch.int32),
                                gen_intervals=(torch.zeros(B), torch.full((B,), -1),
                                               torch.zeros(B), torch.full((B,), -1)),
                                bs=8)
    assert torch.equal(out, torch.zeros_like(out))


def test_block_size_rule_matches_jax():
    assert tfd.default_bs(384) == 64 and tfd.default_bs(32) == 32
    assert tfd.resolve_bs(448, 256) == 224 and tfd.resolve_bs(16, 8) == 8
