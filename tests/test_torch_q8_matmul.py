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
    theirs = bridge.packed_q8(_packed_dict(jq8.pack_q8(w)), k, device="cpu")
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


def test_div127_is_an_ieee_division_by_a_kept_constant(monkeypatch):
    """div127 divides as numpy does (no reciprocal product), with one 0-dim
    divisor kept per device: no call makes a tensor from a Python value
    (on the card that is a host copy and a stream wait). A divisor first
    made under inference mode still works in autograd."""
    x = torch.from_numpy(np.random.default_rng(2).normal(size=(5, 64)).astype(np.float32))
    x[0, :3] = torch.tensor([1.0, 3.0, 1e-8])
    np.testing.assert_array_equal(tq8.div127(x).numpy(), x.numpy() / np.float32(127.0))
    tq8._f32_127.cache_clear()
    with torch.inference_mode():
        first = tq8._f32_127(x.device)
        tq8.div127(x)
    assert tq8._f32_127(x.device) is first and not first.is_inference()
    assert first.dtype == torch.float32 and first.shape == ()
    made = []
    for owner, name in ((torch, "tensor"), (torch, "as_tensor"), (torch, "full"),
                        (torch.Tensor, "new_tensor"), (torch.Tensor, "new_full")):
        real = getattr(owner, name)
        monkeypatch.setattr(owner, name, lambda *a, real=real, name=name, **k:
                            made.append(name) or real(*a, **k))
    tq8.quantize_act(x)
    tq8.pack_q8(x.T.contiguous())
    monkeypatch.undo()
    assert made == []
    leaf = x.clone().requires_grad_(True)
    tq8.div127(leaf).sum().backward()
    np.testing.assert_array_equal(leaf.grad.numpy(), np.full(x.shape, np.float32(1) / np.float32(127)))


@pytest.mark.parametrize("m,k,n", SHAPES)
@pytest.mark.parametrize("bias", [False, True])
def test_q8_matmul_matches_jax_reference_bitwise(m, k, n, bias):
    x, w = _inputs(m, k, n, 2)
    b = np.linspace(-1, 1, n).astype(np.float32) if bias else None
    jp = jq8.pack_q8(w, b=None if b is None else jnp.asarray(b))
    tp = bridge.packed_q8(_packed_dict(jp), k, device="cpu")
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
    got = tq8.q8_matmul(torch.from_numpy(x), bridge.packed_q8(_packed_dict(jp), k, device="cpu"),
                        out_dtype=torch.float32).numpy()
    np.testing.assert_array_equal(got, ref)


# the Vicuna-7B projections (K, N) and the rows of the main paths: serve
# decode lanes, report decode, all-QA lanes, a full admission, report prefill
VICUNA = [(4096, 12288), (4096, 4096), (4096, 22016), (11008, 4096), (4096, 32001)]
# 440, 448: the correction prefills at full width (437-445 tokens padded to
# a multiple of 8); 456, 472: partial last 64-row tiles beyond them
ROWS = [1, 16, 48, 56, 64, 65, 128, 256, 440, 448, 456, 472, 4480]


def test_split_rule_fills_the_card_at_decode():
    # decode shapes with few output tiles split K and fill the card's 132
    # SMs; prefill shapes do not split
    for k, n in VICUNA:
        plan = tq8._plan(56, n, k)
        assert plan.route == "swap" and plan.blocks(56, n) >= tq8.SM_COUNT
    assert tq8._plan(56, 4096, 4096).splits > 1
    assert tq8._plan(56, 4096, 11008).splits > 1
    assert tq8._plan(56 * 80, 4096, 4096).splits == 1
    assert tq8._plan(56, 32001, 4096).splits == 1


@pytest.mark.parametrize("m", ROWS)
@pytest.mark.parametrize("k,n", VICUNA + [(48, 9), (64, 129), (11008, 33)])
def test_plan_covers_every_k_tile_once(m, k, n):
    plan = tq8._plan(m, n, k)
    ktiles = -(-k // tq8.KTILE)
    covered = [t for z in range(plan.splits)
               for t in range(z * plan.per, min((z + 1) * plan.per, ktiles))]
    assert covered == list(range(ktiles))
    assert all(z * plan.per < ktiles for z in range(plan.splits))   # no empty split
    if plan.splits > 1:
        assert plan.per >= tq8.MIN_SPLIT_KTILES


@pytest.mark.parametrize("m", ROWS)
def test_plan_route_follows_m(m):
    for k, n in VICUNA:
        plan = tq8._plan(m, n, k)
        if m <= tq8.DECODE_MAX_M:
            # C^T = W . X^T: the rows are wgmma's N, padded to 8, 16, 32 or 64
            assert plan.route == "swap" and plan.tile == (plan.wn, 64)
            assert plan.wn in (8, 16, 32, 64) and m <= plan.wn and (plan.wn == 8 or plan.wn < 2 * m)
            assert plan.blocks(m, n) >= tq8.SM_COUNT
            # two blocks an SM: the split never queues a second wave
            assert plan.splits == 1 or plan.blocks(m, n) <= 2 * tq8.SM_COUNT
        else:
            assert plan.route == "wgmma" and plan.tile == (128, plan.wn)
            assert (plan.wn, plan.stages) in ((256, 4), (128, 6))
            assert plan.splits == 1 or plan.blocks(m, n) <= tq8.SM_COUNT
            # the narrow tile only where the wide one would leave half the card empty
            wide_tiles = -(-m // 128) * -(-n // 256)
            assert (plan.wn == 128) == (2 * wide_tiles <= tq8.SM_COUNT)
    assert tq8._plan(4480, 4096, 4096).tile == (128, 256)
    assert tq8._plan(256, 4096, 4096).tile == (128, 128)
