"""The prototypes of the TPU microbench tools in the PyTorch port: T1, the
fused-KV flash-decode (radialog_tpu_torch/ops/flash_decode.py
``flash_decode_int8_fused``) against tools/microbench_kvfused.py's check,
and T2/T3, the per-column W4A8 products (radialog_tpu_torch/ops/w4_colscale.py)
against tools/microbench_w4.py's Pallas kernels under
``force_tpu_interpret_mode``; then both ported tools at a tiny shape on the
CPU through the plain versions.

Tolerances: T1's plain version bitwise against the port's K2 plain version
on the split halves (the JAX tool asserts that its T1 equals its K2 bit for
bit, and the card check holds T1 to K2 bitwise), and within 1e-6 of JAX
``flash_decode_int8`` (interpret mode) on the same halves: the JAX kernel
sums p * v as a matmul whose f32 order differs from the plain version's
(measured 1.2e-7 on outputs of O(1)); the int32 products bitwise (exact
integer sums); ``q4c_matmul`` in bf16 within one bf16 step of the tool's
``q4_matmul`` / ``q4p_matmul`` (the same f32 products, rounded once)."""
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from radialog_tpu.ops.flash_decode import flash_decode_int8 as jflash
from radialog_tpu_torch.ops import flash_decode as tfd
from radialog_tpu_torch.ops import w4_colscale as tw

REPO = Path(__file__).resolve().parent.parent


def _tool(name):
    spec = importlib.util.spec_from_file_location(name, REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def mw4():
    return _tool("microbench_w4")


@pytest.mark.parametrize("step", [0, 9, 50])
def test_fused_kv_plain_matches_jax_on_the_halves(step):
    """At step 50 the generated rows run past the cache: the live bound
    clamps to the last block in both."""
    rng = np.random.default_rng(step)
    L, B, S, H, D, pp = 2, 4, 64, 2, 16, 16
    hd = H * D
    kv8 = rng.integers(-127, 128, (L, B, S, 2 * hd)).astype(np.int8)
    kvs = (rng.random((L, B, S, 2 * H)) * 0.02).astype(np.float32)
    kvs = np.asarray(jnp.asarray(kvs, jnp.bfloat16))
    q = rng.normal(size=(B, H, D)).astype(np.float32)
    lens = np.full((B,), pp, np.int32)
    ref = jflash(jnp.asarray(q), jnp.asarray(kv8[..., :hd]), jnp.asarray(kvs[..., :H]),
                 jnp.asarray(kv8[..., hd:]), jnp.asarray(kvs[..., H:]), jnp.asarray(lens), pp,
                 step, layer_idx=1, bs=32, interpret=True)
    tkv8 = torch.from_numpy(kv8)
    tkvs = torch.from_numpy(kvs.astype(np.float32)).to(torch.bfloat16)
    tq, tlens = torch.from_numpy(q), torch.from_numpy(lens)
    got = tfd.flash_decode_int8_fused(tq, tkv8, tkvs, tlens, pp, step, layer_idx=1, bs=32)
    k2 = tfd.flash_decode_int8(tq, tkv8[..., :hd].contiguous(), tkvs[..., :H].contiguous(),
                               tkv8[..., hd:].contiguous(), tkvs[..., H:].contiguous(), tlens,
                               pp, step, layer_idx=1, bs=32)
    assert torch.equal(got, k2)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-6)


def test_pack_q4c_matches_the_tool(mw4):
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((512, 1000)) * 0.02).astype(np.float32)
    w[:, 3] = 0.0                                   # an all-zero column: the 1e-8 floor
    p = mw4.pack_q4(w)
    kt, nt, bk2, bn = p.w_t.shape
    tool = p.w_t.transpose(0, 2, 1, 3).reshape(kt * bk2, nt * bn)[:, :1000].T
    mine = tw.pack_q4c(torch.from_numpy(w))
    np.testing.assert_array_equal(mine.w.numpy(), tool)
    np.testing.assert_array_equal(mine.scale.numpy(), p.scale[:1000])
    codes = tw.unpack_q4(mine.w)
    assert int(codes.min()) >= -7 and int(codes.max()) <= 7


def test_pack_q4c_matches_the_tool_at_its_default_shape(mw4):
    """tools/microbench_w4_torch.py's spot-check weight, (4096, 4096) of std
    0.02 drawn from its seed: the codes and scales bit for bit."""
    w = torch.randn((4096, 4096), generator=torch.Generator().manual_seed(0)) * 0.02
    p = mw4.pack_q4(w.numpy())
    kt, nt, bk2, bn = p.w_t.shape
    mine = tw.pack_q4c(w)
    assert mine.w.numpy().tobytes() == p.w_t.transpose(0, 2, 1, 3).reshape(
        kt * bk2, nt * bn)[:, :4096].T.tobytes()
    assert mine.scale.numpy().tobytes() == p.scale[:4096].tobytes()


@pytest.mark.parametrize("m", [8, 5])
def test_int32_products_match_the_tool_kernels(mw4, m):
    rng = np.random.default_rng(m)
    k, n = 512, 1024
    w = (rng.standard_normal((k, n)) * 0.02).astype(np.float32)
    x8 = rng.integers(-127, 128, (m, k)).astype(np.int8)
    packed = tw.pack_q4c(torch.from_numpy(w))
    xp = x8.reshape(m, k // 2, 2)
    with pltpu.force_tpu_interpret_mode():
        t2 = np.asarray(mw4._w4a8_tiled(jnp.asarray(xp[:, :, 0]), jnp.asarray(xp[:, :, 1]),
                                        jnp.asarray(mw4.pack_q4(w).w_t)))
        t3 = np.asarray(mw4._w4p_tiled(jnp.asarray(x8), mw4.pack_q4n(w).w_t))
    plain = tw.w4_int32_plain(torch.from_numpy(x8), packed.w)
    assert plain.dtype == torch.int32
    np.testing.assert_array_equal(plain.numpy(), t2[:, :n])
    np.testing.assert_array_equal(plain.numpy(), t3[:, :n])
    split = tw.w4_int32_split(*tw.split_even_odd(torch.from_numpy(x8)), packed.w)
    assert torch.equal(split, plain) and torch.equal(tw.w4_int32(torch.from_numpy(x8),
                                                                 packed.w), plain)


@pytest.mark.parametrize("variant,tool_fn", [("w4", "q4_matmul"), ("w4p", "q4p_matmul")])
def test_q4c_matmul_matches_the_tool(mw4, variant, tool_fn):
    rng = np.random.default_rng(1)
    w = (rng.standard_normal((512, 1024)) * 0.02).astype(np.float32)
    x = jnp.asarray(rng.standard_normal((8, 512)).astype(np.float32), jnp.bfloat16)
    pack = mw4.pack_q4 if variant == "w4" else mw4.pack_q4n
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(getattr(mw4, tool_fn)(x, pack(w)).astype(jnp.float32))
    got = tw.q4c_matmul(torch.from_numpy(np.array(x.astype(jnp.float32))).to(torch.bfloat16),
                        tw.pack_q4c(torch.from_numpy(w)), variant)
    assert got.dtype == torch.bfloat16 and got.shape == (8, 1024)
    step = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(ref), 1e-30))) - 7)   # one bf16 ulp
    assert (np.abs(got.float().numpy() - ref) <= step).all()


def test_q4c_checks():
    with pytest.raises(ValueError, match="odd"):
        tw.pack_q4c(torch.zeros(5, 4))
    with pytest.raises(ValueError, match="variant"):
        tw.q4c_matmul(torch.zeros(2, 32), tw.pack_q4c(torch.ones(32, 8)), "w8")


# T2/T3's launch plan (ops/w4_colscale.py ``_plan``), pure Python: the card
# runs what it picks
PLAN_SHAPES = [(m, k, n) for m in (1, 5, 16, 32, 64, 256)
               for k, n in ((4096, 12288), (4096, 4096), (4096, 22016), (11008, 4096))] + [
    (70, 96, 40), (1, 96, 40), (65, 11008, 4100), (33, 4096, 4100), (256, 11008, 40),
    (1, 11008, 40), (5, 32768, 128)]


@pytest.mark.parametrize("m,wn", [(1, 8), (5, 8), (8, 8), (9, 16), (16, 16), (17, 32), (32, 32),
                                  (33, 64), (64, 64), (65, 64), (256, 64)])
def test_w4_plan_picks_wn_by_rows(m, wn):
    plan = tw._plan(m, 4096, 4096)
    assert plan.wn == wn and plan.rows == 64
    assert plan.stages == tw.STAGES[64][wn] >= 3


@pytest.mark.parametrize("m,k,n", PLAN_SHAPES)
@pytest.mark.parametrize("rows", [128, 64])
def test_w4_plan_covers_every_k_tile_once(m, k, n, rows):
    plan = tw._plan(m, n, k, rows=rows)
    ktiles = -(-k // tw.KTILE)
    ranges = [range(s * plan.per, min((s + 1) * plan.per, ktiles)) for s in range(plan.splits)]
    assert all(len(r) > 0 for r in ranges)
    assert sorted(kt for r in ranges for kt in r) == list(range(ktiles))
    # every output element lies in one tile: ragged N and rows past 64 included
    assert plan.tiles(m, n) == -(-m // plan.wn) * -(-n // rows)
    assert plan.wn * -(-m // plan.wn) >= m and rows * -(-n // rows) >= n


@pytest.mark.parametrize("m,k,n", PLAN_SHAPES)
def test_w4_plan_splits_only_a_half_empty_card(m, k, n):
    plan = tw._plan(m, n, k)
    slots = tw.SLOTS_PER_SM * tw.SM_COUNT
    if plan.splits > 1:
        assert 2 * plan.tiles(m, n) <= slots and plan.per >= 4
        assert plan.tiles(m, n) * plan.splits <= slots
    else:
        assert 2 * plan.tiles(m, n) > slots or -(-k // tw.KTILE) < 8


@pytest.mark.parametrize("m", [1, 5, 32, 64])
def test_w4_plan_at_decode_rows(m):
    """64-row blocks where they fit the card at once (wqkv, wo, down), 128
    for gateup, whose 344 tiles of 64 would not; K split for wo and down."""
    plans = [tw._plan(m, n, k) for k, n in
             ((4096, 12288), (4096, 4096), (4096, 22016), (11008, 4096))]
    assert [p.rows for p in plans] == [64, 64, 128, 64]
    assert [p.splits for p in plans] == [1, 4, 1, 4]


@pytest.mark.parametrize("m,k,n", PLAN_SHAPES)
def test_w4_plan_rows_fit_the_card_or_halve_the_tiles(m, k, n):
    plan, slots = tw._plan(m, n, k), tw.SLOTS_PER_SM * tw.SM_COUNT
    assert plan.rows == (64 if tw._plan(m, n, k, rows=64).tiles(m, n) <= slots else 128)


@pytest.mark.parametrize("rows", [128, 64])
@pytest.mark.parametrize("wn", tw.WNS)
def test_w4_plan_blocks_fit_the_card(rows, wn):
    """SLOTS_PER_SM blocks of the ring (and 1 KB the card reserves for each)
    fit an SM's shared memory."""
    plan = tw.Plan(wn, rows, tw.STAGES[rows][wn], 1, 1)
    assert tw.SLOTS_PER_SM * (plan.smem() + 1024) <= tw.SMEM_PER_SM
    assert plan.stages >= 3


def test_w4_kernels_refuse_a_k_past_int32_reach():
    """The kernels sum 16 q x products in int32: K up to MAX_K."""
    w = torch.zeros((8, (tw.MAX_K + 32) // 2), dtype=torch.int8)
    x8 = torch.zeros((1, tw.MAX_K + 32), dtype=torch.int8)
    with pytest.raises(ValueError, match="int32"):
        tw._check((x8,), w, tw.MAX_K + 32, "T3")


def _run(args):
    out = subprocess.run([sys.executable, *args], cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    return [json.loads(line) for line in out.stdout.splitlines()]


def test_kvfused_tool_runs_on_the_cpu():
    (line,) = _run(["tools/microbench_kvfused_torch.py", "--device", "cpu", "--batch", "4",
                    "--cache", "64", "--heads", "2", "--head-dim", "16", "--layers", "2",
                    "--prompt-pad", "16", "--step", "10", "--bs", "32"])
    assert line["bitwise"] and line["layers"] == 2 and "ms_fused" not in line


def test_w4_tool_runs_on_the_cpu():
    lines = _run(["tools/microbench_w4_torch.py", "--device", "cpu", "--variants",
                  "w8,w4,w4g,w4p,w4x", "--m", "20", "--hidden", "128", "--inter", "256",
                  "--layers", "2"])
    check, rows = lines[0], lines[1:]
    assert all(e < 0.2 for e in check["max_rel_err"].values()) and len(check["max_rel_err"]) == 2
    assert [r["variant"] for r in rows] == ["w8", "w4", "w4g", "w4p", "w4x"]
    assert all(r["finite"] and r["layers"] == 32 and "ms_per_chain" not in r for r in rows)
