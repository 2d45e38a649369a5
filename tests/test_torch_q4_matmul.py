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


# ---------------------------------------------------------------------------
# K4's launch plan and a CPU model of the card kernel (csrc/q4_matmul.cu)

VICUNA_Q4 = {"wqkv": (4096, 12288), "wo": (4096, 4096), "gateup": (4096, 22016),
             "down": (11008, 4096)}
Q4_PLAN_SHAPES = ([(m, k, n, 512) for m in (1, 5, 16, 56, 64, 65, 256)
                   for k, n in VICUNA_Q4.values()]
                  + [(16, 640, 72, 640), (3, 64, 192, 128), (70, 1184, 40, 128),
                     (5, 32768, 128, 512), (9, 2560, 4096, 512)])


def _split_ranges(plan, k):
    ktiles = -(-k // tq4.KTILE)
    return [range(s * plan.per, min((s + 1) * plan.per, ktiles)) for s in range(plan.splits)]


@pytest.mark.parametrize("m,k,n,group", Q4_PLAN_SHAPES)
def test_q4_plan_covers_every_k_tile_once_on_group_boundaries(m, k, n, group):
    plan = tq4._plan(m, n, k, group, asym=True)
    ktiles = -(-k // tq4.KTILE)
    ranges = _split_ranges(plan, k)
    assert all(len(r) > 0 for r in ranges)
    assert sorted(kt for r in ranges for kt in r) == list(range(ktiles))
    # every split starts where a group starts: K tile * 256 is a multiple of group
    assert all(r.start * tq4.KTILE % group == 0 for r in ranges)
    if plan.splits > 1:
        assert plan.per % tq4.group_stages(group) == 0
    assert plan.tiles(m, n) == -(-m // plan.wn) * -(-n // plan.rows)


@pytest.mark.parametrize("m,k,n,group", Q4_PLAN_SHAPES)
def test_q4_plan_splits_only_a_half_empty_card(m, k, n, group):
    plan = tq4._plan(m, n, k, group, asym=False)
    slots = tq4.SLOTS_PER_SM * tq4.SM_COUNT
    if plan.splits > 1:
        assert 2 * plan.tiles(m, n) <= slots and plan.per >= 4
        assert plan.tiles(m, n) <= tq4.TICKETS
    else:
        assert 2 * plan.tiles(m, n) > slots or -(-k // tq4.KTILE) < 2 * 4
    assert not plan.asym


@pytest.mark.parametrize("m", [1, 5, 16])
def test_q4_plan_at_decode_rows(m):
    """wqkv and gateup fill the card unsplit (gateup with 128-row blocks);
    wo and down split K 4 ways, down in 4 splits of 12 stages (two stages a
    group of 512; T3's plan would cut 43 stages into 11s, through a group)."""
    plans = {name: tq4._plan(m, n, k, 512, asym=True) for name, (k, n) in VICUNA_Q4.items()}
    assert [p.rows for p in plans.values()] == [64, 64, 128, 64]
    assert [p.splits for p in plans.values()] == [1, 4, 1, 4]
    assert plans["down"].per == 12 and plans["wo"].per == 4
    assert all(p.asym for p in plans.values())


@pytest.mark.parametrize("rows", [128, 64])
@pytest.mark.parametrize("wn", tq4.WNS)
def test_q4_plan_blocks_fit_the_card(rows, wn):
    """Two blocks of the ring (and the 1 KB the card reserves for each) fit
    an SM's shared memory; two warpgroups only at wn <= 32."""
    if rows == 128 and wn == 64:
        assert tq4._plan(256, 22016, 4096, 512, asym=True).rows == 64
        return
    for asym in (True, False):
        plan = tq4.Plan(wn, rows, tq4.STAGES[rows][wn], 1, 1, asym)
        assert tq4.SLOTS_PER_SM * (plan.smem() + 1024) <= tq4.SMEM_PER_SM
        assert plan.smem() < 113 * 1024 and plan.stages >= 4


def _byte_perm(x, y, sel):
    """CUDA's __byte_perm on uint32 arrays: byte i of the result is byte
    (sel >> 4 i) & 7 of the eight bytes y:x."""
    src = (y.astype(np.uint64) << np.uint64(32)) | x.astype(np.uint64)
    sel = np.broadcast_to(np.asarray(sel, np.uint64), x.shape)
    out = np.zeros(x.shape, np.uint64)
    for i in range(4):
        b = (sel >> np.uint64(4 * i)) & np.uint64(7)
        out |= ((src >> (b * np.uint64(8))) & np.uint64(0xFF)) << np.uint64(8 * i)
    return out.astype(np.uint32)


def _swizzle(rows):
    """(R, 128) bytes as TMA's 128-byte swizzle stores them: 16-byte chunk c
    of row r at chunk c ^ (r % 8)."""
    out = np.empty_like(rows)
    for r in range(rows.shape[0]):
        for c in range(8):
            p = c ^ (r % 8)
            out[r, 16 * p:16 * p + 16] = rows[r, 16 * c:16 * c + 16]
    return out


def _box(a, r0, rows, c0):
    """a[r0:r0+rows, c0:c0+128] with zero fill past every edge (TMA's box)."""
    out = np.zeros((rows, 128), np.uint8)
    part = a[r0:r0 + rows, c0:c0 + 128]
    out[:part.shape[0], :part.shape[1]] = part
    return out


def _unpack_model(w_phys, r0, g, t):
    """csrc/w4_tma.cuh ``unpack<false>`` for every thread at once: the A
    registers (threads, 8 products, 4) of weight rows r0 and r0 + 8 of the
    swizzled tile w_phys (rows, 128) bytes."""
    def word(rows, chunk, w):
        off = ((chunk ^ g) << 4) + 4 * w
        b = w_phys[rows[:, None], off[:, None] + np.arange(4)].astype(np.uint32)
        return b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16) | (b[:, 3] << 24)
    high = np.uint32(0xF0F0F0F0)
    pick = np.where(t & 1, 0x7632, 0x5410)
    a = np.zeros((len(g), 8, 4), np.uint32)
    for j in range(8):
        for r in range(2):
            v = _byte_perm(word(r0 + 8 * r, j, t >> 1), word(r0 + 8 * r, j, 2 + (t >> 1)), pick)
            lo, hi = (v << np.uint32(4)) & high, v & high
            a[:, j, r] = _byte_perm(lo, hi, 0x5140)
            a[:, j, 2 + r] = _byte_perm(lo, hi, 0x7362)
    return a


def _a_matrix(a, rows, g, t, j):
    """Product j's A (64 NWG x 32 int8) from the threads' registers, in
    wgmma's fragment layout: register q holds rows row + 8 (q & 1), K
    4t + 16 (q >> 1) + byte."""
    out = np.zeros((64 * (rows.max() // 64 + 1), 32), np.int64)
    for q in range(4):
        b = np.ascontiguousarray(a[:, j, q]).view(np.uint8).reshape(-1, 4).view(np.int8)
        for i in range(4):
            out[rows + 8 * (q & 1), 4 * t + 16 * (q >> 1) + i] = b[:, i]
    return out


def k4_model(x8, w, gscale, goff, group, plan, order=None, seed=0):
    """A numpy model of csrc/q4_matmul.cu ``q4_tma_kernel``, thread by thread
    where indices matter: the swizzled stages (a second activation box that
    is not loaded keeps stale bytes, which its products meet with zero
    weights), the register unpack, wgmma's fragment
    layouts, the group ends after product 3 and 7, the row sums (the row-sum
    warp's published sums of each box row, box 1's zero where it is not
    loaded), the f32 terms in the plain version's
    order, split 0's running sum and the later splits' group terms in the
    workspace, and the last arriving block's sum in group order with its
    ticket. Blocks of one tile arrive in ``order`` (split indices)."""
    rng = np.random.default_rng(seed)
    m_, k_ = x8.shape
    n_ = w.shape[0]
    wn, rows, per = plan.wn, plan.rows, plan.per
    ktiles = -(-k_ // 256)
    splits = -(-ktiles // per)
    P, groups = group // 32, -(-k_ // group)
    xu, wu = x8.view(np.uint8), w.view(np.uint8)
    tid = np.arange(rows * 2)
    warp, lane = tid >> 5, tid & 31
    wg, wq, g, t = warp >> 2, warp & 3, lane >> 2, lane & 3
    wrow = wg * 64 + wq * 16 + g                      # the thread's first weight row
    ce = [(c, e) for c in range(wn // 8) for e in range(4)]
    col = np.array([8 * c + 2 * t_ + (e & 1) for c, e in ce for t_ in [0]])   # + 2t below
    C = np.full((m_, n_), np.nan, np.float32)
    ws = np.full((groups, m_, n_), np.nan, np.float32)
    tickets = np.zeros(-(-m_ // wn) * -(-n_ // rows), np.int64)

    def block(bx, by, z):
        b0, a0, kt0 = bx * wn, by * rows, z * per
        nk = min(kt0 + per, ktiles) - kt0
        n0 = a0 + wrow
        mm = b0 + col[None, :] + 2 * t[:, None]                       # (T, WN/2)
        nn = n0[:, None] + 8 * np.array([e >> 1 for _, e in ce])[None, :]
        arow = wrow[:, None] + 8 * np.array([e >> 1 for _, e in ce])[None, :]
        acol = col[None, :] + 2 * t[:, None]
        valid = (mm < m_) & (nn < n_)
        running = z == 0
        state = {"grp": kt0 * 8 // P, "left": P}
        facc = np.zeros((len(tid), wn // 2), np.float32)
        rsp = np.zeros((len(tid), wn // 4), np.int64)
        acc = np.zeros((rows, wn), np.int64)

        def scales():
            at = np.minimum(n0[:, None] + 8 * np.arange(2)[None, :], n_ - 1)
            inside = n0[:, None] + 8 * np.arange(2)[None, :] < n_
            gs = np.where(inside, gscale[state["grp"]][at], np.float32(0))
            go = np.where(inside, goff[state["grp"]][at], np.float32(0)) if goff is not None \
                else None
            return gs.astype(np.float32), go

        sc = {"v": scales()}

        def group_end():
            gs, go = sc["v"]
            rs = rsp.copy()
            rsp[:] = 0
            a_t = acc[arow, acol]
            e_hi = np.array([e >> 1 for _, e in ce])
            u = (a_t >> 4).astype(np.float32) * gs[:, e_hi]
            if goff is not None:
                rsel = np.array([2 * c + (e & 1) for c, e in ce])
                u = u + rs[:, rsel].astype(np.float32) * go[:, e_hi]
            if running:
                facc[:] = facc + u
            else:
                ws[state["grp"], mm[valid], nn[valid]] = u[valid]
            state["grp"] += 1
            if state["grp"] < groups:
                sc["v"] = scales()

        for i in range(nk):
            kt = kt0 + i
            w_phys = _swizzle(_box(wu, a0, rows, kt * 128))
            second = kt * 256 + 128 < k_
            boxes = [_swizzle(_box(xu, b0, wn, kt * 256))]
            boxes.append(_swizzle(_box(xu, b0, wn, kt * 256 + 128)) if second else
                         rng.integers(0, 256, (wn, 128), dtype=np.uint8))   # stale bytes
            a = _unpack_model(w_phys, wrow, g, t)
            logical = [np.zeros((wn, 128), np.int64) for _ in range(2)]
            for b in range(2):      # what wgmma's descriptor reads: the un-swizzled box
                for r in range(wn):
                    for c in range(8):
                        p = c ^ (r % 8)
                        logical[b][r, 16 * c:16 * c + 16] = \
                            boxes[b][r, 16 * p:16 * p + 16].view(np.int8)
            left = state["left"]
            first, mid = left == P, left == 4
            left = P - 4 if mid else left - 8
            last = (not mid or second) and (left == 0 or kt == ktiles - 1)
            state["left"] = P if left == 0 else left
            # the counter's flags are the product index's
            prod = 8 * kt
            assert (first, mid) == (prod % P == 0, (prod + 4) % P == 0)
            assert last == ((prod + 7) // P < groups
                            and ((prod + 8) % P == 0 or kt == ktiles - 1))

            def products(j0, keep):
                for j in range(j0, j0 + 4):
                    bmat = logical[j // 4][:, 32 * (j % 4):32 * (j % 4) + 32]
                    d = _a_matrix(a, wrow, g, t, j)[:rows] @ bmat.T
                    k0 = keep if j == j0 else 1
                    acc[:] = d + (acc if k0 else 0)

            # the row-sum warp's sums: box b row j at b wn + j, box 1 zero if not loaded
            sums = np.concatenate([boxes[0].view(np.int8).astype(np.int64).sum(axis=1),
                                   boxes[1].view(np.int8).astype(np.int64).sum(axis=1)
                                   if second else np.zeros(wn, np.int64)])

            def rowsums(b):
                for c in range(wn // 8):
                    for h in range(2):
                        rsp[:, 2 * c + h] += sums[b * wn + 8 * c + 2 * t + h]

            # every product is issued: box 1's, where it is not loaded, face
            # zero weights and add nothing to the group it may start
            products(0, 0 if first else 1)
            rowsums(0)
            if mid:
                group_end()
            products(4, 0 if mid else 1)
            rowsums(1)
            if last:
                group_end()

        if splits == 1 or running:
            (C if splits == 1 else ws[0])[mm[valid], nn[valid]] = facc[valid]
            if splits == 1:
                return
        tile = by * -(-m_ // wn) + bx
        tickets[tile] += 1
        if tickets[tile] != splits:
            return
        total = ws[0, mm[valid], nn[valid]].copy()
        for gi in range(per * 8 // P, groups):
            total = total + ws[gi, mm[valid], nn[valid]]
        C[mm[valid], nn[valid]] = total
        tickets[tile] = 0

    for by in range(-(-n_ // rows)):
        for bx in range(-(-m_ // wn)):
            for z in (order(splits) if order else range(splits)):
                block(bx, by, z)
    assert (tickets == 0).all() and not np.isnan(C).any()
    return C


def _q4_operands(m, k, n, group, asym, seed):
    rng = np.random.default_rng(seed)
    x8 = rng.integers(-127, 128, (m, k)).astype(np.int8)
    w = rng.integers(-128, 128, (n, k // 2)).astype(np.int8)
    groups = -(-k // group)
    gs = (rng.random((groups, n)) * 1e-3 + 1e-4).astype(np.float32)
    go = ((rng.random((groups, n)) - 0.5) * 1e-3).astype(np.float32) if asym else None
    return x8, w, gs, go


def test_k4_register_unpack_matches_unpack_q4():
    """The unpack's registers, read back through wgmma's A fragment layout,
    are 16 times unpack_q4's codes (NWG = 2: 128 weight rows)."""
    rng = np.random.default_rng(3)
    w = rng.integers(-128, 128, (128, 128)).astype(np.int8)       # one stage: 256 K values
    codes = tq4.unpack_q4(torch.from_numpy(w)).numpy().astype(np.int64)
    tid = np.arange(256)
    warp, lane = tid >> 5, tid & 31
    g, t = lane >> 2, lane & 3
    rows = (warp >> 2) * 64 + (warp & 3) * 16 + g
    a = _unpack_model(_swizzle(w.view(np.uint8)), rows, g, t)
    for j in range(8):
        np.testing.assert_array_equal(_a_matrix(a, rows, g, t, j),
                                      16 * codes[:, 32 * j:32 * j + 32])


def _reversed(s):
    return range(s - 1, -1, -1)


def _shuffled(s):
    return list(np.random.default_rng(s).permutation(s))


# a ragged down-like K (11008: 43 stages, 22 groups of 512, the last half
# zero fill); groups of 128 ending mid-stage at a ragged K whose last second
# box is real (1184) and one whose last second box is never loaded (1056);
# the mock's group of 640 (a group ending mid-stage every other group); the
# mock's K = 64; 128-row blocks and 64 activation rows over two row tiles
@pytest.mark.parametrize("m,k,n,group,rows", [
    (5, 11008, 72, 512, None), (16, 1184, 40, 128, None), (9, 1056, 64, 128, None),
    (3, 640, 72, 640, None), (2, 64, 24, 128, None), (17, 2560, 130, 512, 128),
    (70, 1184, 64, 128, None)])
@pytest.mark.parametrize("mode", ["asym", "sym"])
def test_k4_model_split_and_ordered_reduction_is_plain_bitwise(m, k, n, group, rows, mode):
    """The model of the card kernel is bitwise q4_matmul_acc_plain with the
    plan (split at 11008 and 2560), with K split as finely as the groups
    allow, the blocks of a tile arriving in reverse and in shuffled order,
    and without a split."""
    asym = mode == "asym"
    x8, w, gs, go = _q4_operands(m, k, n, group, asym, seed=m + k)
    want = tq4.q4_matmul_acc_plain(*(None if v is None else torch.from_numpy(v)
                                     for v in (x8, w, gs, go)), group).numpy()
    plan = tq4._plan(m, n, k, group, asym, rows=rows)
    assert (plan.splits > 1) == (k >= 2560)
    ktiles, unit = -(-k // tq4.KTILE), tq4.group_stages(group)
    finest = dataclasses.replace(plan, splits=-(-ktiles // unit), per=unit)
    for p, order in ((plan, _reversed), (finest, _reversed), (finest, _shuffled),
                     (dataclasses.replace(plan, splits=1, per=ktiles), None)):
        np.testing.assert_array_equal(k4_model(x8, w, gs, go, group, p, order), want)
