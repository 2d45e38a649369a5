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
                                else np.asarray(a)) for name, a in j.items()}, device="cpu")
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


def test_long_shared_prefix_matches_pallas_interpret():
    """A 700-row shared prefix (past one shared-memory chunk of the card's
    kernel): the plain version keeps it as one block, as the JAX kernel."""
    _, j, t = _cache(11)
    rng = np.random.default_rng(12)
    p0, p0p = 700, 704
    k0, ks0 = jquantize_kv(jnp.asarray(rng.normal(size=(p0p, H, D)), jnp.float32))
    v0, vs0 = jquantize_kv(jnp.asarray(rng.normal(size=(p0p, H, D)), jnp.float32))
    shared = (k0.reshape(p0p, H * D), ks0, v0.reshape(p0p, H * D), vs0)
    q = (rng.normal(size=(B, H, D)) * 3).astype(np.float32)
    lens = np.asarray([5, 0, 12], np.int32)
    ref = np.asarray(jflash(jnp.asarray(q), j["k8"], j["ks"], j["v8"], j["vs"],
                            jnp.asarray(lens), 12, 2, layer_idx=1, bs=8, interpret=True,
                            shared=tuple(x[None] for x in shared), p0=p0))
    tshared = bridge.to_torch(tuple(np.asarray(x) for x in shared), device="cpu")
    got = tfd.flash_decode_int8(torch.from_numpy(q), t["k8"], t["ks"], t["v8"], t["vs"],
                                torch.from_numpy(lens), 12, 2, layer_idx=1, bs=8,
                                shared=tshared, p0=p0).numpy()
    np.testing.assert_allclose(got, ref, **TOL)


# --- the card kernels' launch plan and split-and-merge, on the CPU --------
#
# csrc/flash_decode.cu sums in another order than the plain version: the
# shared prefix in tiles, then the current row, then each split of a (head,
# lane)'s slots in CHUNK-row chunks per warp, the pieces merged in a fixed
# order; but every p (and so pv = bf16(p * vs)) is taken against the plain
# version's own running max (the prefix's max, then block by block of bs
# slots). The model below repeats that order in PyTorch; it agrees with the
# plain version to f32 rounding. Shapes: the report's decode (B=56, P0=48,
# S=384), the binary-QA pass (B=14, 427 of 448 prefix rows, S=128), the
# serving ring (B=16, S=384, per-lane intervals), the correction decode
# (B=1, no prefix, S=768: 12 blocks over 6 splits), the mock model (H=4,
# D=16). The data keep the heads few; the plans are the full widths' own.
ORDER_TOL = dict(atol=1e-5, rtol=1e-5)

PLAN_SHAPES = {"report": (56, 32, 128, 384, 64), "qa": (14, 32, 128, 128, 64),
               "ring": (16, 32, 128, 384, 64), "follow_up": (1, 32, 128, 448, 64),
               "correction": (1, 32, 128, 768, 64),
               "mock": (6, 4, 16, 128, 64), "odd_d": (3, 4, 12, 96, 32)}


@pytest.mark.parametrize("name", sorted(PLAN_SHAPES))
def test_plan_covers_every_block_once(name):
    b, h, d, s, bs = PLAN_SHAPES[name]
    plan = tfd._plan(b, h, d, s, bs)
    assert plan == tfd._plan.__wrapped__(b, h, d, s, bs)        # a function of the shapes
    nblk = s // bs
    owners = [i for i in range(plan.splits) for _ in range(i * plan.per,
                                                             min((i + 1) * plan.per, nblk))]
    assert owners == sorted(owners) and len(owners) == nblk      # every block once, in order
    assert set(owners) == set(range(plan.splits))                # no split without blocks
    assert 1 <= plan.splits <= tfd.MAX_SPLITS
    assert plan.tpr == 1 or plan.tpr * plan.vec // 2 < d <= plan.tpr * plan.vec
    assert plan.vec == (16 if d % 16 == 0 else 4)


@pytest.mark.parametrize("name", ["qa", "ring", "follow_up"])
def test_plan_fills_the_card(name):
    """Where B * H (heads x lanes) blocks leave the 132 SMs short, a (head,
    lane) is split until 8 blocks an SM are reached or every block of slots
    has its own split."""
    b, h, d, s, bs = PLAN_SHAPES[name]
    plan = tfd._plan(b, h, d, s, bs)
    blocks = b * h * plan.splits
    assert blocks >= tfd.SMS
    assert blocks >= min(tfd.SMS * tfd.BLOCKS_PER_SM, b * h * (s // bs))
    assert plan.splits > 1


def _merge(x, y):
    (m1, l1, a1), (m2, l2, a2) = x, y
    m = torch.maximum(m1, m2)
    s1, s2 = torch.exp(m1 - m), torch.exp(m2 - m)
    return m, l1 * s1 + l2 * s2, a1 * s1[..., None] + a2 * s2[..., None]


def _scores(q32, qs, scale, kb, ksb):
    """(B|1,R,H,D) int8 keys and (B|1,R,H) f32 scales: (B,R,H) f32 scores."""
    return (kb.to(torch.int64) * q32[:, None]).sum(-1).float() * ksb * qs[:, None, :] * scale


def _piece(p, pv, vb, m_row, valid):
    """The state of a set of rows, p and pv taken against each row's running
    max ``m_row``, rescaled to the largest: (m, l, acc)."""
    m = torch.where(valid, m_row, torch.full_like(m_row, tfd.NEG_INF)).amax(1)
    f = torch.where(valid, torch.exp(m_row - m[:, None]), torch.zeros_like(m_row))
    acc = torch.einsum("brh,brhd->bhd", pv * f, vb.float().expand(p.shape[0], -1, -1, -1))
    return m, (p * f).sum(1), acc


def split_merge_model(q8, qs, k8, ks, v8, vs, masks, li, scale, bs, plan, shared=None, p0=0,
                      current=None):
    """The card kernels' order of summation, in PyTorch: the prefix in the
    tiles of ``_prefix_plan``, each against the prefix's max, merged in tile
    order; the current row; the plan's splits, each the merge of its warps'
    states in warp order (rank 0 after the prefix and the current row),
    merged in split order; p against the plain version's running max."""
    b, h, d = q8.shape
    s_len = k8.shape[2]
    q32 = q8.to(torch.int64)

    def empty():
        return (torch.full((b, h), tfd.NEG_INF), torch.zeros(b, h), torch.zeros(b, h, d))

    start = empty()
    if shared is not None:
        k0, ks0, v0, vs0 = shared
        p0p = k0.shape[0]
        s0 = _scores(q32, qs, scale, k0.reshape(1, p0p, h, d), ks0[None, :, :h].float())
        valid0 = (torch.arange(p0p) < p0)[None, :, None].expand(b, -1, h)
        m0 = torch.where(valid0, s0, torch.full_like(s0, tfd.NEG_INF)).amax(1)
        p = torch.where(valid0, torch.exp(s0 - m0[:, None]), torch.zeros_like(s0))
        pv = (p * vs0[None, :, :h].float()).to(torch.bfloat16).float()
        tiles, sub = tfd._prefix_plan(min(p0, p0p))
        for t in range(tiles):
            rows = slice(t * sub * 64, min((t + 1) * sub * 64, p0p))
            start = _merge(start, _piece(p[:, rows], pv[:, rows], v0[rows].reshape(1, -1, h, d),
                                         m0[:, None].expand(-1, rows.stop - rows.start, -1),
                                         valid0[:, rows]))
    if current is not None:
        start = tfd._current_block(start, q32, qs, scale, current, h, d)
    lens, a1, b1, a2, b2 = masks
    pos = torch.arange(s_len)[None]
    valid = ((pos < lens[:, None]) | ((pos >= a1[:, None]) & (pos <= b1[:, None]))
             | ((pos >= a2[:, None]) & (pos <= b2[:, None])))[..., None].expand(-1, -1, h)
    k_l, v_l = k8[li].reshape(b, s_len, h, d), v8[li].reshape(b, s_len, h, d)
    s = _scores(q32, qs, scale, k_l, ks[li, ..., :h].float())
    s = torch.where(valid, s, torch.full_like(s, tfd.NEG_INF))
    m_run, m_blk = start[0], []                   # the plain version's running max
    for j in range(s_len // bs):
        m_run = torch.maximum(m_run, s[:, j * bs:(j + 1) * bs].amax(1))
        m_blk.append(m_run)
    m_row = torch.stack(m_blk, 1).repeat_interleave(bs, dim=1)
    p = torch.where(valid, torch.exp(s - m_row), torch.zeros_like(s))
    pv = (p * vs[li, ..., :h].float()).to(torch.bfloat16).float()
    final = None
    for i in range(plan.splits):
        r_lo, r_end = i * plan.per * bs, min((i + 1) * plan.per * bs, s_len)
        state = start if i == 0 else empty()
        for w in range(plan.warps):
            rows = torch.tensor([r for c in range(r_lo + w * plan.chunk, r_end,
                                                  plan.warps * plan.chunk)
                                 for r in range(c, min(c + plan.chunk, r_end))], dtype=torch.long)
            if len(rows):
                state = _merge(state, _piece(p[:, rows], pv[:, rows], v_l[:, rows], m_row[:, rows],
                                             valid[:, rows]))
        final = state if final is None else _merge(final, state)
    _, l, acc = final
    return acc * (1.0 / torch.clamp(l, min=1e-30))[..., None]


def _k2_data(seed, b, h, d, s, p0p=0):
    g = torch.Generator().manual_seed(seed)

    def i8(*shape):
        return torch.randint(-127, 128, shape, generator=g, dtype=torch.int8)

    def sc(*shape):
        return (torch.rand(shape, generator=g) * 0.01 + 0.002).to(torch.bfloat16)

    cache = (i8(1, b, s, h * d), sc(1, b, s, h), i8(1, b, s, h * d), sc(1, b, s, h))
    shared = (i8(p0p, h * d), sc(p0p, h), i8(p0p, h * d), sc(p0p, h)) if p0p else None
    q8, qs = tfd.quantize_q(torch.randn((b, h, d), generator=g) * 2)
    return q8, qs, cache, shared


def _ring_masks(b, p, ring):
    """Per-lane ring intervals: a window inside the ring, a wrapped window
    with a dead gap between the prompt and the ring, a full ring, a lane with
    no valid slot, a prompt that fills its region, the rest random."""
    g = torch.Generator().manual_seed(1)
    from radialog_tpu_torch.decode.continuous import ring_intervals
    lens = torch.randint(100, p + 1, (b,), generator=g, dtype=torch.int32)
    writes = torch.randint(1, ring - 7, (b,), generator=g, dtype=torch.int32)
    writes[0], writes[1], writes[2], lens[4] = 31, 100, ring, p
    lens[3], writes[3] = 0, 0
    a1, b1, a2, b2 = ring_intervals(writes, 70, p, ring)
    return (lens,) + tuple(x.to(torch.int32) for x in (a1, b1, a2, b2))


@pytest.mark.parametrize("case", ["report", "report_current", "qa", "ring", "correction",
                                  "mock"])
def test_split_merge_model_matches_plain(case):
    heads = 2                     # data heads; the plans below are the full widths'
    if case.startswith("report"):
        b, d, s, p0, p0p, t1, step = 56, 128, 384, 48, 48, 80, 150
        plan = tfd._plan(b, 32, d, s, 64)
    elif case == "qa":
        b, d, s, p0, p0p, t1, step = 14, 128, 128, 427, 448, 8, 9
        plan = tfd._plan(b, 32, d, s, 64)
    elif case == "ring":
        b, d, s, p0, p0p = 16, 128, 384, 0, 0
        plan = tfd._plan(b, 32, d, s, 64)
    elif case == "correction":    # one lane, no prefix, 12 blocks over 6 splits
        b, d, s, p0, p0p, t1, step = 1, 128, 768, 0, 0, 440, 255
        plan = tfd._plan(b, 32, d, s, 64)
        assert plan.splits == 6 and plan.per == 2
    else:
        b, d, s, p0, p0p, t1, step, heads = 6, 16, 128, 48, 48, 40, 30, 4
        plan = tfd._plan(b, heads, d, s, 64)
    q8, qs, cache, shared = _k2_data(len(case), b, heads, d, s, p0p)
    if case == "ring":
        masks = _ring_masks(b, 256, 128)
    else:
        lens = torch.full((b,), t1, dtype=torch.int32)
        lens[::3] = t1 - 7
        lens[1:2] = 0
        masks = tfd.slot_masks(lens, t1, step)
    current = None
    if case == "report_current":
        g = torch.Generator().manual_seed(5)
        current = (torch.randint(-127, 128, (b, 1, heads * d), generator=g, dtype=torch.int8),
                   torch.full((b, 1, heads), 0.006, dtype=torch.bfloat16),
                   torch.randint(-127, 128, (b, 1, heads * d), generator=g, dtype=torch.int8),
                   torch.full((b, 1, heads), 0.004, dtype=torch.bfloat16))
    args = (q8, qs, *cache, masks, 0, d ** -0.5, 64)
    kw = dict(shared=shared, p0=p0, current=current)
    want = tfd.flash_decode_int8_plain(*args, **kw)
    got = split_merge_model(*args, plan, **kw)
    assert plan.splits > 1 or case.startswith("report")
    assert torch.isfinite(got).all()
    if case == "ring":
        assert torch.equal(got[3], torch.zeros_like(got[3]))     # no valid slot: zeros
    torch.testing.assert_close(got, want, **TOL)
    torch.testing.assert_close(got, want, **ORDER_TOL)          # only the f32 order differs


def test_skipping_masked_blocks_is_exact():
    """A block of bs slots where no lane has a valid slot leaves the state
    as it was, so the plain version, which skips it, is bitwise the walk
    over every block (written out here): lanes whose windows wrapped around
    the ring (one dead gap of former sessions' rows between the prompt
    region and the ring, shared by all) and a lane with no valid slot."""
    b, h, d, s, bs = 4, 4, 16, 256, 32
    q8, qs, cache, _ = _k2_data(3, b, h, d, s)
    # prompt region [0, 64), ring [64, 256): each window wraps, ending at ring
    # position 40 and starting past 150, so slots [105, 214) are dead for all
    lens = torch.tensor([64, 30, 0, 50], dtype=torch.int32)
    a1 = torch.tensor([64, 64, 64, 64], dtype=torch.int32)
    b1 = torch.tensor([104, 100, -1, 90], dtype=torch.int32)
    a2 = torch.tensor([214, 230, 0, 250], dtype=torch.int32)
    b2 = torch.tensor([255, 255, -1, 255], dtype=torch.int32)
    b1[2] = -1                    # lane 2: no valid slot
    masks = (lens, a1, b1, a2, b2)
    pos = torch.arange(s)[None]
    valid = ((pos < lens[:, None]) | ((pos >= a1[:, None]) & (pos <= b1[:, None]))
             | ((pos >= a2[:, None]) & (pos <= b2[:, None])))
    dead = ~valid.reshape(b, s // bs, bs).any(dim=2).any(dim=0)
    assert dead[4:6].all() and not dead[-1]                   # a gap inside, not at the end
    k8, ks, v8, vs = cache
    q32 = q8.to(torch.int64)
    state = (torch.full((b, h), tfd.NEG_INF), torch.zeros(b, h), torch.zeros(b, h, d))
    for i in range(s // bs):                                  # every block, dead or not
        rows = slice(i * bs, (i + 1) * bs)
        state = tfd._block(state, q32, qs, d ** -0.5, k8[0, :, rows].reshape(b, bs, h, d),
                           ks[0, :, rows].float(), v8[0, :, rows].reshape(b, bs, h, d),
                           vs[0, :, rows].float(), valid[:, rows, None])
    walked = state[2] * (1.0 / torch.clamp(state[1], min=1e-30))[..., None]
    skipped = tfd.flash_decode_int8_plain(q8, qs, *cache, masks, 0, d ** -0.5, bs)
    assert torch.equal(walked, skipped)
    assert torch.equal(skipped[2], torch.zeros_like(skipped[2]))
