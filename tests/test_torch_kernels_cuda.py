"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Imports torch and the port only (no JAX), so it runs on a machine with a
GPU and no JAX: ``pytest -m cuda tests/test_torch_kernels_cuda.py``. Without
a card every test skips. K1 is held bitwise; K2 at atol=rtol=2e-3 (f32 sums
in another order, and pv rounds to bf16 where an ulp of p can flip it), in
the static-slot mode and with the ring's per-lane slot intervals, under
split plans (a (head, lane) over a cluster of up to 8 blocks), over shared
prefixes of 1 to 2000 rows, at D of 4 to 128, each run twice and bitwise
equal; K4 bitwise
(each group's integer sum is exact and the kernel adds the groups in the
plain version's order with single rounded f32 operations, also where K
splits: the last block of a tile adds the splits' group terms in order) and
bitwise against its own second run, under every plan; K2'' (the
current row attended and written in place) at K2's tolerance with its row
bitwise and every other byte of the cache unchanged; T1 bitwise equal to K2
on the same data; T2 and T3 bitwise (exact int32 sums) at every plan's
boundaries, and repeatable where K splits; K5a and K5b (the
flash-attention backward) each of dq, dk and dv at 8e-3 of its own largest
reference value in bf16 (one bf16 step of that value at most; the spread of
the plain version between block sizes reaches a quarter of it: a gradient
rounds to bf16 once, and ds and p round before the second product) and 1e-5
in f32, and bitwise against their own second run. Beside the kernels: the
optimizer (train/optim.py) and ops/w4_colscale.py pack_q4c on the card
bitwise the CPU (the optimizer with the clip within CLIP_TOL)."""
import dataclasses

import pytest
import torch

from radialog_tpu_torch.ops import flash_attention as tfa
from radialog_tpu_torch.ops import flash_decode as tfd
from radialog_tpu_torch.ops import q4_matmul as tq4
from radialog_tpu_torch.ops import q8_matmul as tq8
from radialog_tpu_torch.ops import w4_colscale as tw

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    return torch.device("cuda")


VICUNA_KN = [(4096, 12288), (4096, 4096), (4096, 22016), (11008, 4096), (4096, 32001)]


# more than one K stage and more than one N tile catch a wgmma descriptor
# that disagrees with TMA's swizzle; (7, 48, 9) has K below one 128-byte box
@pytest.mark.parametrize("m,k,n", [(1, 4096, 4096), (56, 11008, 4096), (56, 4096, 32001),
                                   (130, 4096, 12288), (7, 48, 9), (16, 4096, 22016),
                                   (16, 4096, 32001), (256, 11008, 4096)]
                         + [(4480, k, n) for k, n in VICUNA_KN]
                         + [(m, 4096, 4096) for m in (1, 16, 64, 65, 128)]
                         + [(m, 11008, 4096) for m in (1, 16, 64, 65, 128)]
                         # the eval's batch-1 decode and its correction prefills
                         # (440 and 448 rows: a partial last 64-row tile)
                         + [(1, k, n) for k, n in VICUNA_KN[2:]]
                         + [(m, k, n) for m in (440, 448) for k, n in VICUNA_KN]
                         # speculative verify blocks: batch 1 at k = 4 and 5,
                         # 8 compact lanes x (5 + 1)
                         + [(m, k, n) for m in (5, 6, 48) for k, n in VICUNA_KN])
def test_q8_kernel_matches_plain(card, m, k, n):
    g = torch.Generator(device=card).manual_seed(m + n)
    x8 = torch.randint(-127, 128, (m, k), generator=g, device=card, dtype=torch.int8)
    w8 = torch.randint(-127, 128, (n, k), generator=g, device=card, dtype=torch.int8)
    before = tq8.q8_matmul_int32.launches
    got = tq8.q8_matmul_int32(x8, w8)
    torch.cuda.synchronize()
    assert tq8.q8_matmul_int32.launches == before + 1
    assert torch.equal(got, tq8.q8_matmul_int32_plain(x8, w8))


def test_q8_kernel_refuses_ragged_k(card):
    x8 = torch.zeros((2, 40), dtype=torch.int8, device=card)
    with pytest.raises(ValueError):
        tq8.q8_matmul_int32(x8, torch.zeros((3, 40), dtype=torch.int8, device=card)[:, :36])


@pytest.mark.parametrize("step,shared,hb,db", [(0, True, 32, 128), (150, True, 32, 128),
                                               (299, False, 32, 128), (5, True, 4, 16)])
def test_flash_decode_kernel_matches_plain(card, step, shared, hb, db):
    g = torch.Generator(device=card).manual_seed(step)
    lb, sb, layers = 8, 384, 3
    k8 = torch.randint(-127, 128, (layers, lb, sb, hb * db), generator=g, device=card,
                       dtype=torch.int8)
    v8 = torch.randint(-127, 128, k8.shape, generator=g, device=card, dtype=torch.int8)
    ks = (torch.rand((layers, lb, sb, hb), generator=g, device=card) / 50).to(torch.bfloat16)
    vs = (torch.rand((layers, lb, sb, hb), generator=g, device=card) / 50).to(torch.bfloat16)
    pre = ((k8[0, 0, :64].contiguous(), ks[0, 0, :64].contiguous(),
            v8[0, 0, :64].contiguous(), vs[0, 0, :64].contiguous()) if shared else None)
    q = torch.randn((lb, hb, db), generator=g, device=card)
    lens = torch.randint(0, 80, (lb,), generator=g, device=card, dtype=torch.int32)
    q8, qs = tfd.quantize_q(q)
    args = (q8, qs, k8, ks, v8, vs, tfd.slot_masks(lens, 80, step), 1, db ** -0.5, 64)
    got = _k2_twice(lambda: tfd.flash_decode_int8_kernel(*args, shared=pre, p0=48))
    ref = tfd.flash_decode_int8_plain(*args, shared=pre, p0=48)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, ref, atol=2e-3, rtol=2e-3)


@pytest.mark.parametrize("p0", [700, 2047])
def test_flash_decode_kernel_long_shared_prefix(card, p0):
    """A prefix longer than one shared-memory chunk (512 rows) is walked in
    chunks; the plain version keeps it as one block."""
    g = torch.Generator(device=card).manual_seed(p0)
    lb, sb, h, d = 4, 128, 32, 128
    p0p = -(-p0 // 32) * 32
    k8 = torch.randint(-127, 128, (2, lb, sb, h * d), generator=g, device=card, dtype=torch.int8)
    v8 = torch.randint(-127, 128, k8.shape, generator=g, device=card, dtype=torch.int8)
    ks = (torch.rand((2, lb, sb, h), generator=g, device=card) / 50).to(torch.bfloat16)
    vs = (torch.rand((2, lb, sb, h), generator=g, device=card) / 50).to(torch.bfloat16)
    pre = (torch.randint(-127, 128, (p0p, h * d), generator=g, device=card, dtype=torch.int8),
           (torch.rand((p0p, h), generator=g, device=card) / 50).to(torch.bfloat16),
           torch.randint(-127, 128, (p0p, h * d), generator=g, device=card, dtype=torch.int8),
           (torch.rand((p0p, h), generator=g, device=card) / 50).to(torch.bfloat16))
    q8, qs = tfd.quantize_q(torch.randn((lb, h, d), generator=g, device=card))
    lens = torch.tensor([5, 0, 17, 9], dtype=torch.int32, device=card)
    args = (q8, qs, k8, ks, v8, vs, tfd.slot_masks(lens, 20, 3), 1, d ** -0.5, 64)
    got = _k2_twice(lambda: tfd.flash_decode_int8_kernel(*args, shared=pre, p0=p0))
    ref = tfd.flash_decode_int8_plain(*args, shared=pre, p0=p0)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, ref, atol=2e-3, rtol=2e-3)


def _k2_twice(fn):
    """fn() run twice: the second run must equal the first bit for bit."""
    first = fn()
    again = fn()
    torch.cuda.synchronize()
    assert torch.equal(first, again)
    return first


@pytest.mark.parametrize("step", [0, 128, 255])
def test_flash_decode_kernel_correction_decode(card, step):
    """The eval's batch-1 correction decode at full width: one lane, no
    prefix, a 437-token prompt padded to 440 slots in a 768-slot cache, so
    32 heads on 132 SMs split each (head, lane) over 6 blocks of 2 blocks of
    64 slots in one cluster."""
    g = torch.Generator(device=card).manual_seed(step)
    k8, ks, v8, vs = _int8_cache(g, card, 2, 1, 768, 32, 128)
    assert tfd._plan(1, 32, 128, 768, tfd.default_bs(768)).splits == 6
    q8, qs = tfd.quantize_q(torch.randn((1, 32, 128), generator=g, device=card) * 2)
    lens = torch.full((1,), 437, dtype=torch.int32, device=card)
    args = (q8, qs, k8, ks, v8, vs, tfd.slot_masks(lens, 440, step), 1, 128 ** -0.5,
            tfd.default_bs(768))
    got = _k2_twice(lambda: tfd.flash_decode_int8_kernel(*args))
    ref = tfd.flash_decode_int8_plain(*args)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, ref, atol=2e-3, rtol=2e-3)


# (lanes, heads, head dim, slots, shared prefix rows): split plans at small
# B x H with long lanes (up to 8 blocks a (head, lane), one cluster); prefixes
# of 1, 64, 427 and 2000 rows (1 to 32 prefix tiles); D = 16 (the mock's), and
# the 4-byte route's D = 12 and D = 4; D = 96 (threads of a row group idle)
@pytest.mark.parametrize("b,h,d,s,p0", [(2, 4, 128, 512, 0), (3, 8, 128, 384, 1),
                                        (3, 8, 128, 384, 64), (14, 32, 128, 128, 427),
                                        (2, 4, 128, 256, 2000), (5, 4, 16, 128, 48),
                                        (3, 4, 12, 96, 20), (2, 2, 4, 64, 0),
                                        (4, 8, 96, 256, 70)])
def test_flash_decode_kernel_plans(card, b, h, d, s, p0):
    g = torch.Generator(device=card).manual_seed(b * s + p0)
    k8, ks, v8, vs = _int8_cache(g, card, 2, b, s, h, d)
    p0p = -(-p0 // 32) * 32
    pre = ((torch.randint(-127, 128, (p0p, h * d), generator=g, device=card, dtype=torch.int8),
            (torch.rand((p0p, h), generator=g, device=card) / 50).to(torch.bfloat16),
            torch.randint(-127, 128, (p0p, h * d), generator=g, device=card, dtype=torch.int8),
            (torch.rand((p0p, h), generator=g, device=card) / 50).to(torch.bfloat16))
           if p0 else None)
    q8, qs = tfd.quantize_q(torch.randn((b, h, d), generator=g, device=card) * 2)
    lens = torch.randint(s // 2, s - 1, (b,), generator=g, device=card, dtype=torch.int32)
    lens[-1] = 0                                  # the last lane: its prefix only, or nothing
    a1 = torch.full((b,), s - 1, dtype=torch.int32, device=card)
    b1 = torch.where(lens > 0, a1, -1).to(torch.int32)
    masks = (lens, a1, b1, torch.zeros_like(lens), torch.full_like(lens, -1))
    args = (q8, qs, k8, ks, v8, vs, masks, 1, d ** -0.5, tfd.default_bs(s))
    got = _k2_twice(lambda: tfd.flash_decode_int8_kernel(*args, shared=pre, p0=p0))
    ref = tfd.flash_decode_int8_plain(*args, shared=pre, p0=p0)
    assert torch.isfinite(got).all()
    if not p0:
        assert torch.equal(got[-1], torch.zeros_like(got[-1]))   # no valid slot: zeros
    torch.testing.assert_close(got, ref, atol=2e-3, rtol=2e-3)


def test_flash_decode_current_kernel_under_a_split_plan(card):
    """K2'' where a (head, lane) is a cluster of 8 blocks: the written row
    bitwise, every other byte unchanged, the output within K2's tolerance of
    the plain version and bitwise repeatable."""
    b, h, d, s, li, pp, step = 2, 4, 128, 512, 1, 200, 250
    g = torch.Generator(device=card).manual_seed(11)
    cache = _int8_cache(g, card, 3, b, s, h, d)
    assert tfd._plan(b, h, d, s, tfd.default_bs(s)).splits == 8
    slot = pp + step
    cur = [x[li, :, slot:slot + 1].clone() for x in cache]
    for x in cache:
        x[:, :, slot] = 0
    before = [x.clone() for x in cache]
    q8, qs = tfd.quantize_q(torch.randn((b, h, d), generator=g, device=card))
    lens = torch.tensor([pp, 37], dtype=torch.int32, device=card)
    args = (q8, qs, *cache, tfd.slot_masks(lens, pp, step - 1), li, d ** -0.5,
            tfd.default_bs(s))
    kw = dict(current=cur, write_cache=True)
    got = _k2_twice(lambda: tfd.flash_decode_int8_current_kernel(*args, **kw))
    for x, old, c in zip(cache, before, cur):
        assert torch.equal(x[li, :, slot], c[:, 0])
        old[li, :, slot] = c[:, 0]
        assert torch.equal(x, old)
    for x, old in zip(cache, before):
        x[li, :, slot] = 0
    ref = tfd.flash_decode_int8_plain(*args, **kw)
    torch.testing.assert_close(got, ref, atol=2e-3, rtol=2e-3)


def test_flash_decode_kernel_takes_unaligned_views(card):
    """A cache whose rows are not 16-byte aligned (a view at an odd offset)
    goes the 4-byte route (its own order of sums), within K2's tolerance of
    the plain version and of the 16-byte route on the same values."""
    g = torch.Generator(device=card).manual_seed(2)
    b, h, d, s = 3, 4, 128, 128
    k8, ks, v8, vs = _int8_cache(g, card, 1, b, s, h, d)
    raw = torch.empty(k8.numel() + 4, dtype=torch.int8, device=card)
    k_odd = raw[4:].view(k8.shape)
    k_odd.copy_(k8)
    assert k_odd.data_ptr() % 16
    q8, qs = tfd.quantize_q(torch.randn((b, h, d), generator=g, device=card))
    lens = torch.tensor([100, 7, 128], dtype=torch.int32, device=card)
    masks = tfd.slot_masks(lens, 0, -1)
    aligned = tfd.flash_decode_int8_kernel(q8, qs, k8, ks, v8, vs, masks, 0, d ** -0.5, 64)
    odd = _k2_twice(lambda: tfd.flash_decode_int8_kernel(q8, qs, k_odd, ks, v8, vs, masks, 0,
                                                         d ** -0.5, 64))
    ref = tfd.flash_decode_int8_plain(q8, qs, k8, ks, v8, vs, masks, 0, d ** -0.5, 64)
    torch.testing.assert_close(odd, ref, atol=2e-3, rtol=2e-3)
    torch.testing.assert_close(odd, aligned, atol=2e-3, rtol=2e-3)


K3_TOL = {torch.bfloat16: dict(atol=1e-2, rtol=1e-2), torch.float32: dict(atol=1e-5, rtol=1e-5)}


@pytest.mark.parametrize("b,t,h,d,dtype,causal,ragged", [
    (1, 256, 32, 128, torch.bfloat16, True, False),
    (1, 431, 32, 128, torch.bfloat16, True, False),
    (1, 433, 32, 128, torch.bfloat16, True, False),
    (1, 436, 32, 128, torch.bfloat16, True, False),
    (1, 440, 32, 128, torch.bfloat16, True, [437]),           # the eval's correction prefills
    (1, 448, 32, 128, torch.bfloat16, True, [442]),
    (1, 448, 32, 128, torch.bfloat16, True, [445]),
    (12, 448, 32, 128, torch.bfloat16, True, True),
    (2, 300, 4, 16, torch.float32, True, True),
    (2, 300, 4, 128, torch.float32, False, True),
    (3, 200, 8, 64, torch.bfloat16, False, True),
    (2, 600, 32, 128, torch.bfloat16, True, [600, 413]),     # the train phase's shape
    (2, 70, 2, 64, torch.bfloat16, True, [70, 33]),           # one query tile, T < TQ
    (1, 129, 4, 128, torch.bfloat16, True, False),            # one row past a tile
])
def test_flash_attention_kernel_matches_plain(card, b, t, h, d, dtype, causal, ragged):
    g = torch.Generator(device=card).manual_seed(t + b)
    # q, k, v as strided views of one fused projection, as the model has them
    qkv = torch.randn((b, t, 3, h, d), generator=g, device=card).to(dtype)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    lens = torch.full((b,), t, dtype=torch.int32, device=card)
    if isinstance(ragged, list):
        lens = torch.tensor(ragged, dtype=torch.int32, device=card)
    elif ragged:
        lens = torch.randint(t * 2 // 3, t + 1, (b,), generator=g, device=card,
                             dtype=torch.int32)
    before = tfa.flash_attention_kernel.launches
    got, lse = tfa.flash_attention_kernel(q, k, v, lens, causal=causal, with_lse=True)
    ref, ref_lse = tfa.flash_attention_plain(q, k, v, lens, causal=causal, with_lse=True)
    torch.cuda.synchronize()
    assert tfa.flash_attention_kernel.launches == before + 1
    assert got.dtype == dtype and torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), ref.float(), **K3_TOL[dtype])
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=1e-5)


def test_flash_attention_kernel_dead_lane(card):
    """A lane of length 0 emits zeros and lse = LSE_DEAD."""
    q = torch.randn((2, 70, 2, 32), device=card, dtype=torch.bfloat16)
    lens = torch.tensor([0, 33], dtype=torch.int32, device=card)
    out, lse = tfa.flash_attention_kernel(q, q, q, lens, with_lse=True)
    torch.cuda.synchronize()
    assert torch.equal(out[0], torch.zeros_like(out[0]))
    assert bool((lse[0] == tfa.LSE_DEAD).all()) and bool(torch.isfinite(out[1].float()).all())


def test_flash_attention_tma_kernel_dead_lane(card):
    """The TMA kernel (D = 128) on a lane of length 0: no key tile is
    loaded, zeros and lse = LSE_DEAD; the live lane matches the plain
    version."""
    g = torch.Generator(device=card).manual_seed(7)
    q, k, v = (torch.randn((2, 200, 2, 128), generator=g, device=card).to(torch.bfloat16)
               for _ in range(3))
    lens = torch.tensor([0, 150], dtype=torch.int32, device=card)
    out, lse = tfa.flash_attention_kernel(q, k, v, lens, with_lse=True)
    ref = tfa.flash_attention_plain(q, k, v, lens)
    torch.cuda.synchronize()
    assert torch.equal(out[0], torch.zeros_like(out[0]))
    assert bool((lse[0] == tfa.LSE_DEAD).all())
    torch.testing.assert_close(out.float(), ref.float(), **K3_TOL[torch.bfloat16])


K5_CASES = [
    # b, t, h, d, dtype, causal, lengths (None: full), fused views, keys (None: t)
    (2, 600, 32, 128, torch.bfloat16, True, [600, 413], False, None),   # the training shape
    (2, 600, 32, 128, torch.bfloat16, True, [600, 413], True, None),    # the same through views
    (1, 256, 32, 128, torch.bfloat16, True, None, False, None),
    (2, 300, 32, 128, torch.bfloat16, True, [0, 300], True, None),      # a dead lane beside a live one
    (2, 200, 8, 64, torch.bfloat16, False, [200, 77], True, None),      # non-causal, length mask
    (3, 130, 4, 32, torch.bfloat16, True, [130, 64, 1], False, None),
    (2, 300, 4, 16, torch.float32, True, [300, 211], True, None),       # the mock's shape
    (2, 100, 2, 128, torch.float32, False, [100, 33], False, None),
    (2, 70, 2, 64, torch.float32, True, [0, 70], True, None),
    # the TMA route's tile boundaries: a 64-row stage, 64- and 128-row blocks,
    # one row past either; T % 4 != 0 (lse and delta rows not 16-byte aligned)
    (1, 1, 4, 128, torch.bfloat16, False, [64], False, 64),             # one query, 64 keys
    (2, 1, 4, 64, torch.bfloat16, False, [129, 50], True, 129),
    (2, 63, 4, 128, torch.bfloat16, True, [63, 40], True, None),
    (2, 63, 4, 64, torch.bfloat16, False, [63, 40], False, None),
    (2, 65, 4, 128, torch.bfloat16, True, [65, 33], False, None),
    (2, 65, 4, 64, torch.bfloat16, False, [65, 33], True, None),
    (2, 127, 4, 64, torch.bfloat16, True, [127, 64], True, None),
    (2, 127, 4, 128, torch.bfloat16, False, [127, 64], False, None),
    (2, 129, 4, 128, torch.bfloat16, True, [129, 0], True, None),
    (2, 129, 4, 64, torch.bfloat16, False, [129, 128], False, None),
    (1, 431, 32, 128, torch.bfloat16, True, None, True, None),          # the qa prefix length
    (2, 600, 32, 64, torch.bfloat16, True, [600, 413], False, None),    # D = 64 at the train shape
    (2, 300, 4, 16, torch.bfloat16, True, [300, 211], True, None),      # the mma.sync route
]


def k5_inputs(card, b, t, h, d, dtype, lens, fused, seed, s=None):
    s = s or t
    g = torch.Generator(device=card).manual_seed(seed)
    if fused and s == t:   # q, k, v as strided views of one fused projection
        qkv = torch.randn((b, t, 3, h, d), generator=g, device=card).to(dtype)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    elif fused:            # k and v as views of one fused projection of S rows
        q = torch.randn((b, t, h, d), generator=g, device=card).to(dtype)
        kv = torch.randn((b, s, 2, h, d), generator=g, device=card).to(dtype)
        k, v = kv[:, :, 0], kv[:, :, 1]
    else:
        q = torch.randn((b, t, h, d), generator=g, device=card).to(dtype)
        k, v = (torch.randn((b, s, h, d), generator=g, device=card).to(dtype)
                for _ in range(2))
    do = torch.randn((b, t, h, d), generator=g, device=card).to(dtype)
    lengths = torch.tensor(lens if lens is not None else [s] * b, dtype=torch.int32,
                           device=card)
    return q, k, v, do, lengths


def assert_k5_close(dtype, lengths, got, want):
    """dq, dk, dv each within K5_TOL of its own largest reference value, in
    the input dtype, dense, finite, and zero past each lane's length (dk,
    dv) or in a dead lane (all three)."""
    rel = 8e-3 if dtype == torch.bfloat16 else 1e-5
    for name, g, r in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == dtype and g.shape == r.shape and g.is_contiguous()
        assert torch.isfinite(g.float()).all(), name
        err = float((g.float() - r.float()).abs().max())
        assert err <= rel * float(r.float().abs().max()), (name, err)
    dq, dk, dv = got
    for i, n in enumerate(lengths.tolist()):
        assert not dk[i, n:].any() and not dv[i, n:].any()       # rows past the length
        if n == 0:
            assert not dq[i].any()                                # a dead lane


@pytest.mark.parametrize("b,t,h,d,dtype,causal,lens,fused,s", K5_CASES)
def test_flash_attention_backward_kernels_match_plain(card, b, t, h, d, dtype, causal, lens,
                                                      fused, s):
    q, k, v, do, lengths = k5_inputs(card, b, t, h, d, dtype, lens, fused, seed=t + d, s=s)
    out, lse = tfa.flash_attention_plain(q, k, v, lengths, causal=causal, with_lse=True)
    delta = tfa._delta(out, do)
    args = (q, k, v, lengths, lse, delta, do, causal, None)
    before = (tfa.flash_attention_dq_kernel.launches, tfa.flash_attention_dkv_kernel.launches)
    dq = tfa.flash_attention_dq_kernel(*args)
    dk, dv = tfa.flash_attention_dkv_kernel(*args)
    torch.cuda.synchronize()
    assert (tfa.flash_attention_dq_kernel.launches,
            tfa.flash_attention_dkv_kernel.launches) == (before[0] + 1, before[1] + 1)
    ref = (tfa.flash_attention_dq_plain(*args), *tfa.flash_attention_dkv_plain(*args))
    assert_k5_close(dtype, lengths, (dq, dk, dv), ref)
    # no float atomics: a second run repeats the first bit for bit
    assert torch.equal(dq, tfa.flash_attention_dq_kernel(*args))
    dk2, dv2 = tfa.flash_attention_dkv_kernel(*args)
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)


@pytest.mark.parametrize("b,t,h,d,causal,lens,s", [
    (2, 600, 32, 128, True, [600, 413], None),
    (2, 129, 4, 64, True, [129, 0], None),
    (2, 63, 4, 128, False, [63, 40], None),
    (1, 1, 4, 128, False, [64], 64),
    (1, 431, 8, 128, True, None, None)])
def test_flash_attention_whole_backward_folds_delta(card, b, t, h, d, causal, lens, s):
    """On the TMA route K5a computes delta = rowsum(do * out) itself: the
    whole backward launches K5a and K5b once each and matches the plain
    backward within K5_TOL, repeatably; delta matches the PyTorch reduction
    up to the order of its f32 sum (rtol 1e-5 of a sum of D products)."""
    q, k, v, do, lengths = k5_inputs(card, b, t, h, d, torch.bfloat16, lens, True, seed=t, s=s)
    out, lse = tfa.flash_attention_plain(q, k, v, lengths, causal=causal, with_lse=True)
    assert tfa._bwd_route(q.dtype, d) == "tma"
    before = (tfa.flash_attention_dq_kernel.launches, tfa.flash_attention_dkv_kernel.launches)
    got = tfa.flash_attention_bwd_kernel(q, k, v, lengths, out, lse, do, causal)
    dq, delta = tfa.flash_attention_dq_delta_kernel(q, k, v, lengths, lse, out, do, causal)
    torch.cuda.synchronize()
    assert (tfa.flash_attention_dq_kernel.launches,
            tfa.flash_attention_dkv_kernel.launches) == (before[0] + 2, before[1] + 1)
    want_dq, want_delta = tfa.flash_attention_dq_delta_plain(q, k, v, lengths, lse, out, do,
                                                             causal)
    torch.testing.assert_close(delta, want_delta, rtol=1e-5,
                               atol=1e-5 * float(want_delta.abs().max()))
    assert torch.equal(dq, got[0])
    ref = tfa.flash_attention_bwd_plain(q, k, v, lengths, out, lse, do, causal)
    assert_k5_close(torch.bfloat16, lengths, got, ref)
    again = tfa.flash_attention_bwd_kernel(q, k, v, lengths, out, lse, do, causal)
    assert all(torch.equal(x, y) for x, y in zip(got, again))


def test_flash_attention_tma_backward_raises_rather_than_falls_back(card, monkeypatch):
    """A tensor the TMA route cannot take (rows 2 bytes past a 16-byte
    multiple, let through by a wrapper told every layout is fine) makes the
    launch raise: the C side refuses the tensor map and runs no other
    kernel."""
    b, t, h, d = 1, 64, 2, 128
    wide = torch.randn((b, t, h * d + 1), device=card).to(torch.bfloat16)
    q = wide[..., :h * d].unflatten(-1, (h, d))
    lengths = torch.tensor([t], dtype=torch.int32, device=card)
    stat = torch.zeros((b, h, t), device=card)
    monkeypatch.setattr(tfa, "_tma_ok", lambda x: True)
    for launch in (tfa.flash_attention_dq_kernel, tfa.flash_attention_dkv_kernel):
        with pytest.raises(RuntimeError, match="cuTensorMapEncodeTiled"):
            launch(q, q, q, lengths, stat, stat, q)


def test_flash_attention_autograd_runs_the_kernels(card):
    """Autograd through ``flash_attention`` on the card launches K3, K5a and
    K5b once each and agrees with the plain backward."""
    q, k, v, do, lengths = k5_inputs(card, 2, 300, 4, 16, torch.float32, [300, 250], True, 3)
    qkv = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
    counted = (tfa.flash_attention_kernel, tfa.flash_attention_dq_kernel,
               tfa.flash_attention_dkv_kernel)
    before = [f.launches for f in counted]
    out = tfa.flash_attention(*qkv, lengths)
    grads = torch.autograd.grad(out, qkv, do)
    torch.cuda.synchronize()
    assert [f.launches for f in counted] == [n + 1 for n in before]
    ref_out, lse = tfa.flash_attention_plain(q, k, v, lengths, with_lse=True)
    ref = tfa.flash_attention_bwd_plain(q, k, v, lengths, ref_out, lse, do)
    for got, want in zip(grads, ref):
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


def test_flash_attention_autograd_tma_route_with_a_summed_loss(card):
    """bf16 at D = 128 through autograd with the gradient of a sum (a
    broadcast do, strides 0): the TMA route makes it dense and agrees with
    the plain backward."""
    q, k, v, _, lengths = k5_inputs(card, 2, 130, 4, 128, torch.bfloat16, [130, 77], True, 5)
    qkv = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
    grads = torch.autograd.grad(tfa.flash_attention(*qkv, lengths).float().sum(), qkv)
    ref_out, lse = tfa.flash_attention_plain(q, k, v, lengths, with_lse=True)
    ones = torch.ones_like(q)
    ref = tfa.flash_attention_bwd_plain(q, k, v, lengths, ref_out, lse, ones)
    torch.cuda.synchronize()
    assert_k5_close(torch.bfloat16, lengths, grads, ref)


def test_flash_attention_backward_refuses_what_it_does_not_take(card):
    q = torch.zeros((1, 8, 2, 48), device=card)
    lens = torch.tensor([8], dtype=torch.int32, device=card)
    stat = torch.zeros((1, 2, 8), device=card)
    with pytest.raises(ValueError, match="head_dim"):
        tfa.flash_attention_dq_kernel(q, q, q, lens, stat, stat, q)
    q = torch.zeros((1, 8, 2, 16), device=card)
    with pytest.raises(ValueError, match="shapes"):
        tfa.flash_attention_dkv_kernel(q, q, q, lens, stat[:, :, :4], stat, q)
    with pytest.raises(ValueError, match="one dtype"):
        tfa.flash_attention_dq_kernel(q, q, q.bfloat16(), lens, stat, stat, q)
    with pytest.raises(ValueError, match="TMA route"):     # delta is folded only there
        tfa.flash_attention_dq_delta_kernel(q, q, q, lens, stat, q, q)


def ring_interval_cases(p, ring, device):
    """Per-lane (lens, a1, b1, a2, b2) of a ring cache with prompt region
    [0, p) and ring [p, p + ring): a window inside the ring, a wrapped window
    (both intervals live), a full ring, a lane with no valid slot, a lane
    whose prompt fills the prompt region, and a fresh lane with one slot."""
    rows = [(100, p + 10, p + 40, 0, -1),
            (180, p, p + 5, p + ring - 20, p + ring - 1),
            (150, p, p + ring - 1, 0, -1),
            (0, p + 7, -1, 0, -1),
            (p, p + 3, p + 60, 0, -1),
            (37, p + 90, p + 90, 0, -1)]
    cols = list(zip(*rows))
    return [torch.tensor(c, dtype=torch.int32, device=device) for c in cols]


@pytest.mark.parametrize("hb,db,layers", [(32, 128, 3), (4, 16, 2)])
def test_flash_decode_kernel_ring_intervals(card, hb, db, layers):
    p, ring = 256, 128
    g = torch.Generator(device=card).manual_seed(hb)
    lens, a1, b1, a2, b2 = ring_interval_cases(p, ring, card)
    lb, sb = lens.shape[0], p + ring
    k8 = torch.randint(-127, 128, (layers, lb, sb, hb * db), generator=g, device=card,
                       dtype=torch.int8)
    v8 = torch.randint(-127, 128, k8.shape, generator=g, device=card, dtype=torch.int8)
    ks = (torch.rand((layers, lb, sb, hb), generator=g, device=card) / 50).to(torch.bfloat16)
    vs = (torch.rand((layers, lb, sb, hb), generator=g, device=card) / 50).to(torch.bfloat16)
    q = torch.randn((lb, hb, db), generator=g, device=card)
    q8, qs = tfd.quantize_q(q)
    masks = tfd.slot_masks(lens, gen_intervals=(a1, b1, a2, b2))
    args = (q8, qs, k8, ks, v8, vs, masks, layers - 1, db ** -0.5, tfd.default_bs(sb))
    got = _k2_twice(lambda: tfd.flash_decode_int8_kernel(*args))
    ref = tfd.flash_decode_int8_plain(*args)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert torch.equal(got[3], torch.zeros_like(got[3]))       # no valid slot: zeros
    torch.testing.assert_close(got, ref, atol=2e-3, rtol=2e-3)
    # the wrapper with gen_intervals goes the same way
    out = tfd.flash_decode_int8(q, k8, ks, v8, vs, lens, layer_idx=layers - 1,
                                gen_intervals=(a1, b1, a2, b2))
    torch.testing.assert_close(out, ref, atol=2e-3, rtol=2e-3)


def _q4_operands(card, m, k, n, group, mode, seed):
    g = torch.Generator(device=card).manual_seed(seed)
    groups = -(-k // tq4.pick_bk(k)) * tq4.pick_bk(k) // group
    x8 = torch.randint(-127, 128, (m, k), generator=g, device=card, dtype=torch.int8)
    w = torch.randint(-128, 128, (n, k // 2), generator=g, device=card, dtype=torch.int8)
    gscale = torch.rand((groups, n), generator=g, device=card) * 1e-3 + 1e-4
    goff = (torch.rand((groups, n), generator=g, device=card) - 0.5) * 1e-3 \
        if mode == "asym" else None
    return x8, w, gscale, goff


Q4_VICUNA = [(4096, 12288), (4096, 4096), (4096, 22016), (11008, 4096)]


# the four Vicuna-7B shapes at every wn boundary and a row tiling past 64
# (wo and down split K at M <= 64), the mock's shapes (K = 64 and 128, one
# group of 128; 640, one of 640), a ragged K of five groups of 512 and N of 40
@pytest.mark.parametrize("mode", ["asym", "sym"])
@pytest.mark.parametrize("m,k,n,group", [
    (m, k, n, 512) for m in (1, 5, 16, 56, 64, 65, 256) for k, n in Q4_VICUNA] + [
    (70, 640, 72, 640), (33, 64, 192, 128), (5, 128, 64, 128), (3, 64, 256, 128),
    (19, 2560, 40, 512)])
def test_q4_kernel_matches_plain(card, m, k, n, group, mode):
    x8, w, gscale, goff = _q4_operands(card, m, k, n, group, mode, m + n)
    before = tq4.q4_matmul_acc.launches
    got = tq4.q4_matmul_acc(x8, w, gscale, goff, group)
    again = tq4.q4_matmul_acc(x8, w, gscale, goff, group)
    ref = tq4.q4_matmul_acc_plain(x8, w, gscale, goff, group)
    torch.cuda.synchronize()
    assert tq4.q4_matmul_acc.launches == before + 2
    assert torch.equal(got, ref), float((got - ref).abs().max())
    assert torch.equal(again, got)


# each plan beside the same call unsplit, split as finely as the groups
# allow (groups of 128 end mid-stage; 2 stages a group of 512), and with 64
# and with 128 weight rows a block
@pytest.mark.parametrize("m,k,n,group", [(16, 11008, 4096, 512), (5, 4096, 4096, 512),
                                         (56, 4096, 12288, 512), (16, 1184, 200, 128),
                                         (9, 1056, 64, 128), (3, 640, 72, 640),
                                         (256, 4096, 4096, 512), (17, 2560, 130, 512)])
@pytest.mark.parametrize("mode", ["asym", "sym"])
def test_q4_kernel_plans_match_plain(card, m, k, n, group, mode):
    x8, w, gscale, goff = _q4_operands(card, m, k, n, group, mode, k + n)
    ref = tq4.q4_matmul_acc_plain(x8, w, gscale, goff, group)
    ktiles, unit = -(-k // tq4.KTILE), tq4.group_stages(group)
    plan = tq4._plan(m, n, k, group, mode == "asym")
    plans = [plan, dataclasses.replace(plan, splits=1, per=ktiles),
             tq4._plan(m, n, k, group, mode == "asym", rows=64)]
    if plan.wn <= 32:
        plans.append(tq4._plan(m, n, k, group, mode == "asym", rows=128))
    finest = dataclasses.replace(plan, splits=-(-ktiles // unit), per=unit)
    if finest.tiles(m, n) <= tq4.TICKETS:
        plans.append(finest)
    for p in plans:
        n0 = tq4.q4_matmul_acc.launches
        first = tq4._launch(x8, w, gscale, goff, group, p)
        second = tq4._launch(x8, w, gscale, goff, group, p)
        torch.cuda.synchronize()
        assert tq4.q4_matmul_acc.launches == n0 + 2
        assert torch.equal(first, ref), (p, float((first - ref).abs().max()))
        assert torch.equal(second, first), p


def test_q4_kernel_split_calls_back_to_back(card):
    """Split launches of different shapes queued back to back: each tile's
    ticket is reset by its last block, so every call is right."""
    cases = [(16, 11008, 4096), (5, 4096, 4096), (16, 11008, 4096), (64, 4096, 4096),
             (1, 11008, 4096)]
    ops = [_q4_operands(card, m, k, n, 512, "asym", i) for i, (m, k, n) in enumerate(cases)]
    assert all(tq4._plan(m, n, k, 512, True).splits > 1 for m, k, n in cases)
    outs = [tq4.q4_matmul_acc(*o, 512) for o in ops]
    torch.cuda.synchronize()
    for o, out in zip(ops, outs):
        assert torch.equal(out, tq4.q4_matmul_acc_plain(*o, 512))
    ws, tickets = tq4._split_buffers[ops[0][0].device]
    assert int(tickets.abs().sum()) == 0


def test_q4_kernel_refuses_what_it_does_not_take(card):
    x8 = torch.zeros((2, 48), dtype=torch.int8, device=card)
    w = torch.zeros((8, 24), dtype=torch.int8, device=card)
    gs = torch.ones((1, 8), device=card)
    with pytest.raises(ValueError, match="K % 32"):
        tq4.q4_matmul_acc(x8, w, gs, None, 128)
    x8, w = torch.zeros((2, 64), dtype=torch.int8, device=card), w.new_zeros((8, 32))
    with pytest.raises(ValueError, match="group"):
        tq4.q4_matmul_acc(x8, w, gs, None, 64)
    with pytest.raises(ValueError, match="scales"):
        tq4.q4_matmul_acc(x8, w, gs[:, :4], None, 128)
    with pytest.raises(ValueError, match="contiguous"):
        tq4.q4_matmul_acc(x8, w, gs.cpu(), None, 128)
    with pytest.raises(ValueError, match="group"):
        tq4.q4_matmul_acc(x8, w, gs, None, tq4.MAX_GROUP + 128)
    # a split plan must split on group boundaries, and its route must fit the grid
    x8 = torch.zeros((2, 4096), dtype=torch.int8, device=card)
    w, gs = x8.new_zeros((64, 2048)), torch.ones((8, 64), device=card)
    plan = tq4._plan(2, 64, 4096, 512, asym=False)
    with pytest.raises(ValueError, match="group boundaries"):
        tq4._launch(x8, w, gs, None, 512, dataclasses.replace(plan, per=5, splits=4))
    with pytest.raises(ValueError, match="symmetric grid"):
        tq4._launch(x8, w, gs, gs, 512, plan)


def _int8_cache(g, card, layers, lanes, slots, h, d):
    k8 = torch.randint(-127, 128, (layers, lanes, slots, h * d), generator=g, device=card,
                       dtype=torch.int8)
    v8 = torch.randint(-127, 128, k8.shape, generator=g, device=card, dtype=torch.int8)
    ks = (torch.rand(k8.shape[:3] + (h,), generator=g, device=card) / 50).to(torch.bfloat16)
    vs = (torch.rand(k8.shape[:3] + (h,), generator=g, device=card) / 50).to(torch.bfloat16)
    return [k8, ks, v8, vs]


@pytest.mark.parametrize("pp,step,shared,hb,db", [(128, 0, True, 32, 128), (128, 150, True, 32, 128),
                                                  (128, 255, False, 32, 128),
                                                  (80, 3, True, 32, 128), (20, 7, False, 4, 16)])
def test_flash_decode_current_kernel_matches_plain(card, pp, step, shared, hb, db):
    """K2'': slot pp + step (the last slot S - 1 at pp=128, step=255; in the
    block of b1 at pp=80, step=3), zeroed first in a clone; the kernel writes
    that row and nothing else."""
    g = torch.Generator(device=card).manual_seed(step + pp)
    lb, sb, layers, li = 8, 384, 3, 1
    cache = _int8_cache(g, card, layers, lb, sb, hb, db)
    slot = pp + step
    cur = [x[li, :, slot:slot + 1].clone() for x in cache]
    for x in cache:
        x[:, :, slot] = 0
    before = [x.clone() for x in cache]
    pre = ((cache[0][0, 0, :64].clone(), cache[1][0, 0, :64].clone(),
            cache[2][0, 0, :64].clone(), cache[3][0, 0, :64].clone()) if shared else None)
    q8, qs = tfd.quantize_q(torch.randn((lb, hb, db), generator=g, device=card))
    lens = torch.randint(0, pp + 1, (lb,), generator=g, device=card, dtype=torch.int32)
    args = (q8, qs, *cache, tfd.slot_masks(lens, pp, step - 1), li, db ** -0.5, 64)
    n = tfd.flash_decode_int8_current_kernel.launches
    got = tfd.flash_decode_int8_current_kernel(*args, shared=pre, p0=48, current=cur,
                                               write_cache=True)
    torch.cuda.synchronize()
    assert tfd.flash_decode_int8_current_kernel.launches == n + 1
    written = [x.clone() for x in cache]
    for x, b in zip(cache, before):
        x.copy_(b)
    ref = tfd.flash_decode_int8_plain(*args, shared=pre, p0=48, current=cur, write_cache=True)
    torch.testing.assert_close(got, ref, atol=2e-3, rtol=2e-3)
    for w, x, b, c in zip(written, cache, before, cur):
        assert torch.equal(w, x)                        # the plain version's writes
        assert torch.equal(w[li, :, slot], c[:, 0])
        mask = torch.ones(w.shape[:3], dtype=torch.bool, device=card)
        mask[li, :, slot] = False
        assert torch.equal(w[mask], b[mask])


def test_flash_decode_fused_kernel_equals_k2(card):
    """T1 at the JAX tool's default shape, one layer: bitwise K2."""
    g = torch.Generator(device=card).manual_seed(3)
    b, s, h, d = 56, 384, 32, 128
    k8, ks, v8, vs = _int8_cache(g, card, 2, b, s, h, d)
    kv8, kvs = torch.cat([k8, v8], -1), torch.cat([ks, vs], -1)
    q8, qs = tfd.quantize_q(torch.randn((b, h, d), generator=g, device=card))
    masks = tfd.slot_masks(torch.full((b,), 128, dtype=torch.int32, device=card), 128, 150)
    n = tfd.flash_decode_int8_fused_kernel.launches
    got = _k2_twice(lambda: tfd.flash_decode_int8_fused_kernel(q8, qs, kv8, kvs, masks, 1,
                                                               d ** -0.5, 64))
    ref = tfd.flash_decode_int8_kernel(q8, qs, k8, ks, v8, vs, masks, 1, d ** -0.5, 64)
    torch.cuda.synchronize()
    assert tfd.flash_decode_int8_fused_kernel.launches == n + 2
    assert torch.equal(got, ref)


# the wn boundaries (8, 16, 32, 64, rows past 64 tiled); K = 96 (one short
# box), 4096, 11008 (43 tiles, split K); a ragged last weight tile (N = 40,
# 4100); wo and down split K at M <= 64
@pytest.mark.parametrize("m,k,n", [(32, 4096, 12288), (32, 11008, 4096), (5, 4096, 22016),
                                   (5, 512, 1024), (70, 96, 40)]
                         + [(m, 4096, 4096) for m in (1, 8, 9, 16, 17, 32, 33, 64, 65, 256)]
                         + [(m, 96, 40) for m in (1, 9, 17, 33, 65)]
                         + [(m, 11008, 4100) for m in (1, 16, 33, 64, 256)]
                         + [(17, 4096, 40), (256, 4096, 12288)])
def test_w4_colscale_kernels_match_plain(card, m, k, n):
    g = torch.Generator(device=card).manual_seed(m + k + n)
    x8 = torch.randint(-127, 128, (m, k), generator=g, device=card, dtype=torch.int8)
    w = tw.random_q4c(k, n, g, card).w
    ref = tw.w4_int32_plain(x8, w)
    n2, n3 = tw.w4_int32_split.launches, tw.w4_int32.launches
    t2 = tw.w4_int32_split(*tw.split_even_odd(x8), w)
    t3 = tw.w4_int32(x8, w)
    torch.cuda.synchronize()
    assert (tw.w4_int32_split.launches, tw.w4_int32.launches) == (n2 + 1, n3 + 1)
    assert torch.equal(t2, ref) and torch.equal(t3, ref)


@pytest.mark.parametrize("m,k,n", [(32, 11008, 4096), (5, 4096, 4096), (64, 11008, 4100)])
def test_w4_colscale_split_k_repeats_itself(card, m, k, n):
    """Split K adds partial sums with atomics into a zeroed output, in any
    order: two runs are bitwise equal, and equal to the plain product."""
    assert tw._plan(m, n, k).splits > 1
    g = torch.Generator(device=card).manual_seed(k + n)
    x8 = torch.randint(-128, 128, (m, k), generator=g, device=card, dtype=torch.int8)
    w = tw.random_q4c(k, n, g, card).w
    ref = tw.w4_int32_plain(x8, w)
    for fn, xs in ((tw.w4_int32_split, tw.split_even_odd(x8)), (tw.w4_int32, (x8,))):
        first, second = fn(*xs, w), fn(*xs, w)
        torch.cuda.synchronize()
        assert torch.equal(first, second) and torch.equal(first, ref)


@pytest.mark.parametrize("m,k,n", [(5, 4096, 4096), (32, 96, 40), (64, 11008, 4100),
                                   (70, 4096, 12288)])
def test_w4_colscale_other_configurations_match_plain(card, m, k, n):
    """The configurations chip_smoke.py times beside the plan: 64 or 128
    weight rows a block everywhere (one or two consumer warpgroups), and no
    K split."""
    g = torch.Generator(device=card).manual_seed(m * n)
    x8 = torch.randint(-127, 128, (m, k), generator=g, device=card, dtype=torch.int8)
    w = tw.random_q4c(k, n, g, card).w
    ref = tw.w4_int32_plain(x8, w)
    for p in (tw._plan(m, n, k, rows=64), tw._plan(m, n, k, rows=128),
              dataclasses.replace(tw._plan(m, n, k), splits=1, per=-(-k // tw.KTILE))):
        assert torch.equal(tw._launch(True, tw.split_even_odd(x8), w, m, k, p), ref)
        assert torch.equal(tw._launch(False, (x8,), w, m, k, p), ref)


def test_w4_colscale_kernels_refuse_what_they_do_not_take(card):
    x8 = torch.zeros((4, 48), dtype=torch.int8, device=card)
    with pytest.raises(ValueError, match="K % 32"):
        tw.w4_int32(x8, torch.zeros((8, 24), dtype=torch.int8, device=card))
    with pytest.raises(ValueError):
        tw.w4_int32(torch.zeros((4, 64), dtype=torch.int8, device=card),
                    torch.zeros((8, 16), dtype=torch.int8, device=card))



@pytest.mark.parametrize("s,b,t", [(1280, 1, 5), (2048, 1, 16), (1536, 8, 6)])
def test_int8_verify_attention_on_the_card_matches_the_cpu(card, s, b, t):
    """The speculative verify's int8 attention (models/llama.py
    ``_attention_int8_verify``, plain PyTorch, no kernel of its own) on the
    card against the same function on the CPU: its integer sums bitwise
    (float64 products, exact on both devices) where near-uniform weights put
    a p . v sum past 2^24, f32's exact range; the output within 1e-4 (the
    softmax's exp and sums round per device, and a weight on a rounding edge
    moves its p code by one, ~0.03 / S of the output, a few times over)."""
    from radialog_tpu_torch.models import llama as tl
    g = torch.Generator().manual_seed(s)
    h, d = 32, 128
    q = torch.randn(b, t, h, d, generator=g) * 0.01          # near-uniform attention
    k8 = torch.randint(-127, 128, (1, b, s, h * d), generator=g, dtype=torch.int8)
    v8 = torch.randint(100, 128, (1, b, s, h * d), generator=g, dtype=torch.int8)
    ks = (torch.rand(1, b, s, h, generator=g) * 0.02 + 0.005).bfloat16()
    cache = tl.KVCache(k8, v8, ks, ks.clone())
    bias = torch.zeros(b, 1, t, s)
    p8 = torch.full((b, h, t, s), 127, dtype=torch.int8)
    vv = v8[0].view(b, s, h, d).permute(0, 2, 1, 3)
    want = tl.int8_dot_exact(p8, vv)
    got = tl.int8_dot_exact(p8.to(card), vv.to(card))
    assert float(want.abs().max()) > 2 ** 24
    assert torch.equal(got.cpu(), want)
    ref = tl._attention_int8_verify(q, cache, 0, bias, d)
    out = tl._attention_int8_verify(q.to(card), tl.KVCache(*(x.to(card) for x in (
        k8, v8, ks, ks))), 0, bias.to(card), d)
    torch.testing.assert_close(out.cpu(), ref, atol=1e-4, rtol=0)


@pytest.mark.parametrize("shape", [(32, 244, 244, 64), (32, 16, 16, 2048), (8, 3, 768)])
def test_batchnorm_train_mode_on_the_card_matches_the_cpu(card, shape):
    """Train-mode BatchNorm (ops/layers.py, plain PyTorch) on the card
    against the same function on the CPU at ResNet-50 widths and the
    classifier's batch: y within 1e-5, the batch statistics (the new running
    stats with momentum 1) within 1e-5 relative (a reduction sums in another
    order on each device, and CUDA's mean multiplies the sum by 1/n where
    the CPU's divides: a mean is not bitwise across devices)."""
    from radialog_tpu_torch.ops import layers as tl
    g = torch.Generator().manual_seed(shape[-1])
    c = shape[-1]
    x = torch.randn(shape, generator=g) * 2 + 0.5
    p = {"scale": torch.randn(c, generator=g), "bias": torch.randn(c, generator=g)}
    s = {"mean": torch.zeros(c), "var": torch.ones(c), "count": torch.zeros(())}
    want, want_s = tl.batchnorm(p, s, x, train=True, momentum=1.0)
    on = {k: v.to(card) for k, v in p.items()}
    got, got_s = tl.batchnorm(on, {k: v.to(card) for k, v in s.items()}, x.to(card),
                              train=True, momentum=1.0)
    torch.testing.assert_close(got.cpu(), want, atol=1e-5, rtol=1e-5)
    for k in ("mean", "var"):
        torch.testing.assert_close(got_s[k].cpu(), want_s[k], atol=1e-6, rtol=1e-5)
    assert float(got_s["count"]) == 1.0


def test_dropout_on_the_card(card):
    """ops/layers.py dropout on the card over 1e6 entries: a kept share of
    0.9 within 6 sigma (0.0018), every kept entry x / 0.9 as an IEEE
    division (the CPU's), every other 0, and the same mask again from the
    same generator state."""
    from radialog_tpu_torch.ops import layers as tl
    x = torch.randn(1_000_000, generator=torch.Generator().manual_seed(0)) + 3.0
    y = tl.dropout(x.to(card), 0.1, True, torch.Generator(device=card).manual_seed(1))
    kept = (y != 0).cpu()
    assert abs(float(kept.float().mean()) - 0.9) < 0.0018
    assert torch.equal(y.cpu()[kept], x[kept] / torch.tensor(0.9))
    again = tl.dropout(x.to(card), 0.1, True, torch.Generator(device=card).manual_seed(1))
    assert torch.equal(again, y)


@pytest.mark.parametrize("temperature", [0.7, 0.3])
def test_sampling_temperature_on_the_card_is_the_cpus_division(card, temperature):
    """decode/engine.py ``sampling_logits`` on the card at the report
    batch's sampled logits (56 x 32,001): bitwise the CPU's, an IEEE
    division by the temperature. A CUDA division by the Python scalar
    multiplies by its reciprocal and leaves entries an ulp apart (counted
    here first, so the test shows what it guards)."""
    from radialog_tpu_torch.decode import engine as te
    x = torch.randn(56, 32001, generator=torch.Generator().manual_seed(5)) * 3
    dp = te.DecodeParams(do_sample=True, temperature=temperature)
    native = int(((x.to(card) / temperature).cpu() != x / temperature).sum())
    assert native > 0
    assert torch.equal(te.sampling_logits(x.to(card), dp).cpu(), te.sampling_logits(x, dp))


@pytest.mark.parametrize("clip", [None, 1.0])
def test_adamw_on_the_card_matches_the_cpu(card, clip):
    """train/optim.py make_adamw (accumulation 3, decay 0.05, a warm-up-cosine
    schedule) over 30 updates of a LoRA-shaped tree on the card against the
    CPU from the same gradients: without the clip the moments, the update
    and the parameters bit for bit (the divisions by Adam's divisors and by
    the accumulation's count are IEEE divisions by 0-dim tensors on both
    devices, the square roots correctly rounded on both); with it the
    parameters within tests/test_torch_optim.py's CLIP_TOL, since the
    clip's norm sums each leaf in another order on each device."""
    from radialog_tpu_torch.train import optim as to
    g = torch.Generator().manual_seed(7)
    cpu = {"layers": {"wq": {"a": torch.randn(4, 512, 8, generator=g) * 0.04,
                             "b": torch.zeros(4, 8, 512)}},
           "img_proj": {"w": torch.randn(768, 512, generator=g) * 0.04, "b": torch.zeros(512)},
           "scale": torch.tensor(2.0)}
    tx = to.make_adamw(to.linear_warmup_cosine(3e-4, 3e-5, 10, 30), weight_decay=0.05,
                       grad_clip=clip, accum_steps=3)
    gpu = to.tree_map(lambda x: x.to(card), cpu)
    st_cpu, st_gpu = tx.init(cpu), tx.init(gpu)
    for micro in range(90):
        scale = 1e-2 if (micro // 3) % 2 == 0 else 1e-4
        grads = to.tree_map(lambda p: torch.randn(p.shape, generator=g) * scale, cpu)
        up_cpu, st_cpu = tx.update(grads, st_cpu, cpu)
        up_gpu, st_gpu = tx.update(to.tree_map(lambda x: x.to(card), grads), st_gpu, gpu)
        cpu, gpu = to.apply_updates(cpu, up_cpu), to.apply_updates(gpu, up_gpu)
        if up_cpu is None:
            continue
        pairs = [(gpu, cpu)] if clip else [(gpu, cpu), (up_gpu, up_cpu),
                                           (st_gpu["inner"]["mu"], st_cpu["inner"]["mu"]),
                                           (st_gpu["inner"]["nu"], st_cpu["inner"]["nu"])]
        for a, b in pairs:
            for x, y in zip(to.tree_leaves(a), to.tree_leaves(b)):
                if clip:
                    torch.testing.assert_close(x.cpu(), y, atol=2.5e-7, rtol=0)
                else:
                    assert torch.equal(x.cpu(), y), f"count {st_cpu['inner']['count']}"
    assert st_cpu["inner"]["count"] == 30


def test_pack_q4c_on_the_card_matches_the_cpu(card):
    """ops/w4_colscale.py pack_q4c at tools/microbench_w4_torch.py's
    spot-check shape: the codes and scales bit for bit (the scale is an IEEE
    division by 7 on both devices), where a division by the Python scalar
    7.0, a product with its reciprocal on the card, leaves scales apart."""
    w = torch.randn(4096, 4096, generator=torch.Generator().manual_seed(0)) * 0.02
    got, want = tw.pack_q4c(w.to(card)), tw.pack_q4c(w)
    assert torch.equal(got.scale.cpu(), want.scale) and torch.equal(got.w.cpu(), want.w)
    assert int(((w.to(card).abs().amax(dim=0) / 7.0).cpu() != want.scale).sum()) > 0
