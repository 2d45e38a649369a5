"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Imports torch and the port only (no JAX), so it runs on a machine with a
GPU and no JAX: ``pytest -m cuda tests/test_torch_kernels_cuda.py``. Without
a card every test skips. K1 is held bitwise; K2 at atol=rtol=2e-3 (f32 sums
in another order, and pv rounds to bf16 where an ulp of p can flip it)."""
import pytest
import torch

from radialog_tpu_torch.ops import flash_attention as tfa
from radialog_tpu_torch.ops import flash_decode as tfd
from radialog_tpu_torch.ops import q8_matmul as tq8

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("m,k,n", [(1, 4096, 4096), (56, 11008, 4096), (56, 4096, 32001),
                                   (130, 4096, 12288), (7, 48, 9)])
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
    got = tfd.flash_decode_int8_kernel(*args, shared=pre, p0=48)
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
    got = tfd.flash_decode_int8_kernel(*args, shared=pre, p0=p0)
    ref = tfd.flash_decode_int8_plain(*args, shared=pre, p0=p0)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, ref, atol=2e-3, rtol=2e-3)


K3_TOL = {torch.bfloat16: dict(atol=1e-2, rtol=1e-2), torch.float32: dict(atol=1e-5, rtol=1e-5)}


@pytest.mark.parametrize("b,t,h,d,dtype,causal,ragged", [
    (1, 256, 32, 128, torch.bfloat16, True, False),
    (1, 431, 32, 128, torch.bfloat16, True, False),
    (1, 433, 32, 128, torch.bfloat16, True, False),
    (1, 436, 32, 128, torch.bfloat16, True, False),
    (12, 448, 32, 128, torch.bfloat16, True, True),
    (2, 300, 4, 16, torch.float32, True, True),
    (2, 300, 4, 128, torch.float32, False, True),
    (3, 200, 8, 64, torch.bfloat16, False, True),
])
def test_flash_attention_kernel_matches_plain(card, b, t, h, d, dtype, causal, ragged):
    g = torch.Generator(device=card).manual_seed(t + b)
    # q, k, v as strided views of one fused projection, as the model has them
    qkv = torch.randn((b, t, 3, h, d), generator=g, device=card).to(dtype)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    lens = torch.full((b,), t, dtype=torch.int32, device=card)
    if ragged:
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
