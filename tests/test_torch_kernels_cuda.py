"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Imports torch and the port only (no JAX), so it runs on a machine with a
GPU and no JAX: ``pytest -m cuda tests/test_torch_kernels_cuda.py``. Without
a card every test skips. K1 is held bitwise; K2 at atol=rtol=2e-3 (f32 sums
in another order, and pv rounds to bf16 where an ulp of p can flip it)."""
import pytest
import torch

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
