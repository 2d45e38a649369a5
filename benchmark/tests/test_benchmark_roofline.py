"""The yardstick's counts against hand-worked ones, two shapes each."""
import pytest

from benchmark import roofline as R

HBM, I8, BF = R.HBM_BYTES_PER_S, R.INT8_OPS_PER_S, R.BF16_OPS_PER_S


def test_peaks_are_the_data_sheets():
    assert (HBM, I8, BF, R.F32_OPS_PER_S) == (3.35e12, 1979e12, 989e12, 67e12)


@pytest.mark.parametrize("m,n,k,nbytes,ops,by", [
    # a decode step's wo at batch 128: 128*4096 + 4096*4096 + 4*128*4096 bytes
    (128, 4096, 4096, 524_288 + 16_777_216 + 2_097_152, 2 * 128 * 4096 * 4096, "bytes"),
    # a prefill's wqkv at 4,480 rows
    (4480, 12288, 4096, 18_350_080 + 50_331_648 + 220_200_960, 450_971_566_080, "operations"),
])
def test_k1(m, n, k, nbytes, ops, by):
    t, what = R.k1_bound(m, n, k)
    assert what == by
    assert t == pytest.approx(max(nbytes / HBM, ops / I8), rel=1e-12)


@pytest.mark.parametrize("b,h,d,rows,p0,nbytes,ops", [
    # a row is 2*H*D int8 + 2*H bf16 scales = 24 bytes; q in, out f32
    (2, 2, 4, 10, 3, 13 * 24 + 128, 4 * (10 + 2 * 3) * 2 * 4),
    (128, 32, 128, 38_400, 48, 38_448 * 8_320 + 4_194_304, 4 * (38_400 + 6_144) * 4096),
])
def test_k2(b, h, d, rows, p0, nbytes, ops):
    t, what = R.k2_bound(b, h, d, rows, p0)
    assert what == "bytes"
    assert t == pytest.approx(max(nbytes / HBM, ops / I8), rel=1e-12)


@pytest.mark.parametrize("t,lens,pairs", [
    (4, [4], 1 + 2 + 3 + 4), (4, [2], 1 + 2 + 2 + 2),
    (256, [230], 230 * 231 // 2 + 26 * 230),
    (600, [600, 413], 600 * 601 // 2 + 413 * 414 // 2 + 187 * 413),
])
def test_causal_pairs(t, lens, pairs):
    assert R.causal_pairs(t, lens) == pairs


@pytest.mark.parametrize("b,t,h,d,lens,nbytes,ops", [
    (1, 4, 1, 2, [4], 4 * 4 * 2 * 2, 4 * 2 * 10),
    # the ring's admission of a 230-token prompt in its 256-row bucket
    (1, 256, 32, 128, [230], 4 * 256 * 4096 * 2, 4 * 4096 * 32_545),
])
def test_k3(b, t, h, d, lens, nbytes, ops):
    got, _ = R.k3_bound(b, t, h, d, lens)
    assert got == pytest.approx(max(nbytes / HBM, ops / BF), rel=1e-12)


@pytest.mark.parametrize("b,t,h,d,lens,nbytes,ops", [
    (1, 4, 1, 2, [4], (16 + 8 + 8) * 4 + 16, 10 * 2 * 10),
    # the LoRA micro-batch: 2 x 600, lengths 600 and 413
    (2, 600, 32, 128, [600, 413], (4_800 + 2_026 + 2_400) * 8_192 + 153_600,
     10 * 4096 * 343_022),
])
def test_k5(b, t, h, d, lens, nbytes, ops):
    got, _ = R.k5_bound(b, t, h, d, lens)
    assert got == pytest.approx(max(nbytes / HBM, ops / BF), rel=1e-12)


TINY = {"hidden_size": 4, "intermediate_size": 8, "num_attention_heads": 2,
        "num_key_value_heads": 2, "num_hidden_layers": 1}
DEEPSEEK = {"hidden_size": 4096, "intermediate_size": 11008, "num_attention_heads": 32,
            "num_key_value_heads": 32, "num_hidden_layers": 30}


def test_llama_params_and_flops():
    # a layer: q, o 16 each; k, v 16 each; gate, up, down 32 each = 160
    assert R.llama_linear_params(TINY, 10) == 160 + 40
    assert R.llama_flops(TINY, 10, tokens=3, attended=6) == 2 * 160 * 3 + 2 * 40 * 3 + 4 * 4 * 6
    per_layer = 2 * 4096 * 4096 + 2 * 4096 * 4096 + 3 * 4096 * 11008
    assert R.llama_linear_params(DEEPSEEK, 102_401) == 30 * per_layer + 4096 * 102_401
    assert R.llama_flops(DEEPSEEK, 102_401, 1, 0, head_rows=0) == 2 * 30 * per_layer


def test_resnet50_at_224_is_the_published_count():
    # torchvision's ResNet-50: 4.09 G multiply-adds at 224 px (the fc adds 2 M)
    flops, grid = R.resnet50_flops(224)
    assert grid == 7
    assert flops / 2 == pytest.approx(4.087e9, rel=2e-3)
    assert R.resnet50_flops(448)[1] == 14 and R.resnet50_flops(488)[1] == 16


def _k3_record(calls, count, seconds):
    return {"trace": {"k3_calls": calls, "families": {"k3": {"count": count,
                                                             "seconds": seconds}}}}


def test_k3_share_pairs_the_recorded_launches_with_the_profilers_kernels():
    from benchmark.metrics._read import k3_pct
    calls = [((1, 448, 32, 128), 448, [437], 2), ((1, 288, 32, 128), 288, [270], 2)]
    bound = sum(R.k3_bound(1, t, 32, 128, lens)[0] for (_, t, _, _), _, lens, _ in calls)
    assert k3_pct(_k3_record(calls, 2, 4 * bound)) == pytest.approx(25.0)
    # a launch recorded whose kernel the trace lacks, or the other way round
    assert k3_pct(_k3_record(calls, 3, 4 * bound)) is None
    assert k3_pct(_k3_record(calls[:1], 2, 4 * bound)) is None
    assert k3_pct(_k3_record([], 0, 0.0)) is None
