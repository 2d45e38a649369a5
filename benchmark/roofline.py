"""The yardstick of the kernels' and the step's shares: the published peaks
of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates at the 700 W
limit), and the least bytes and operations of each hand-written kernel and
of the model, computed from shapes alone.

A bound counts each input byte read once and each output byte written
once; its time is the larger of bytes over the memory rate and operations
over the peak of the kernel's type.
"""
from __future__ import annotations

from typing import Dict, Iterable, Sequence, Tuple

HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
BF16_OPS_PER_S = 989e12
F32_OPS_PER_S = 67e12
PEAK_BY_PRECISION = {"w8a8": INT8_OPS_PER_S, "w4a8": INT8_OPS_PER_S, "bf16": BF16_OPS_PER_S}


def _bound(nbytes: float, ops: float, ops_per_s: float) -> Tuple[float, str]:
    b, o = nbytes / HBM_BYTES_PER_S, ops / ops_per_s
    return max(b, o), ("bytes" if b >= o else "operations")


def k1_bound(m: int, n: int, k: int) -> Tuple[float, str]:
    """K1, (M,K) int8 x (N,K) int8 -> (M,N) int32: both operands read once,
    the int32 result written once; 2MNK operations at the int8 peak.
    Returns (seconds, what bounds it)."""
    return _bound(m * k + n * k + 4 * m * n, 2 * m * n * k, INT8_OPS_PER_S)


def k2_bound(b: int, h: int, d: int, rows: int, prefix_rows: int,
             written_rows: int = 0) -> Tuple[float, str]:
    """K2/K2'/K2'': ``rows`` live lane rows read (int8 K and V, their bf16
    scales), the ``prefix_rows`` shared rows once, ``written_rows`` rows
    written, q in and out once (f32); 4*H*D operations per attended row
    (every lane attends the prefix) at the int8 peak."""
    row = 2 * h * d + 4 * h
    nbytes = (rows + prefix_rows + written_rows) * row + 2 * 4 * b * h * d
    return _bound(nbytes, 4 * (rows + b * prefix_rows) * h * d, INT8_OPS_PER_S)


def causal_pairs(t: int, lens: Iterable[int], s: int = None) -> int:
    """Valid (query, key) pairs of a causal block of ``t`` query rows: row i
    attends keys j <= i below the lane's length."""
    s = t if s is None else s
    total = 0
    for n in lens:
        n = min(int(n), s)
        # rows i < n attend i + 1 keys, rows i >= n attend n keys
        rows_in = min(n, t)
        total += rows_in * (rows_in + 1) // 2 + max(0, t - n) * n
    return total


def k3_bound(b: int, t: int, h: int, d: int, lens: Sequence[int], elt: int = 2,
             ops_per_s: float = BF16_OPS_PER_S) -> Tuple[float, str]:
    """K3, causal attention forward: q, k, v read once and out written once
    (``elt`` bytes an element); 4*H*D operations per valid pair."""
    return _bound(4 * b * t * h * d * elt, 4 * h * d * causal_pairs(t, lens), ops_per_s)


def k5_bound(b: int, t: int, h: int, d: int, lens: Sequence[int], elt: int = 2,
             ops_per_s: float = BF16_OPS_PER_S) -> Tuple[float, str]:
    """K5a + K5b, the whole causal backward: q, do, out read and dq written
    (T rows each), k and v read up to each lane's length, dk and dv written,
    the f32 lse (T rows; K5a computes delta itself); 10*H*D operations per
    valid pair (FA2's five products: s, dp, dv, dk, dq)."""
    kv_rows = sum(min(int(n), t) for n in lens)
    nbytes = (4 * b * t + 2 * kv_rows + 2 * b * t) * h * d * elt + 4 * b * h * t
    return _bound(nbytes, 10 * h * d * causal_pairs(t, lens), ops_per_s)


# ------------------------------------------------------------------ model
def llama_linear_params(model: Dict, vocab: int) -> int:
    """Weights every token multiplies: the layers' seven projections and the
    output head (the embedding is a lookup)."""
    h, inter = model["hidden_size"], model["intermediate_size"]
    kvh = model["num_key_value_heads"] * (h // model["num_attention_heads"])
    per_layer = h * h * 2 + 2 * h * kvh + 3 * h * inter
    return model["num_hidden_layers"] * per_layer + h * vocab


def llama_flops(model: Dict, vocab: int, tokens: int, attended: int,
                head_rows: int = None) -> float:
    """Model operations of ``tokens`` forward rows that attend ``attended``
    (query, key) pairs in all, with the output head on ``head_rows`` rows
    (default: every row): 2 per weight a row, 4*H*D per pair a layer."""
    h, inter = model["hidden_size"], model["intermediate_size"]
    kvh = model["num_key_value_heads"] * (h // model["num_attention_heads"])
    per_layer = h * h * 2 + 2 * h * kvh + 3 * h * inter
    rows = tokens if head_rows is None else head_rows
    return (2.0 * model["num_hidden_layers"] * per_layer * tokens + 2.0 * h * vocab * rows
            + 4.0 * h * model["num_hidden_layers"] * attended)


def conv_flops(h: int, w: int, cin: int, cout: int, k: int, stride: int) -> Tuple[float, int, int]:
    """(operations, out h, out w) of a 'same'-style convolution."""
    oh, ow = -(-h // stride), -(-w // stride)
    return 2.0 * oh * ow * cin * cout * k * k, oh, ow


def resnet50_flops(px: int, layers: Sequence[int] = (3, 4, 6, 3)) -> Tuple[float, int]:
    """(operations, output grid side) of the ResNet-50 trunk at px x px."""
    total, s = 0.0, px
    f, s, _ = conv_flops(s, s, 3, 64, 7, 2)
    total += f
    s = -(-s // 2)                       # the 3x3 max pool, stride 2
    in_ch = 64
    for stage, n_blocks in enumerate(layers):
        width = 64 * 2 ** stage
        for b in range(n_blocks):
            stride = 2 if (b == 0 and stage > 0) else 1
            f1, _, _ = conv_flops(s, s, in_ch, width, 1, 1)
            f2, so, _ = conv_flops(s, s, width, width, 3, stride)
            f3, _, _ = conv_flops(so, so, width, 4 * width, 1, 1)
            total += f1 + f2 + f3
            if stride != 1 or in_ch != 4 * width:
                total += conv_flops(s, s, in_ch, 4 * width, 1, stride)[0]
            s, in_ch = so, 4 * width
    return total, s


def biovil_flops(px: int, joint: int, layers: Sequence[int] = (3, 4, 6, 3)) -> Tuple[float, int]:
    """(operations, grid side) of BioViL-T without a prior image."""
    f, s = resnet50_flops(px, layers)
    cells = s * s
    f += 2.0 * cells * (2048 * 256 + 512 * joint + joint * joint)
    return f, s


def qformer_flops(vision: Dict, patches: int) -> float:
    """Operations of the image-grounded Q-Former pass over ``patches``
    image tokens."""
    q = vision["qformer"]
    n, hid, inter, enc = (vision["num_query_tokens"], q["hidden_size"],
                          q["intermediate_size"], vision["encoder_width"])
    total = 0.0
    for i in range(q["num_layers"]):
        total += 2.0 * n * 4 * hid * hid + 4.0 * n * n * hid
        if i % q["cross_attention_freq"] == 0:
            total += 2.0 * (2 * n * hid * hid + 2 * patches * enc * hid) + 4.0 * n * patches * hid
        total += 2.0 * n * 2 * hid * inter
    return total


def report_image_flops(vision: Dict) -> float:
    """Operations of one study's image side: BioViL-T at the report's size
    and the Q-Former over its patches, the classifier's BioViL-T at its
    crop and its head."""
    layers = vision["resnet_layers"]
    f_vis, s = biovil_flops(vision["image_px"], vision["encoder_width"], layers)
    f_cls, _ = biovil_flops(vision["classifier_px"], 128, layers)
    grid = vision["classifier_pool_grid"]
    head = 2.0 * (128 * grid * grid * 512 + 512 * vision["num_classes"])
    return f_vis + qformer_flops(vision, s * s) + f_cls + head
