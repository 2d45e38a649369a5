#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (radialog_tpu_torch) on one NVIDIA GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card and the CUDA toolkit (nvcc). Phases, one JSON line
each; any failing phase exits non-zero:

  device  card name and power limit, torch/CUDA versions; builds every
          kernel from csrc/ (one nvcc per source, started together)
  k1      W8A8 GEMM kernel vs its plain version, bitwise, at the five
          Vicuna-7B weight shapes x M in {1, 16, 56, 48, 256, 56*80} (16 and
          256: the serve phase's decode lanes and a full admission); times
  k2      int8 flash-decode kernel vs its plain version (atol=rtol=2e-3) at
          B=56, H=32, D=128, S=384, L=32, shared prefix P0=48, at the
          binary-QA prefix (B=14, P0=427 of 448 rows), and with the serving
          ring's per-lane slot intervals and no prefix (B=16, S=384, prompts
          of 100-256 rows: a window inside the ring, a wrapped window, a full
          ring, a lane with no valid slot, a full prompt region); times
  k3      flash-attention kernel vs its plain version (K3_TOL, beside the
          plain version's own spread between key blocks of 64 and 256) at
          H=32, D=128, bf16, causal: B=1 with T=S in {256, 448, 1024}, the
          serve phase's admission (B=1, T=S=256, length 230, fused views), B=12
          with T=S=448 and lengths 300-448, and the qa phase's B=1 shapes
          T=S in {431, 436} with q/k/v as views of one fused projection;
          and H=4, D=16, f32, B=2, T=300; times, with
          scaled_dot_product_attention as the yardstick
  k4      W4A8 GEMM kernel vs its plain version (bitwise: each group's
          integer sum is exact and both add the groups in K order with
          single rounded f32 operations) at the four Vicuna-7B layer shapes,
          asymmetric and symmetric grids, M in {16, 56, 256}, and at the
          mock model's shapes; times
  small   the mock pipeline on the card vs the same weights on the CPU:
          query embeddings, prefill and teacher-forced decode logits, for
          the report batch (48-token shared prefix), for a batch whose
          shared prefix holds the image and is 273 tokens long (K3 in the
          prefix prefill, K2 over the long prefix), and for a batch of 2
          300-token prompts sharing only BOS (K3, then install_prefill);
          then, with W8A8 and with W4A8 weights, the mock pipeline through
          RaDialogServer over the int8 ring with staggered submits until the
          ring wraps, and teacher-forced logits of a hand-stepped ring
          schedule; every kernel call held against its plain version there
  slice   the full-width pipeline (Vicuna-7B W8A8, 32 layers, int8 KV,
          BioViL-T at 448, BERT-base Q-Former, CheXpert classifier at 488)
          with random weights from a seeded generator: 56 uint8 X-rays,
          128-token prompts sharing 48 tokens, greedy decode of 300 tokens
          with EOS disabled, after a warm-up; kernel launch counts of that
          run and reports/s
  qa      the evaluation follow-up passes on the slice's pipeline, over the
          slice's own conversations (prompt + 300 generated tokens) and
          image embeddings: the binary-QA pass over 2 studies (14 lanes,
          the image in a shared prefix of ~427 tokens), the all-QA pass over
          5, one batch-1 follow-up of 32 tokens (the correction pass's
          shape: prefill without a cache, then install_prefill) and the
          BERT-base CheXbert labels of 16 reports; seconds, launches per
          kernel (K3 exactly 32 x 3) and the metrics

  serve   the multi-session server at full width on the slice's weights:
          RaDialogServer over the int8 ring, 16 lanes, prompt region 256,
          ring 128, 8 steps per chunk; 4 client threads submit 32 sessions
          (image prompts of 100-250 tokens with the pipeline's own image
          embeddings, 64 new tokens, EOS disabled) and one oversized prompt;
          every future, every streamed delta and every kernel's launch count
          is checked; aggregate tokens/s, seconds to the first token, peak
          memory. Then 16 sessions x 32 tokens with W4A8 layers (K4 128
          times and K1 once per forward)

The line before the last is a JSON object with every kernel's numbers;
the last line is {"ok": true, "device": {...}}. A kernel's time is the
median over launches timed with CUDA events, the 50 MB L2 flushed before
each, all queued behind a sleep on the card so that no launch waits for the
host.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12      # H100 SXM (NVIDIA data sheet)
INT8_OPS_PER_S = 1979e12       # dense int8 tensor-core peak
BATCH, PROMPT, SHARED, NEW = 56, 128, 48, 300
BF16_OPS_PER_S = 989e12        # dense bf16 tensor-core peak
F32_OPS_PER_S = 67e12          # float32 outside the tensor cores
K2_TOL = dict(atol=2e-3, rtol=2e-3)
# K3 against its plain version: the plain version's own spread between key
# blocks of 64 and 256 on the same inputs is 3.9e-3 in bf16 (one bf16 step
# of an O(1) output) and 2.4e-7 in f32 (measured on the CPU at these shapes;
# each run prints it again beside its error); the kernel's 64-key tiles
# differ from both, so its running max and the rounding of p to bf16 may
# differ as much
K3_TOL = {"bfloat16": dict(atol=1e-2, rtol=1e-2), "float32": dict(atol=1e-5, rtol=1e-5)}
QA_STUDIES, ALL_QA_STUDIES, LABELED, FOLLOW_UP_NEW = 2, 5, 16, 32
LOGIT_TOL = {"mean": 3e-2, "max": 0.3}   # why: phase_small's docstring
# the serve phase: lanes, prompt region, cache length (ring 128), steps per chunk
LANES, PROMPT_REGION, CACHE_LEN, CHUNK = 16, 256, 384, 8
SESSIONS, SESSION_NEW, CLIENTS = 32, 64, 4
W4_SESSIONS, W4_NEW = 16, 32


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"


def timed_ms(fn, iters: int, flush) -> float:
    """Median device time of fn over iters launches, L2 flushed before each.

    Every launch is queued behind a sleep on the card, so the card never
    waits for the host between the two events: a decode-sized launch lasts
    tens of microseconds, as long as the wrapper's own host time."""
    import torch
    fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(iters)]
    torch.cuda._sleep(20_000_000)       # ~10 ms of card clock cycles
    for e0, e1 in events:
        flush()
        e0.record()
        fn()
        e1.record()
    torch.cuda.synchronize()
    return statistics.median(e0.elapsed_time(e1) for e0, e1 in events)


def phase_k1(torch, tq8, flush):
    """Every LLaMA projection shape at the report path's decode, prefix and
    prefill rows and at the serve phase's: 16 lanes at decode, a batch-1
    admission of a full prompt region (256 rows). The summary is one decoder
    layer's four projections at M = 56, with the same sum at M = 16."""
    h, inter, v = 4096, 11008, 32001
    shapes = {"wqkv": (h, 3 * h), "wo": (h, h), "gateup": (h, 2 * inter),
              "down": (inter, h), "lm_head": (h, v)}
    g = torch.Generator(device="cuda").manual_seed(1)
    summary = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
               "max_abs_err": 0, "bytes_bound": 0}
    serve = {"kernel_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    for name, (k, n) in shapes.items():
        w8 = torch.randint(-127, 128, (n, k), generator=g, device="cuda", dtype=torch.int8)
        for m in (1, LANES, 56, 48, PROMPT_REGION, BATCH * (PROMPT - SHARED)):
            x8 = torch.randint(-127, 128, (m, k), generator=g, device="cuda", dtype=torch.int8)
            got = tq8.q8_matmul_int32(x8, w8)
            ref = tq8.q8_matmul_int32_plain(x8, w8)
            torch.cuda.synchronize()
            err = int((got.long() - ref.long()).abs().max())
            if err:
                raise AssertionError(f"K1 {name} M={m}: int32 differs from plain by {err}")
            ms = timed_ms(lambda: tq8.q8_matmul_int32(x8, w8), 20, flush)
            plain_ms = timed_ms(lambda: tq8.q8_matmul_int32_plain(x8, w8), 3, flush)
            lib_ms = None
            if m > 16 and k % 8 == 0 and n % 8 == 0:   # torch._int_mm's shape rules
                lib_ms = timed_ms(lambda: torch._int_mm(x8, w8.t()), 20, flush)
            nbytes = m * k + n * k + 4 * m * n
            b_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            b_ops = 2 * m * n * k / INT8_OPS_PER_S * 1e3
            emit("k1", weight=name, m=m, k=k, n=n, bitwise=True, kernel_ms=ms,
                 plain_ms=plain_ms, library_ms=lib_ms, bound_ms=max(b_bytes, b_ops),
                 bound_by="bytes" if b_bytes >= b_ops else "operations",
                 roofline_share=max(b_bytes, b_ops) / ms)
            if m == BATCH and name != "lm_head":
                # the summary: one decoder layer's four projections at decode
                summary["ms"] += ms
                summary["plain_ms"] += plain_ms
                summary["library_ms"] += lib_ms
                summary["bound_ms"] += max(b_bytes, b_ops)
                summary["bytes_bound"] += b_bytes >= b_ops
            if m == LANES and name != "lm_head":
                serve["kernel_ms"] += ms
                serve["plain_ms"] += plain_ms
                serve["bound_ms"] += max(b_bytes, b_ops)
        del w8
    emit("k1", layer_sum="one decoder layer's 4 projections at the serve phase's decode",
         m=LANES, roofline_share=serve["bound_ms"] / serve["kernel_ms"], **serve)
    summary["ms_m16"], summary["bound_ms_m16"] = serve["kernel_ms"], serve["bound_ms"]
    summary["bound_by"] = "bytes" if summary.pop("bytes_bound") == 4 else "operations"
    return summary


def _k2_case(torch, tfd, flush, b, s, p0, t1, steps, seed):
    """K2 at one cache shape: lanes of t1 remainder slots (ragged, one
    empty), a shared prefix of p0 live rows padded to 32, decode steps
    ``steps``. Emits one line per step; returns {step: numbers}."""
    h, d, L, layer = 32, 128, 32, 16
    g = torch.Generator(device="cuda").manual_seed(seed)
    k8 = torch.randint(-127, 128, (L, b, s, h * d), generator=g, device="cuda", dtype=torch.int8)
    v8 = torch.randint(-127, 128, (L, b, s, h * d), generator=g, device="cuda", dtype=torch.int8)
    ks = (torch.rand((L, b, s, h), generator=g, device="cuda") * 0.01 + 0.002).to(torch.bfloat16)
    vs = (torch.rand((L, b, s, h), generator=g, device="cuda") * 0.01 + 0.002).to(torch.bfloat16)
    p0p = -(-p0 // 32) * 32
    k0 = torch.randint(-127, 128, (p0p, h * d), generator=g, device="cuda", dtype=torch.int8)
    v0 = torch.randint(-127, 128, (p0p, h * d), generator=g, device="cuda", dtype=torch.int8)
    ks0 = (torch.rand((p0p, h), generator=g, device="cuda") * 0.01 + 0.002).to(torch.bfloat16)
    vs0 = (torch.rand((p0p, h), generator=g, device="cuda") * 0.01 + 0.002).to(torch.bfloat16)
    q = torch.randn((b, h, d), generator=g, device="cuda", dtype=torch.float32)
    lens = torch.full((b,), t1, dtype=torch.int32, device="cuda")
    lens[::3] = max(t1 - 7, 1)          # ragged remainders
    lens[1] = 0                          # a lane with only its shared prefix
    q8, qs = tfd.quantize_q(q)
    shared = (k0, ks0, v0, vs0)
    out = {}
    for step in steps:
        masks = tfd.slot_masks(lens, t1, step)
        args = (q8, qs, k8, ks, v8, vs, masks, layer, d ** -0.5, tfd.default_bs(s))
        got = tfd.flash_decode_int8_kernel(*args, shared=shared, p0=p0)
        ref = tfd.flash_decode_int8_plain(*args, shared=shared, p0=p0)
        torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            raise AssertionError(f"K2 step {step}: non-finite output")
        torch.testing.assert_close(got, ref, **K2_TOL)
        err = float((got - ref).abs().max())
        ms = timed_ms(lambda: tfd.flash_decode_int8_kernel(*args, shared=shared, p0=p0), 20,
                      flush)
        plain_ms = timed_ms(lambda: tfd.flash_decode_int8_plain(*args, shared=shared, p0=p0),
                            3, flush)
        # bytes this run's data needs: each lane's valid rows (prompt and
        # generated; K, V, both scales), the live prefix rows once, q in
        # and out once
        rows = int(lens.long().sum()) + b * (step + 1)
        nbytes = rows * (2 * h * d + 4 * h) + p0 * (2 * h * d + 4 * h) + 2 * 4 * b * h * d
        ops = 4 * (rows + b * p0) * h * d
        b_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        b_ops = ops / INT8_OPS_PER_S * 1e3
        out[step] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": max(b_bytes, b_ops),
                     "bound_by": "bytes" if b_bytes >= b_ops else "operations",
                     "max_abs_err": err}
        emit("k2", batch=b, prefix_rows=p0p, step=step, max_abs_err=err, kernel_ms=ms,
             plain_ms=plain_ms, library_ms=None, bound_ms=max(b_bytes, b_ops),
             bound_by=out[step]["bound_by"], roofline_share=max(b_bytes, b_ops) / ms)
    del k8, v8
    return out


def _k2_ring_case(torch, tfd, flush):
    """K2 with the serving ring's per-lane closed slot intervals and no
    shared prefix, at the serve phase's cache shape: 16 lanes of 384 slots,
    prompt region [0, 256), ring [256, 384). Lane 0: a window inside the
    ring; 1: a wrapped window, both intervals live, with a dead gap of a
    former session's rows between its prompt and the ring; 2: a full ring;
    3: no session, no valid slot (zeros expected); 4: a prompt that fills the
    prompt region; the rest: windows of 1-120 writes ending at ring position
    70, some wrapped."""
    h, d, L, layer = 32, 128, 32, 16
    b, s, p, ring = LANES, CACHE_LEN, PROMPT_REGION, CACHE_LEN - PROMPT_REGION
    g = torch.Generator(device="cuda").manual_seed(6)
    k8 = torch.randint(-127, 128, (L, b, s, h * d), generator=g, device="cuda", dtype=torch.int8)
    v8 = torch.randint(-127, 128, (L, b, s, h * d), generator=g, device="cuda", dtype=torch.int8)
    ks = (torch.rand((L, b, s, h), generator=g, device="cuda") * 0.01 + 0.002).to(torch.bfloat16)
    vs = (torch.rand((L, b, s, h), generator=g, device="cuda") * 0.01 + 0.002).to(torch.bfloat16)
    q = torch.randn((b, h, d), generator=g, device="cuda", dtype=torch.float32)
    from radialog_tpu_torch.decode.continuous import ring_intervals
    lens = torch.randint(100, 257, (b,), generator=g, device="cuda", dtype=torch.int32)
    e = 70
    writes = torch.randint(1, 121, (b,), generator=g, device="cuda", dtype=torch.int32)
    writes[0], writes[1], writes[2], lens[4] = 31, 100, ring, p
    lens[3], writes[3] = 0, 0
    a1, b1, a2, b2 = ring_intervals(writes, e, p, ring)
    assert int(b2[1]) == s - 1 and int(b2[0]) == -1 and int(a2[2]) == p + e + 1
    q8, qs = tfd.quantize_q(q)
    masks = tfd.slot_masks(lens, gen_intervals=(a1, b1, a2, b2))
    args = (q8, qs, k8, ks, v8, vs, masks, layer, d ** -0.5, tfd.default_bs(s))
    got = tfd.flash_decode_int8_kernel(*args)
    ref = tfd.flash_decode_int8_plain(*args)
    torch.cuda.synchronize()
    if not torch.isfinite(got).all() or bool((got[3] != 0).any()):
        raise AssertionError("K2 intervals: a lane with no valid slot must give zeros")
    torch.testing.assert_close(got, ref, **K2_TOL)
    err = float((got - ref).abs().max())
    ms = timed_ms(lambda: tfd.flash_decode_int8_kernel(*args), 20, flush)
    plain_ms = timed_ms(lambda: tfd.flash_decode_int8_plain(*args), 3, flush)
    # bytes this run's data needs: each lane's valid rows (K, V, both
    # scales), q in and out once
    pos = torch.arange(s, device="cuda")[None]
    lm, m1, n1, m2, n2 = (x[:, None] for x in masks)
    rows = int(((pos < lm) | ((pos >= m1) & (pos <= n1)) | ((pos >= m2) & (pos <= n2))).sum())
    b_bytes = (rows * (2 * h * d + 4 * h) + 2 * 4 * b * h * d) / HBM_BYTES_PER_S * 1e3
    b_ops = 4 * rows * h * d / INT8_OPS_PER_S * 1e3
    out = {"ms": ms, "plain_ms": plain_ms, "bound_ms": max(b_bytes, b_ops),
           "bound_by": "bytes" if b_bytes >= b_ops else "operations", "max_abs_err": err}
    emit("k2", mode="ring intervals", batch=b, slots=s, valid_rows=rows,
         bs=tfd.default_bs(s), max_abs_err=err, kernel_ms=ms, plain_ms=plain_ms,
         library_ms=None, bound_ms=out["bound_ms"], bound_by=out["bound_by"],
         roofline_share=out["bound_ms"] / ms)
    return out


def phase_k2(torch, tfd, flush):
    """The report path's decode shape (B=56, P0=48), the binary-QA pass's
    (14 lanes of one study, the whole 427-token history in the prefix, a
    10-token answer in a 128-slot cache) and the serving ring's (per-lane
    intervals). Returns the summaries of the static-slot and the interval
    mode."""
    report = _k2_case(torch, tfd, flush, BATCH, 384, SHARED, PROMPT - SHARED,
                      (0, 150, NEW - 1), seed=2)
    qa = _k2_case(torch, tfd, flush, 14, 128, 427, 8, (0, 9), seed=4)
    summary = dict(report[150])
    summary["max_abs_err"] = max(r["max_abs_err"] for r in [*report.values(), *qa.values()])
    return summary, _k2_ring_case(torch, tfd, flush)


def phase_k4(torch, tq4, flush):
    """K4 at every W4A8 layer shape of Vicuna-7B, on both grids, at the
    serve phase's decode rows (16), the report batch's (56) and a prefill's
    (256); then the mock model's shapes. Held bitwise: each group's integer
    sum is exact, and kernel and plain version add the groups in K order
    with one rounded f32 multiply and add each. No single PyTorch call
    computes this function, so library_ms is null. The summary is one
    decoder layer's four projections at M = 16 on the asymmetric grid."""
    h, inter = 4096, 11008
    shapes = {"wqkv": (h, 3 * h), "wo": (h, h), "gateup": (h, 2 * inter), "down": (inter, h)}
    tiny = {"tiny_wqkv": (64, 192), "tiny_gateup": (64, 256), "tiny_down": (128, 64)}
    g = torch.Generator(device="cuda").manual_seed(8)
    summary = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "max_abs_err": 0.0,
               "bytes_bound": 0}
    for name, (k, n) in {**shapes, **tiny}.items():
        bk = tq4.pick_bk(k)
        group = tq4.GROUP if bk % tq4.GROUP == 0 else bk
        groups = -(-k // bk) * bk // group
        w = torch.randint(-128, 128, (n, k // 2), generator=g, device="cuda", dtype=torch.int8)
        gscale = (torch.rand((groups, n), generator=g, device="cuda") + 0.5) / (4.6 * k ** 0.5)
        offsets = (torch.rand((groups, n), generator=g, device="cuda") - 0.5) * gscale
        for mode, goff in (("asym", offsets), ("sym", None)):
            for m in (16, 56, 256):
                x8 = torch.randint(-127, 128, (m, k), generator=g, device="cuda",
                                   dtype=torch.int8)
                got = tq4.q4_matmul_acc(x8, w, gscale, goff, group)
                ref = tq4.q4_matmul_acc_plain(x8, w, gscale, goff, group)
                torch.cuda.synchronize()
                err = float((got - ref).abs().max())
                if not torch.isfinite(got).all() or err != 0.0:
                    raise AssertionError(f"K4 {name} {mode} M={m}: differs from plain by {err}")
                ms = timed_ms(lambda: tq4.q4_matmul_acc(x8, w, gscale, goff, group), 20, flush)
                plain_ms = timed_ms(
                    lambda: tq4.q4_matmul_acc_plain(x8, w, gscale, goff, group), 3, flush)
                nbytes = m * k + n * k // 2 + 4 * groups * n * (2 if goff is not None else 1) \
                    + 4 * m * n
                b_bytes = nbytes / HBM_BYTES_PER_S * 1e3
                b_ops = 2 * m * n * k / INT8_OPS_PER_S * 1e3
                emit("k4", weight=name, mode=mode, m=m, k=k, n=n, group=group, bitwise=True,
                     max_abs_err=err, kernel_ms=ms, plain_ms=plain_ms, library_ms=None,
                     bound_ms=max(b_bytes, b_ops),
                     bound_by="bytes" if b_bytes >= b_ops else "operations",
                     roofline_share=max(b_bytes, b_ops) / ms)
                if m == LANES and mode == "asym" and name in shapes:
                    summary["ms"] += ms
                    summary["plain_ms"] += plain_ms
                    summary["bound_ms"] += max(b_bytes, b_ops)
                    summary["bytes_bound"] += b_bytes >= b_ops
        del w
    summary["bound_by"] = "bytes" if summary.pop("bytes_bound") == 4 else "operations"
    return summary


def _k3_bound(b, t, h, d, lens, elt, ops_per_s):
    """(bound ms, bound_by) of causal attention: q, k, v read once and out
    written once over the memory rate, against 4*H*D operations per valid
    (query, key) pair of these lengths over the peak of the type."""
    nbytes = 4 * b * t * h * d * elt
    # query i attends keys j < n with j <= i
    pairs = sum(min(i + 1, min(int(n), t)) for n in lens for i in range(t))
    b_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    b_ops = 4 * h * d * pairs / ops_per_s * 1e3
    return max(b_bytes, b_ops), "bytes" if b_bytes >= b_ops else "operations"


def phase_k3(torch, tfa, flush):
    """Square shapes; the serve phase's admission of a 230-token prompt in
    its 256-row bucket (a partial last key tile, query rows past the
    length); and the qa phase's own: the binary-QA prefix (431 tokens) and
    the batch-1 follow-up (436), both ending in a partial 64-row tile, with
    q/k/v read as views of one fused (B, T, 3*H*D) projection as
    models/llama.py hands them over."""
    shapes = [(1, 256, 32, 128, "bfloat16", False, False),
              (1, 256, 32, 128, "bfloat16", [230], True),
              (1, 448, 32, 128, "bfloat16", False, False),
              (1, 1024, 32, 128, "bfloat16", False, False),
              (12, 448, 32, 128, "bfloat16", True, False),
              (1, 431, 32, 128, "bfloat16", False, True),
              (1, 436, 32, 128, "bfloat16", False, True),
              (2, 300, 4, 16, "float32", True, False)]
    f = torch.nn.functional
    summary, worst = None, 0.0
    for i, (b, t, h, d, dt, ragged, fused) in enumerate(shapes):
        dtype = getattr(torch, dt)
        g = torch.Generator(device="cuda").manual_seed(30 + i)
        if fused:
            qkv = torch.randn((b, t, 3 * h * d), generator=g, device="cuda").to(dtype)
            q, k, v = (x.reshape(b, t, h, d) for x in qkv.split(h * d, dim=-1))
            assert not any(x.is_contiguous() for x in (q, k, v))
        else:
            q, k, v = (torch.randn((b, t, h, d), generator=g, device="cuda").to(dtype)
                       for _ in range(3))
        lens = torch.full((b,), t, dtype=torch.int32, device="cuda")
        if isinstance(ragged, list):
            lens = torch.tensor(ragged, dtype=torch.int32, device="cuda")
        elif ragged:
            lens = torch.randint(t * 2 // 3, t + 1, (b,), generator=g, device="cuda",
                                 dtype=torch.int32)
        got = tfa.flash_attention_kernel(q, k, v, lens)
        ref = tfa.flash_attention_plain(q, k, v, lens)
        spread = float((tfa.flash_attention_plain(q, k, v, lens, bk=64).float()
                        - ref.float()).abs().max())
        torch.cuda.synchronize()
        if not torch.isfinite(got.float()).all():
            raise AssertionError(f"K3 {b}x{t}: non-finite output")
        torch.testing.assert_close(got.float(), ref.float(), **K3_TOL[dt])
        err = float((got.float() - ref.float()).abs().max())
        worst = max(worst, err)
        pos = torch.arange(t, device="cuda")
        mask = ((pos[None, :] <= pos[:, None])[None]
                & (pos[None, None, :] < lens[:, None, None].long()))[:, None]
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        ms = timed_ms(lambda: tfa.flash_attention_kernel(q, k, v, lens), 20, flush)
        plain_ms = timed_ms(lambda: tfa.flash_attention_plain(q, k, v, lens), 3, flush)
        lib_ms = timed_ms(lambda: f.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask),
                          20, flush)
        bound, by = _k3_bound(b, t, h, d, lens.tolist(), q.element_size(),
                              BF16_OPS_PER_S if dt == "bfloat16" else F32_OPS_PER_S)
        emit("k3", batch=b, t=t, heads=h, head_dim=d, dtype=dt, fused_qkv_views=fused,
             lengths=[int(x) for x in lens.tolist()], max_abs_err=err, tol=K3_TOL[dt],
             plain_block_spread=spread, kernel_ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
             bound_ms=bound, bound_by=by, roofline_share=bound / ms)
        if (b, t, dt) == (1, 431, "bfloat16"):
            # the binary-QA prefix prefill, one layer
            summary = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                       "bound_ms": bound, "bound_by": by}
    summary["max_abs_err"] = worst
    return summary


def _prompts(tok, n: int, img_tokens: int):
    """n prompts of PROMPT tokens (BOS included) sharing the first SHARED:
    per request 4 words, the <IMG> run, then words to fill."""
    shared = " ".join(f"sys{i}" for i in range(SHARED - 1))
    rest = PROMPT - SHARED - 4 - img_tokens
    return [f"{shared} req{j} a{j} b{j} c{j} " + "<IMG> " * img_tokens
            + " ".join(f"w{j}x{i}" for i in range(rest)) for j in range(n)]


class _Checked:
    """Stand-in for a kernel wrapper during the small phase: on each call it
    runs the kernel and the plain version on the same CUDA inputs and keeps
    the largest difference and the largest plain value, so every kernel is
    also held at the mock pipeline's own shapes (K1: K=64/128, N up to 256;
    K2: H=4, D=16; K3: H=4, D=16, f32)."""

    def __init__(self, kernel, plain):
        self.kernel, self.plain, self.calls, self.err, self.ref_max = kernel, plain, 0, 0.0, 0.0
        # the kernel counts its launches on the name it is bound to, which
        # is this object while it stands in; those launches are not counted
        self.launches = 0

    def __call__(self, *args, **kw):
        if not args[0].is_cuda:
            # the CPU pipeline's call: the wrapper takes its plain version,
            # which is no launch and proves nothing about the kernel
            return self.kernel(*args, **kw)
        got = self.kernel(*args, **kw)
        ref = self.plain(*args, **kw)
        self.calls += 1
        self.err = max(self.err, float((got.double() - ref.double()).abs().max()))
        self.ref_max = max(self.ref_max, float(ref.double().abs().max()))
        return got


def phase_small(torch, te, pipeline_mod, tq8, tfd, tfa, tq4):
    """Mock pipeline on the card vs the same weights on the CPU.

    The tolerance is loose on purpose. W8A8 rounds every activation row to
    int8, so a float difference of one ulp (the card sums in another order)
    can move a value across a rounding edge and shift the logits by a
    quantization step. On the CPU alone, relative perturbations of 1e-6 to
    1e-5 of the query embeddings move these logits (std 1.00) by up to
    0.086, 0.011 on average. Small wiring faults, measured the same way,
    move them more: attention that drops one shared-prefix row by up to 1.5
    (mean 0.063), one that drops the newest slot by up to 0.54 (mean 0.033),
    the neighbouring layer's cache by up to 6.3 (mean 1.0). So the logits
    are held at max |err| < 0.3 and mean |err| < 0.03, and each kernel is
    held tightly against its plain version on the card at these shapes."""
    cfg = pipeline_mod.PipelineConfig(mock=True, device="cpu", seed=5)
    cpu = pipeline_mod.RaDialogPipeline(cfg)
    gpu = pipeline_mod.RaDialogPipeline(cfg).to("cuda")
    k1 = _Checked(tq8.q8_matmul_int32, tq8.q8_matmul_int32_plain)
    k2 = _Checked(tfd.flash_decode_int8_kernel, tfd.flash_decode_int8_plain)
    k3 = _Checked(tfa.flash_attention_kernel, tfa.flash_attention_plain)
    k4 = _Checked(tq4.q4_matmul_acc, tq4.q4_matmul_acc_plain)
    tq8.q8_matmul_int32, tfd.flash_decode_int8_kernel, tfa.flash_attention_kernel = k1, k2, k3
    tq4.q4_matmul_acc = k4
    try:
        _small_run(torch, te, pipeline_mod, cpu, gpu, k1, k2, k3)
        _small_serve(torch, pipeline_mod, {8: (cpu, gpu)}, k1, k2, k4)
    finally:
        tq8.q8_matmul_int32, tfd.flash_decode_int8_kernel = k1.kernel, k2.kernel
        tfa.flash_attention_kernel, tq4.q4_matmul_acc = k3.kernel, k4.kernel


def _teacher_forced(torch, te, pipeline_mod, p, ids, emb, forced, dp):
    """Per-step logits of pipeline p on its device with the ids ``forced``
    fed back, through the engine calls that generate_ids makes for these
    prompts (shared-prefix or plain prefill)."""
    from radialog_tpu_torch.apps.tokenization import pad_batch_right
    from radialog_tpu_torch.models.llama import find_img_start, init_cache, llama_apply, \
        prefill_bias
    n, dev = len(ids), p.device
    p0, img_in_prefix = p._shared_prefix_len(ids, emb)
    if p0 >= pipeline_mod.SHARED_PREFIX_MIN:
        rem, lens = pad_batch_right([s[p0:] for s in ids], 0)
        rem, lens = torch.as_tensor(rem, device=dev), torch.as_tensor(lens, device=dev)
        t1 = rem.shape[1]
        shared = te.prefix_kv(p.llama, p.llama_cfg, torch.as_tensor(ids[0][:p0], device=dev),
                              lora=p.lora, policy=p.policy,
                              img_embs=emb[:1] if img_in_prefix else None)
        rem_emb = None if img_in_prefix else emb
        cache = init_cache(p.llama_cfg, n, te.default_cache_len(t1, dp), device=dev)
        first, cache = llama_apply(
            p.llama, p.llama_cfg, rem, p0 + torch.arange(t1, device=dev)[None].repeat(n, 1),
            prefill_bias(lens, t1), cache=cache, img_embs=rem_emb,
            img_start=(find_img_start(rem, p.llama_cfg.img_token_id)
                       if rem_emb is not None else None),
            lora=p.lora, policy=p.policy, lengths=lens, last_pos=lens - 1, shared_kv=shared)
        first = first[:, 0]
        kw = dict(shared_kv=te.quantize_prefix(shared), pos_offset=p0, shared_p0=p0)
    else:
        tok, lens = pad_batch_right(ids, 0)
        tok, lens = torch.as_tensor(tok, device=dev), torch.as_tensor(lens, device=dev)
        t1 = tok.shape[1]
        cache, first = te.prefill(p.llama, p.llama_cfg, tok, lens, te.default_cache_len(t1, dp),
                                  img_embs=emb, lora=p.lora, policy=p.policy)
        kw = {}
    out = [first]
    for step in range(forced.shape[1] - 1):
        out.append(te.decode_step(p.llama, p.llama_cfg, cache, forced[:, step].to(dev), lens,
                                  t1, step, lora=p.lora, policy=p.policy, **kw))
    return torch.stack(out, 1).cpu()


def _small_case(torch, te, pipeline_mod, cpu, gpu, prompts, e_cpu, new=12):
    ids = [cpu.tokenizer(x)["input_ids"] for x in prompts]
    dp = cpu.decode_params(max_new_tokens=new, eos_token_id=-1)
    res_cpu = cpu.generate_ids(ids, e_cpu, dp)
    res_gpu = gpu.generate_ids(ids, e_cpu.cuda(), dp)
    agree = float((res_gpu.tokens.cpu() == res_cpu.tokens).float().mean())
    # teacher-forced logits on the CPU's greedy ids
    forced = res_cpu.tokens
    a = _teacher_forced(torch, te, pipeline_mod, cpu, ids, e_cpu, forced, dp)
    b = _teacher_forced(torch, te, pipeline_mod, gpu, ids, e_cpu.cuda(), forced, dp)
    diff = (a - b).abs()
    return {"prompt_tokens": max(len(x) for x in ids),
            "shared_prefix": cpu._shared_prefix_len(ids, e_cpu)[0],
            "teacher_forced_logit_max_abs_err": float(diff.max()),
            "teacher_forced_logit_mean_abs_err": float(diff.mean()),
            "logit_std": float(a.std()), "greedy_agreement": agree}


def _small_run(torch, te, pipeline_mod, cpu, gpu, k1, k2, k3):
    from radialog_tpu_torch.ops.image import expand_cxr_u8
    u8 = torch.randint(0, 256, (4, 64, 64), generator=torch.Generator().manual_seed(0),
                       dtype=torch.uint8)
    e_cpu = cpu.embed_images(expand_cxr_u8(u8))
    e_gpu = gpu.embed_images(expand_cxr_u8(u8.cuda()))
    emb_err = float((e_gpu.cpu() - e_cpu).abs().max())
    img = "<IMG> " * 32
    # the report batch: 4 images, a 48-token shared prefix before them
    cases = {"report": _small_case(torch, te, pipeline_mod, cpu, gpu,
                                   _prompts(cpu.tokenizer, 4, 32), e_cpu)}
    # one image for every lane, joining a 273-token shared prefix
    hist = " ".join(f"sys{i}" for i in range(40)) + f" {img}" + " ".join(
        f"h{i}" for i in range(200))
    k3_before = k3.calls
    cases["long_prefix"] = _small_case(
        torch, te, pipeline_mod, cpu, gpu,
        [f"{hist} q{j} a{j} b{j} c{j}" for j in range(4)], e_cpu[:1].repeat(4, 1, 1))
    k3_long = k3.calls - k3_before
    # 2 prompts of 300+ tokens sharing only BOS: prefill without a cache,
    # then install_prefill
    k3_before = k3.calls
    cases["no_prefix"] = _small_case(
        torch, te, pipeline_mod, cpu, gpu,
        [f"p{j} {img}" + " ".join(f"p{j}w{i}" for i in range(268)) for j in range(2)],
        e_cpu[:2])
    k3_plain_prefill = k3.calls - k3_before
    k3_tol = K3_TOL["float32"]
    emit("small", embed_max_abs_err=emb_err, logit_tol=LOGIT_TOL, cases=cases,
         k1_calls=k1.calls, k1_max_abs_err=k1.err, k2_calls=k2.calls, k2_max_abs_err=k2.err,
         k3_calls=k3.calls, k3_calls_long_prefix=k3_long, k3_calls_no_prefix=k3_plain_prefill,
         k3_max_abs_err=k3.err, k3_tol=k3_tol)
    ok = (emb_err < 1e-3 and k1.calls and k1.err == 0 and k2.calls and k2.err < K2_TOL["atol"]
          and k3.calls and k3_long and k3_plain_prefill
          and k3.err <= k3_tol["atol"] + k3_tol["rtol"] * k3.ref_max
          and cases["long_prefix"]["shared_prefix"] >= 256
          and cases["no_prefix"]["shared_prefix"] < pipeline_mod.SHARED_PREFIX_MIN
          and all(c["teacher_forced_logit_mean_abs_err"] < LOGIT_TOL["mean"]
                  and c["teacher_forced_logit_max_abs_err"] < LOGIT_TOL["max"]
                  for c in cases.values()))
    if not ok:
        raise AssertionError("card and CPU disagree on the mock pipeline")


def _ring_run(torch, p, requests, new, chunk):
    """The requests through RaDialogServer on pipeline p's device: int8
    ring of 32 slots behind a 64-slot prompt region, 2 lanes; two submits,
    the rest after the first result. Returns (tokens per request, ring_pos)."""
    from radialog_tpu_torch.apps.serve import RaDialogServer
    from radialog_tpu_torch.decode.engine import DecodeParams
    srv = RaDialogServer(p.llama, p.llama_cfg, lanes=2, cache_len=96, prompt_len=64,
                         dp=DecodeParams(max_new_tokens=new, eos_token_id=-1), lora=p.lora,
                         policy=p.policy, steps_per_call=chunk, kv_int8=True, device=p.device)
    try:
        futs = [srv.submit(ids, img_embs=emb.to(p.device)) for ids, emb in requests[:2]]
        futs[0].result(timeout=300)
        futs += [srv.submit(ids, img_embs=emb.to(p.device)) for ids, emb in requests[2:]]
        tokens = [f.result(timeout=300) for f in futs]
    finally:
        srv.shutdown()
    return tokens, srv._rb.ring_pos


def _ring_teacher_forced(torch, p, requests, forced):
    """Per-step logits of pipeline p's ring path with the ids ``forced``
    (steps, 2) fed back, a schedule stepped by hand over the batcher's own
    prefill and the model's interval mode: lane 0 decodes steps 0-24 and is
    admitted again at step 30; lane 1 has no session until step 20 (no valid
    slot), then decodes to the end, its window wrapping the 32-slot ring.
    Returns the logits of the lanes with a session, (n, V)."""
    from radialog_tpu_torch.decode.continuous import RingBatcher, ring_intervals
    from radialog_tpu_torch.decode.engine import DecodeParams
    from radialog_tpu_torch.models.llama import llama_apply
    dev, prompt, ring = p.device, 64, 32
    rb = RingBatcher(p.llama, p.llama_cfg, lanes=2, cache_len=prompt + ring, prompt_len=prompt,
                     dp=DecodeParams(max_new_tokens=26, eos_token_id=-1), lora=p.lora,
                     policy=p.policy, kv_int8=True, device=dev)
    lens = torch.zeros(2, dtype=torch.int32, device=dev)
    cur, writes = lens.clone(), lens.clone()
    active = torch.zeros(2, dtype=torch.bool, device=dev)

    def admit(lane, req):
        ids, emb = req
        tokens = torch.tensor([ids + [0] * (prompt - len(ids))], dtype=torch.int32, device=dev)
        rb._prefill_fn(tokens, len(ids), lane, emb.to(dev))
        lens[lane], cur[lane], writes[lane], active[lane] = len(ids), len(ids), 0, True

    out = []
    admit(0, requests[0])
    with torch.no_grad():
        for step in range(forced.shape[0]):
            if step == 20:
                admit(1, requests[1])
            if step == 25:
                active[0] = False
            if step == 30:
                admit(0, requests[2])
            e = step % ring
            writes = writes + active
            logits, _ = llama_apply(p.llama, p.llama_cfg, forced[step].to(dev)[:, None],
                                    cur[:, None], None, cache=rb.cache, write_pos=prompt + e,
                                    lora=p.lora, policy=p.policy, lengths=lens,
                                    slot_info=ring_intervals(writes, e, prompt, ring))
            out.append(logits[:, 0][active].cpu())
            cur = cur + active
    return torch.cat(out)


def _small_serve(torch, pipeline_mod, pipes, k1, k2, k4):
    """The mock pipeline through RaDialogServer over the int8 ring, on the
    card and on the CPU, with W8A8 and with W4A8 weights: six image prompts
    of 12 new tokens through 2 lanes in chunks of 4, so the 32-slot ring
    wraps; then teacher-forced logits of the hand-stepped ring schedule
    under phase_small's bound. Greedy agreement is reported, not held: a
    rounding edge may flip a token (phase_small's docstring)."""
    cfg4 = pipeline_mod.PipelineConfig(mock=True, device="cpu", seed=5, weight_bits=4)
    pipes[4] = (pipeline_mod.RaDialogPipeline(cfg4),
                pipeline_mod.RaDialogPipeline(cfg4).to("cuda"))
    cpu = pipes[8][0]
    from radialog_tpu_torch.ops.image import expand_cxr_u8
    u8 = torch.randint(0, 256, (6, 64, 64), generator=torch.Generator().manual_seed(9),
                       dtype=torch.uint8)
    embs = cpu.embed_images(expand_cxr_u8(u8))
    requests = [(cpu.tokenizer(f"s{j} t{j} " + "<IMG> " * 32
                               + " ".join(f"r{j}w{i}" for i in range(2 + 4 * j)))["input_ids"],
                 embs[j:j + 1]) for j in range(6)]
    forced = torch.randint(3, 240, (45, 2), generator=torch.Generator().manual_seed(10),
                           dtype=torch.int32)
    cases, ok = {}, True
    for bits, (cpu_p, gpu_p) in pipes.items():
        before = (k1.calls, k2.calls, k4.calls)
        tok_cpu, _ = _ring_run(torch, cpu_p, requests, 12, 4)
        tok_gpu, ring_pos = _ring_run(torch, gpu_p, requests, 12, 4)
        a = _ring_teacher_forced(torch, cpu_p, requests, forced)
        b = _ring_teacher_forced(torch, gpu_p, requests, forced)
        diff = (a - b).abs()
        agree = sum(x == y for tc_, tg in zip(tok_cpu, tok_gpu) for x, y in zip(tc_, tg))
        cases[f"w{bits}"] = {
            "sessions": len(tok_gpu), "ring_pos": ring_pos, "ring_len": 32,
            "greedy_agreement": agree / (12 * len(requests)),
            "teacher_forced_logit_max_abs_err": float(diff.max()),
            "teacher_forced_logit_mean_abs_err": float(diff.mean()),
            "logit_std": float(a.std()), "k1_calls": k1.calls - before[0],
            "k2_calls": k2.calls - before[1], "k4_calls": k4.calls - before[2]}
        ok = (ok and ring_pos > 32 and all(len(t) == 12 for t in tok_gpu)
              and a.shape == b.shape and bool(torch.isfinite(b).all())
              and float(diff.mean()) < LOGIT_TOL["mean"] and float(diff.max()) < LOGIT_TOL["max"]
              and k2.calls > before[1] and k1.calls > before[0]
              and (k4.calls > before[2]) == (bits == 4))
    emit("small_serve", logit_tol=LOGIT_TOL, cases=cases, k1_max_abs_err=k1.err,
         k2_max_abs_err=k2.err, k4_calls=k4.calls, k4_max_abs_err=k4.err)
    if not (ok and k1.err == 0 and k2.err < K2_TOL["atol"] and k4.err == 0):
        raise AssertionError("card and CPU disagree on the mock pipeline's ring serving")


def phase_slice(torch, te, pipeline_mod, tq8, tfd):
    from radialog_tpu_torch.ops.image import expand_cxr_u8
    t0 = time.time()
    pipe = pipeline_mod.RaDialogPipeline(pipeline_mod.PipelineConfig(synthetic=True, seed=0))
    torch.cuda.synchronize()
    build_s = time.time() - t0
    g = torch.Generator(device="cuda").manual_seed(3)
    xray448 = torch.randint(0, 256, (BATCH, 448, 448), generator=g, device="cuda",
                            dtype=torch.uint8)
    xray488 = torch.randint(0, 256, (BATCH, 488, 488), generator=g, device="cuda",
                            dtype=torch.uint8)
    prompts = _prompts(pipe.tokenizer, BATCH, pipe.llama_cfg.num_img_tokens)
    ids = [pipe.tokenizer(p)["input_ids"] for p in prompts]
    assert all(len(s) == PROMPT for s in ids)

    def report_step(new_tokens: int):
        findings = pipe.classify_findings(expand_cxr_u8(xray488))
        embs = pipe.embed_images(expand_cxr_u8(xray448))
        dp = pipe.decode_params(max_new_tokens=new_tokens, eos_token_id=-1)
        return findings, embs, pipe.generate_ids(ids, embs, dp)

    report_step(8)                      # warm-up: cuDNN plans, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tq8.q8_matmul_int32.launches = 0
    tfd.flash_decode_int8_kernel.launches = 0
    t0 = time.time()
    findings, embs, res = report_step(NEW)
    tokens = res.tokens.cpu()
    dt = time.time() - t0
    launches = {"q8_matmul": tq8.q8_matmul_int32.launches,
                "flash_decode_int8": tfd.flash_decode_int8_kernel.launches}
    p0, _ = pipe._shared_prefix_len(ids, embs)
    ok = (tokens.shape == (BATCH, NEW) and int(tokens.min()) >= 0
          and int(tokens.max()) < pipe.llama_cfg.vocab_size
          and bool(torch.isfinite(embs).all()) and embs.shape == (BATCH, 32, 768)
          and len(findings) == BATCH and p0 == SHARED
          and all(res.lengths.cpu() == NEW) and all(v > 0 for v in launches.values()))
    emit("slice", reports_per_s=BATCH / dt, seconds=dt, batch=BATCH, prompt=PROMPT,
         shared_prefix=p0, new_tokens=NEW, launches=launches,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, build_s=build_s,
         distinct_tokens=int(tokens.unique().numel()), ok=ok)
    if not ok:
        raise AssertionError("the full-width slice produced a malformed result")
    # decode steps per report: 299 forwards x 32 layers of K2, plus K1 calls
    return launches, {"pipe": pipe, "prompts": prompts, "tokens": tokens,
                      "lengths": res.lengths.cpu(), "embs": embs}


def phase_qa(torch, tq8, tfd, tfa, sl):
    """The follow-up passes over the slice's conversations: each history is
    a slice prompt and its 300 generated tokens as decoded text, with the
    slice's image embeddings of that request."""
    import numpy as np
    from radialog_tpu_torch.apps import evaluate as ev
    from radialog_tpu_torch.data.downstream import all_qa_prompt, binary_qa_prompts
    from radialog_tpu_torch.eval.ce_metrics import CHEXPERT_COLS
    pipe, embs, tok = sl["pipe"], sl["embs"], sl["pipe"].tokenizer
    reports = [tok.decode(row[:int(n)].tolist(), skip_special_tokens=True)
               for row, n in zip(sl["tokens"], sl["lengths"])]
    hists = [p + " " + r for p, r in zip(sl["prompts"], reports)]
    records = [{"dicom": str(j)} for j in range(len(hists))]

    def provider(dicoms):
        return embs[[int(d) for d in dicoms]]

    gt = np.random.default_rng(7).choice([np.nan, 1.0, 0.0, -1.0], size=(len(hists), 14))
    opts = ev.EvalOptions(use_embs=True)
    bin_ids = [tok(x)["input_ids"] for x in binary_qa_prompts(hists[0], CHEXPERT_COLS)]
    p0, img_in_prefix = pipe._shared_prefix_len(bin_ids, embs[:1].repeat(len(bin_ids), 1, 1))
    counted = {"q8_matmul": tq8.q8_matmul_int32,
               "flash_decode_int8": tfd.flash_decode_int8_kernel,
               "flash_attention": tfa.flash_attention_kernel}
    for fn in counted.values():
        fn.launches = 0
    seconds = {}

    def timed(name, fn):
        t0 = time.time()
        out = fn()
        torch.cuda.synchronize()
        seconds[name] = time.time() - t0
        return out

    binary = timed("binary_qa", lambda: ev.run_binary_qa_pass(
        pipe, records[:QA_STUDIES], hists[:QA_STUDIES], gt[:QA_STUDIES], opts, provider))
    k2_binary = tfd.flash_decode_int8_kernel.launches
    all_qa = timed("all_qa", lambda: ev.run_all_qa_pass(
        pipe, records[:ALL_QA_STUDIES], hists[:ALL_QA_STUDIES], gt[:ALL_QA_STUDIES], opts,
        provider))
    follow_prompt = all_qa_prompt(hists[0])
    follow = timed("follow_up_batch1", lambda: pipe.generate_texts(
        [follow_prompt], img_embs=embs[:1], max_new_tokens=FOLLOW_UP_NEW))
    labels = timed("label_reports", lambda: pipe.label_reports(reports[:LABELED]))
    launches = {name: fn.launches for name, fn in counted.items()}
    metrics = {**binary, **all_qa}
    values = labels[~np.isnan(labels)]
    ok = (launches["flash_attention"] == pipe.llama_cfg.num_layers * (QA_STUDIES + 1)
          and k2_binary > 0 and p0 >= 256 and img_in_prefix
          and all(np.isfinite(v) for v in metrics.values())
          and labels.shape == (LABELED, 14) and set(np.unique(values)) <= {-1.0, 0.0, 1.0}
          and follow[0].startswith(follow_prompt)
          and len(follow[0]) > len(follow_prompt))
    emit("qa", seconds=seconds, studies={"binary_qa": QA_STUDIES, "all_qa": ALL_QA_STUDIES,
                                         "labeled": LABELED},
         history_tokens=[len(tok(h)["input_ids"]) for h in hists[:ALL_QA_STUDIES]],
         binary_qa_prefix=p0, binary_qa_img_in_prefix=img_in_prefix,
         follow_up_prompt_tokens=len(tok(follow_prompt)["input_ids"]),
         follow_up_new_tokens=FOLLOW_UP_NEW, launches=launches,
         k2_launches_binary_qa=k2_binary, metric_keys=sorted(metrics), metrics=metrics,
         label_counts={str(v): int((labels == v).sum()) for v in (-1.0, 0.0, 1.0)},
         label_blank=int(np.isnan(labels).sum()), ok=ok)
    if not ok:
        raise AssertionError("the follow-up passes produced a malformed result")
    return launches


def _serve_requests(pipe, embs, n, seed):
    """n image prompts of 100-250 tokens (BOS included): words, the <IMG>
    run, words; each with one row of the pipeline's own image embeddings."""
    import numpy as np
    rng = np.random.default_rng(seed)
    img = pipe.llama_cfg.num_img_tokens
    out = []
    for j in range(n):
        total = int(rng.integers(100, 251))
        head = int(rng.integers(5, 40))
        text = (" ".join(f"c{j}h{i}" for i in range(head)) + " " + "<IMG> " * img
                + " ".join(f"c{j}w{i}" for i in range(total - 1 - head - img)))
        ids = pipe.tokenizer(text)["input_ids"]
        assert len(ids) == total, (len(ids), total)
        out.append((ids, embs[j % embs.shape[0]][None]))
    return out


def _serve_run(torch, counted, params, pipe, requests, new, clients, bad=None):
    """One server over ``params``: warm-up, then ``clients`` threads submit
    the requests (each streams its deltas) and, with ``bad``, one oversized
    prompt. Returns the numbers and whether every check held."""
    import threading
    from radialog_tpu_torch.apps.serve import RaDialogServer
    from radialog_tpu_torch.decode.continuous import _bucket32
    from radialog_tpu_torch.decode.engine import DecodeParams
    cfg = pipe.llama_cfg
    srv = RaDialogServer(params, cfg, lanes=LANES, cache_len=CACHE_LEN,
                         prompt_len=PROMPT_REGION,
                         dp=DecodeParams(max_new_tokens=new, eos_token_id=-1), lora=pipe.lora,
                         policy=pipe.policy, steps_per_call=CHUNK, kv_int8=True,
                         device=pipe.device)
    rb = srv._rb
    results, streamed, first_s, errors = {}, {}, {}, []
    try:
        warm_s = srv.warmup(prompt_buckets=(128, 256), timeout=600)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for fn in counted.values():
            fn.launches = 0
        ring0 = rb.ring_pos
        t0 = time.time()

        def client(c):
            try:
                futs = []
                for j in range(c, len(requests), clients):
                    ids, emb = requests[j]
                    streamed[j] = []
                    submitted = time.time()

                    def on_tokens(delta, done, j=j, submitted=submitted):
                        if delta and j not in first_s:
                            first_s[j] = time.time() - submitted
                        streamed[j].append((list(delta), done))
                    futs.append((j, srv.submit(ids, img_embs=emb, on_tokens=on_tokens)))
                for j, f in futs:
                    results[j] = f.result(timeout=900)
            except Exception as exc:   # reported by the caller, which fails the phase
                errors.append(repr(exc))

        threads = [threading.Thread(target=client, args=(c,)) for c in range(clients)]
        for t in threads:
            t.start()
        bad_error = None
        if bad is not None:
            try:
                srv.submit(bad).result(timeout=900)
            except ValueError as exc:
                bad_error = str(exc)
        for t in threads:
            t.join(timeout=900)
        torch.cuda.synchronize()
        seconds = time.time() - t0
    finally:
        srv.shutdown()
    steps = rb.ring_pos - ring0
    forwards = steps + len(requests)            # decode steps and batch-1 prefills
    launches = {name: fn.launches for name, fn in counted.items()}
    k3_prefills = sum(_bucket32(len(ids)) >= 256 for ids, _ in requests)
    firsts = sorted(first_s.values())
    ok = (not errors and not any(t.is_alive() for t in threads)
          and sorted(results) == list(range(len(requests)))
          and all(len(results[j]) == new for j in results)
          and all([x for d, _ in streamed[j] for x in d] == results[j]
                  and [done for _, done in streamed[j]].count(True) == 1
                  and streamed[j][-1][1] for j in results)
          and all(0 <= x < cfg.vocab_size for r in results.values() for x in r)
          and (bad is None or (bad_error is not None and "prompt region" in bad_error))
          and launches["flash_decode_int8"] == cfg.num_layers * steps
          and launches["flash_attention"] == cfg.num_layers * k3_prefills
          and len(firsts) == len(requests) and rb.active_lanes == 0 and not rb.finished)
    numbers = {"sessions": len(requests), "new_tokens": new, "clients": clients,
               "lanes": LANES, "prompt_region": PROMPT_REGION, "ring_len": rb.ring_len,
               "steps_per_call": CHUNK, "seconds": seconds, "warmup_s": warm_s,
               "tokens_per_s": len(requests) * new / seconds,
               "first_token_s_median": statistics.median(firsts) if firsts else None,
               "first_token_s_max": max(firsts) if firsts else None,
               "decode_steps": steps, "ms_per_decode_step_and_admissions": seconds / steps * 1e3,
               "ring_pos": rb.ring_pos, "prompt_tokens": [len(ids) for ids, _ in requests],
               "k3_prefills": k3_prefills, "launches": launches, "oversized_error": bad_error,
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "errors": errors}
    return numbers, ok, forwards


def phase_serve(torch, tq8, tfd, tfa, tq4, sl):
    """Interactive multi-session serving at Vicuna-7B width on the slice's
    weights and image embeddings, W8A8 and then W4A8 layers."""
    from radialog_tpu_torch.ops.quant import random_serving_params
    pipe, embs = sl["pipe"], sl["embs"]
    cfg = pipe.llama_cfg
    counted = {"q8_matmul": tq8.q8_matmul_int32, "flash_decode_int8": tfd.flash_decode_int8_kernel,
               "flash_attention": tfa.flash_attention_kernel, "q4_matmul": tq4.q4_matmul_acc}
    requests = _serve_requests(pipe, embs, SESSIONS, seed=11)
    bad = list(range(3, 3 + PROMPT_REGION + 44))        # 300 tokens: over the prompt region
    w8, ok8, forwards = _serve_run(torch, counted, pipe.llama, pipe, requests, SESSION_NEW,
                                   CLIENTS, bad=bad)
    per_forward = 4 * cfg.num_layers
    ok8 = (ok8 and w8["ring_pos"] > w8["ring_len"]
           and w8["launches"]["q8_matmul"] == (per_forward + 1) * forwards
           and w8["launches"]["q4_matmul"] == 0)
    emit("serve", weights="W8A8", ok=ok8, **w8)
    if not ok8:
        raise AssertionError("the full-width serve phase (W8A8) failed a check")
    t0 = time.time()
    gen = torch.Generator(device="cuda").manual_seed(12)
    params4 = random_serving_params(cfg, gen, bits=4)
    torch.cuda.synchronize()
    build_s = time.time() - t0
    w4, ok4, forwards = _serve_run(torch, counted, params4, pipe, requests[:W4_SESSIONS], W4_NEW,
                                   CLIENTS)
    ok4 = (ok4 and w4["launches"]["q4_matmul"] == per_forward * forwards
           and w4["launches"]["q8_matmul"] == forwards)
    emit("serve", weights="W4A8", ok=ok4, params_build_s=build_s, **w4)
    if not ok4:
        raise AssertionError("the full-width serve phase (W4A8) failed a check")
    return w8["launches"], w4["launches"]


def main() -> int:
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: torch is missing ({e})", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 2
    try:
        from radialog_tpu_torch.apps import pipeline as pipeline_mod
        from radialog_tpu_torch.decode import engine as te
        from radialog_tpu_torch.ops import _build
        from radialog_tpu_torch.ops import flash_attention as tfa
        from radialog_tpu_torch.ops import flash_decode as tfd
        from radialog_tpu_torch.ops import q4_matmul as tq4
        from radialog_tpu_torch.ops import q8_matmul as tq8
        from radialog_tpu_torch.ops.layers import set_precision
    except ImportError as e:
        print(f"chip_smoke: run from a checkout of the repository ({e})", file=sys.stderr)
        return 2

    card = smi()
    set_precision()
    t0 = time.time()
    reports = _build.build()
    regs = {n: [ln.strip() for ln in r.splitlines() if "registers" in ln or "spill" in ln]
            for n, r in reports.items()}
    emit("device", card=card, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__, cuda=torch.version.cuda,
         build_s=time.time() - t0, ptxas=regs)

    flush_buf = torch.empty(64 * 1024 * 1024, dtype=torch.uint8, device="cuda")

    def flush():
        flush_buf.zero_()

    k1 = phase_k1(torch, tq8, flush)
    k2, k2_ring = phase_k2(torch, tfd, flush)
    k3 = phase_k3(torch, tfa, flush)
    k4 = phase_k4(torch, tq4, flush)
    phase_small(torch, te, pipeline_mod, tq8, tfd, tfa, tq4)
    del flush_buf
    torch.cuda.empty_cache()
    launches, sl = phase_slice(torch, te, pipeline_mod, tq8, tfd)
    qa_launches = phase_qa(torch, tq8, tfd, tfa, sl)
    serve_launches, serve4_launches = phase_serve(torch, tq8, tfd, tfa, tq4, sl)

    kernels = [
        {"name": "q8_matmul", "route": "cuda", "source": "radialog_tpu_torch/csrc/q8_matmul.cu",
         "replaces": "radialog_tpu/ops/q8_matmul.py:102", "launches": launches["q8_matmul"],
         "max_abs_err": k1["max_abs_err"], "ms": k1["ms"], "plain_ms": k1["plain_ms"],
         "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"],
         "library_ms": k1["library_ms"], "ms_m16": k1["ms_m16"],
         "bound_ms_m16": k1["bound_ms_m16"],
         "work": "one decoder layer's 4 projections at decode, M=56 (report batch); "
                 "ms_m16 and bound_ms_m16: the same at the serve phase's 16 lanes"},
        {"name": "flash_decode_int8", "route": "cuda",
         "source": "radialog_tpu_torch/csrc/flash_decode.cu",
         "replaces": "radialog_tpu/ops/flash_decode.py:128",
         "launches": launches["flash_decode_int8"], "max_abs_err": k2["max_abs_err"],
         "ms": k2["ms"], "plain_ms": k2["plain_ms"], "bound_ms": k2["bound_ms"],
         "bound_by": k2["bound_by"], "library_ms": None,
         "work": "one layer at decode step 150, B=56, S=384, P0=48"},
        {"name": "flash_decode_int8_intervals", "route": "cuda",
         "source": "radialog_tpu_torch/csrc/flash_decode.cu",
         "replaces": "radialog_tpu/ops/flash_decode.py:521",
         "launches": serve_launches["flash_decode_int8"],
         "max_abs_err": k2_ring["max_abs_err"], "ms": k2_ring["ms"],
         "plain_ms": k2_ring["plain_ms"], "bound_ms": k2_ring["bound_ms"],
         "bound_by": k2_ring["bound_by"], "library_ms": None,
         "work": "one layer, the ring's per-lane slot intervals, no prefix, B=16, S=384, "
                 "prompts of 100-256 rows; launches of the serve phase (W8A8)"},
        {"name": "flash_attention", "route": "cuda",
         "source": "radialog_tpu_torch/csrc/flash_attention.cu",
         "replaces": "radialog_tpu/ops/flash_attention.py:44",
         "launches": qa_launches["flash_attention"], "max_abs_err": k3["max_abs_err"],
         "ms": k3["ms"], "plain_ms": k3["plain_ms"], "bound_ms": k3["bound_ms"],
         "bound_by": k3["bound_by"], "library_ms": k3["library_ms"],
         "work": "one layer's binary-QA prefix attention, B=1, T=S=431, H=32, D=128, bf16, "
                 "causal, q/k/v views of the fused projection; launches of the qa phase"},
        {"name": "q4_matmul", "route": "cuda", "source": "radialog_tpu_torch/csrc/q4_matmul.cu",
         "replaces": "radialog_tpu/ops/q4_matmul.py:177",
         "launches": serve4_launches["q4_matmul"], "max_abs_err": k4["max_abs_err"],
         "ms": k4["ms"], "plain_ms": k4["plain_ms"], "bound_ms": k4["bound_ms"],
         "bound_by": k4["bound_by"], "library_ms": None,
         "work": "one decoder layer's 4 projections at decode, M=16, asymmetric grid; "
                 "launches of the serve phase (W4A8)"},
    ]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
