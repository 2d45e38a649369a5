#!/usr/bin/env python3
"""W4A8 against W8A8 at decode, on one GPU (the PyTorch port of
tools/microbench_w4.py).

Variants, each one decoder layer's four Vicuna-7B projections (wqkv, wo,
gateup, down) chained over 32 layers with a data dependence, as the TPU
tool chains them (x = bf16(x + 0.001 * (wo-out + down-out))):

  w8   K1 (csrc/q8_matmul.cu): per-channel int8 weights, the serving default
  w4   T2 (csrc/w4_colscale.cu): per-column int4, activations split into
       their even and odd K values
  w4g  K4 (csrc/q4_matmul.cu): grouped int4 (groups of 512, asymmetric grid),
       the serving layers' 4-bit mode
  w4p  T3 (csrc/w4_colscale.cu): per-column int4, whole activation rows
  w4x  torch._int_mm on the int4 codes widened to int8 (the TPU tool's
       XLA-native int4): the library yardstick, used nowhere in the port

T2 and T3 are one design, K1's swapped decode route over packed nibbles:
a TMA ring of 64 (or 128) weight rows x 256 K values a stage, the nibbles
unpacked in registers into the A operand of an int8 wgmma whose N is the
activation rows, K split across blocks for wo and down (ops/w4_colscale.py
_plan).

Weights are made on the card from a seeded generator (the TPU tool packs
float weights on the host, ~26 GB of RAM at 32 layers); ``--layers``
distinct layers are cycled to 32. First the tool's correctness spot check:
w4 and w4p against a float matmul of one (hidden, hidden) weight packed by
``pack_q4c``, largest error over the largest value < 0.2 (int4 weights and
int8 activations). Then each variant is timed with CUDA events over
``--iters`` chains after a warm-up (``ms_per_chain``: the chains queued
back to back, so the host's time to queue ~10 PyTorch calls a projection
shows in it), and the card's own time is read from torch.profiler over 3
chains (``device_busy_ms_per_chain``, and the four kernels that took most
of it). One JSON line per variant: those times, the weight bytes read per
chain, the byte bound and the card's name and power limit. ``--device cpu``
runs the plain versions at whatever shape is given, a check of the tool
itself with no timing.

Usage: python3 tools/microbench_w4_torch.py [--variants w8,w4,w4g,w4p,w4x]
       [--m 32] [--layers 4] [--iters 10] [--hidden 4096] [--inter 11008]
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

NUM_LAYERS = 32
HBM_BYTES_PER_S = 3.35e12      # H100 SXM (NVIDIA data sheet)
VARIANTS = ("w8", "w4", "w4g", "w4p", "w4x")


def card_name() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"


def device_ms(torch, run, n: int = 3):
    """The card's own time for run(), from torch.profiler over n runs: (busy
    ms per run, {kernel: ms per run} of the four that took most of it)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            run()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name[:60]] = by_name.get(e.name[:60], 0.0) + e.time_range.elapsed_us() / 1e3
    top = sorted(by_name, key=by_name.get, reverse=True)[:4]
    return sum(by_name.values()) / n, {name: by_name[name] / n for name in top}


def layer_shapes(hidden: int, inter: int):
    """(K, N) of the fused serving layout's four projections."""
    return {"wqkv": (hidden, 3 * hidden), "wo": (hidden, hidden),
            "gateup": (hidden, 2 * inter), "down": (inter, hidden)}


def make_weight(torch, variant: str, k: int, n: int, gen, dev):
    """One random weight of ``variant``, made on ``dev``; and its bytes."""
    from radialog_tpu_torch.ops import q4_matmul as tq4
    from radialog_tpu_torch.ops.q8_matmul import PackedQ8
    from radialog_tpu_torch.ops.w4_colscale import random_q4c
    if variant == "w8":
        w = PackedQ8(torch.randint(-127, 128, (n, k), generator=gen, device=dev,
                                   dtype=torch.int8),
                     (torch.rand((n,), generator=gen, device=dev) + 0.5) * (0.06 / 127))
        return w, n * k + 4 * n
    if variant in ("w4", "w4p"):
        return random_q4c(k, n, gen, dev), n * k // 2 + 4 * n
    if variant == "w4g":
        bk = tq4.pick_bk(k)
        group = tq4.GROUP if bk % tq4.GROUP == 0 else bk
        groups = -(-k // bk) * bk // group
        gscale = (torch.rand((groups, n), generator=gen, device=dev) + 0.5) * (0.06 / 15)
        goff = (torch.rand((groups, n), generator=gen, device=dev) - 0.5) * gscale
        w = tq4.PackedQ4(torch.randint(-128, 128, (n, k // 2), generator=gen, device=dev,
                                       dtype=torch.int8), gscale, group, goff)
        return w, n * k // 2 + 8 * groups * n
    codes = torch.randint(-7, 8, (n, k), generator=gen, device=dev, dtype=torch.int8)
    scale = (torch.rand((n,), generator=gen, device=dev) + 0.5) * (0.06 / 7)
    return {"codes": codes, "scale": scale}, n * k + 4 * n


def matmul(torch, variant: str, x, w):
    """(M, K) bf16 x one weight of ``variant`` -> (M, N) bf16."""
    from radialog_tpu_torch.ops.q4_matmul import q4_matmul
    from radialog_tpu_torch.ops.q8_matmul import q8_matmul, quantize_act
    from radialog_tpu_torch.ops.w4_colscale import q4c_matmul
    if variant == "w8":
        return q8_matmul(x, w, out_dtype=torch.bfloat16)
    if variant in ("w4", "w4p"):
        return q4c_matmul(x, w, variant)
    if variant == "w4g":
        return q4_matmul(x, w, out_dtype=torch.bfloat16)
    x8, xs = quantize_act(x)
    acc = torch._int_mm(x8, w["codes"].t())
    return (acc.float() * xs[:, None] * w["scale"][None, :]).to(torch.bfloat16)


def chain(torch, variant: str, x, layers, hidden: int, inter: int):
    for lyr in layers:
        a = matmul(torch, variant, x, lyr["wqkv"])
        b = matmul(torch, variant, a[:, :hidden], lyr["wo"])
        c = matmul(torch, variant, x, lyr["gateup"])
        d = matmul(torch, variant, c[:, :inter], lyr["down"])
        x = (x + 0.001 * (b + d)).to(torch.bfloat16)
    return x.float().sum()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default="w8,w4")
    ap.add_argument("--m", type=int, default=32)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--layers", type=int, default=NUM_LAYERS,
                    help="distinct layers to make; the chain cycles them to 32")
    ap.add_argument("--hidden", type=int, default=4096)
    ap.add_argument("--inter", type=int, default=11008)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    variants = args.variants.split(",")
    if not set(variants) <= set(VARIANTS):
        ap.error(f"variants are {VARIANTS}")

    import torch
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("microbench_w4_torch: no CUDA device", file=sys.stderr)
        return 2
    from radialog_tpu_torch.ops.w4_colscale import pack_q4c, q4c_matmul
    card = card_name() if dev.type == "cuda" else None
    gen = torch.Generator(device=dev).manual_seed(0)
    x0 = torch.randn((args.m, args.hidden), generator=gen, device=dev).to(torch.bfloat16)

    # correctness spot check: int4 per-column weights against the float product
    w = torch.randn((args.hidden, args.hidden), generator=gen, device=dev) * 0.02
    ref = x0.float() @ w
    packed = pack_q4c(w)
    check = {}
    for name in ("w4", "w4p"):
        if name in variants:
            got = q4c_matmul(x0, packed, name, out_dtype=torch.float32)
            check[name] = float((got - ref).abs().max() / ref.abs().max())
    print(json.dumps({"check": "int4 per-column weights and int8 activations against the "
                               "float product, largest error over the largest value",
                      "max_rel_err": check, "limit": 0.2}), flush=True)
    if any(e >= 0.2 for e in check.values()):
        return 1
    del w, ref, packed

    reps = -(-NUM_LAYERS // args.layers)
    ok = True
    for variant in variants:
        distinct, nbytes = [], 0
        for _ in range(args.layers):
            lyr = {}
            for name, (k, n) in layer_shapes(args.hidden, args.inter).items():
                lyr[name], size = make_weight(torch, variant, k, n, gen, dev)
                nbytes += size
            distinct.append(lyr)
        layers = (distinct * reps)[:NUM_LAYERS]
        chain_bytes = nbytes * len(layers) // len(distinct)
        out = chain(torch, variant, x0, layers, args.hidden, args.inter)
        line = {"variant": variant, "m": args.m, "layers": len(layers),
                "distinct_layers": len(distinct), "weight_bytes_per_chain": chain_bytes,
                "finite": bool(torch.isfinite(out)), "device": dev.type}
        ok = ok and line["finite"]
        if dev.type == "cuda":
            for _ in range(2):
                chain(torch, variant, x0, layers, args.hidden, args.inter)
            torch.cuda.synchronize()
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(args.iters):
                chain(torch, variant, x0, layers, args.hidden, args.inter)
            e1.record()
            torch.cuda.synchronize()
            ms = e0.elapsed_time(e1) / args.iters
            busy, top = device_ms(
                torch, lambda: chain(torch, variant, x0, layers, args.hidden, args.inter))
            line.update(ms_per_chain=ms, device_busy_ms_per_chain=busy,
                        top_kernels_ms_per_chain=top, gb_per_s=chain_bytes / ms / 1e6,
                        bound_ms=chain_bytes / HBM_BYTES_PER_S * 1e3, iters=args.iters,
                        card=card, kind=torch.cuda.get_device_name(0))
        print(json.dumps(line), flush=True)
        del distinct, layers
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
