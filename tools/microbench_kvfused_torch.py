#!/usr/bin/env python3
"""One interleaved k|v buffer against two for the int8 flash-decode kernel,
on one GPU (the PyTorch port of tools/microbench_kvfused.py).

  A: K2 (csrc/flash_decode.cu) over the four cache operands (k8, ks, v8,
     vs), --layers chained layer calls, as a decode step's attention runs;
  B: T1, the same kernel over one (L, B, S, 2*H*D) int8 buffer holding k
     then v in each row and one (L, B, S, 2*H) bf16 scale buffer, same
     calls.

Same bytes, same arithmetic, same blocks in the same order, so B must equal
A bit for bit: that is checked first. The question the TPU tool asked (one
DMA descriptor fewer per grid step) has no GPU meaning; here it is whether
one interleaved buffer reads faster than two. Both chains are timed with
CUDA events over --reps chains after a warm-up, queued back to back (the
host's time to queue each layer call shows in it), then read with
torch.profiler over 3 chains: the card's busy time per chain and the
kernel's own. The TPU tool's lane grouping (--gl) is a TPU layout and is
gone.

Prints one JSON line: the tool's keys (less gl), the byte bound of one
chain, and the card's name and power limit. ``--device cpu`` runs the plain
versions at whatever shape is given, a check of the tool itself with no
timing (no number of a CPU run is a card's).

Usage: python3 tools/microbench_kvfused_torch.py [--batch 56] [--cache 384]
       [--step 150] [--prompt-pad 128] [--bs 64] [--layers 8] [--reps 30]
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM (NVIDIA data sheet)


def card_name() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"


def device_ms(torch, run, n: int = 3):
    """The card's own time for run(), from torch.profiler over n runs: (busy
    ms per run, ms per run of the flash-decode lane kernel)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            run()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / n
    lane = sum(e.time_range.elapsed_us() for e in kernels if "lane_kernel" in e.name) / 1e3 / n
    return busy, lane


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=56)
    ap.add_argument("--cache", type=int, default=384)
    ap.add_argument("--heads", type=int, default=32)
    ap.add_argument("--head-dim", type=int, default=128)
    ap.add_argument("--layers", type=int, default=8, help="chained layer calls per chain")
    ap.add_argument("--step", type=int, default=150,
                    help="decode step: the generated rows end at prompt-pad + step")
    ap.add_argument("--prompt-pad", type=int, default=128)
    ap.add_argument("--bs", type=int, default=64)
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    import torch
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("microbench_kvfused_torch: no CUDA device", file=sys.stderr)
        return 2
    from radialog_tpu_torch.ops import flash_decode as tfd

    b, s_len, h, d, n_layers = args.batch, args.cache, args.heads, args.head_dim, args.layers
    pp, st, bs = args.prompt_pad, args.step, args.bs
    g = torch.Generator(device=dev).manual_seed(0)
    shape = (n_layers, b, s_len, h * d)
    k8 = torch.randint(-127, 128, shape, generator=g, device=dev, dtype=torch.int8)
    v8 = torch.randint(-127, 128, shape, generator=g, device=dev, dtype=torch.int8)
    ks = (torch.rand(shape[:3] + (h,), generator=g, device=dev) * 0.02).to(torch.bfloat16)
    vs = (torch.rand(shape[:3] + (h,), generator=g, device=dev) * 0.02).to(torch.bfloat16)
    qs = torch.randn((n_layers, b, h, d), generator=g, device=dev)
    lengths = torch.full((b,), pp, dtype=torch.int32, device=dev)
    kv8 = torch.cat([k8, v8], dim=-1)                   # (L, B, S, 2*H*D): k | v
    kvs = torch.cat([ks, vs], dim=-1)                   # (L, B, S, 2*H)

    def chain_a():
        acc = torch.zeros((b, h, d), device=dev)
        for i in range(n_layers):
            acc += tfd.flash_decode_int8(qs[i], k8, ks, v8, vs, lengths, pp, st, layer_idx=i,
                                         bs=bs)
        return acc

    def chain_b():
        acc = torch.zeros((b, h, d), device=dev)
        for i in range(n_layers):
            acc += tfd.flash_decode_int8_fused(qs[i], kv8, kvs, lengths, pp, st, layer_idx=i,
                                               bs=bs)
        return acc

    # correctness: fused == four operands, bitwise, every layer
    bitwise = torch.equal(chain_a(), chain_b())
    if not bitwise:
        print("microbench_kvfused_torch: the fused kernel differs from the four-operand one",
              file=sys.stderr)
        return 1

    def bench(fn) -> float:
        for _ in range(4):
            fn()
        torch.cuda.synchronize()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(args.reps):
            fn()
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / args.reps

    live = min(pp + st + 1, s_len)                      # rows of each lane the mask reads
    bound_ms = (n_layers * b * live * (2 * h * d + 4 * h) / HBM_BYTES_PER_S * 1e3
                if dev.type == "cuda" else None)
    out = {"batch": b, "cache": s_len, "step": st, "prompt_pad": pp, "bs": bs,
           "layers": n_layers, "reps": args.reps, "bitwise": bitwise, "device": dev.type}
    if dev.type == "cuda":
        ms_a, ms_b = bench(chain_a), bench(chain_b)
        ms_a2, ms_b2 = bench(chain_a), bench(chain_b)   # A B A B: drift shows
        (busy_a, lane_a), (busy_b, lane_b) = device_ms(torch, chain_a), device_ms(torch, chain_b)
        out.update(ms_4operand=ms_a, ms_fused=ms_b, ms_4operand_again=ms_a2,
                   ms_fused_again=ms_b2, delta_ms=ms_a - ms_b,
                   delta_pct=(ms_a - ms_b) / ms_a * 100,
                   device_busy_ms_4operand=busy_a, device_busy_ms_fused=busy_b,
                   kernel_ms_4operand=lane_a, kernel_ms_fused=lane_b, bound_ms=bound_ms,
                   launches={"k2": tfd.flash_decode_int8_kernel.launches,
                             "t1": tfd.flash_decode_int8_fused_kernel.launches},
                   card=card_name(), kind=torch.cuda.get_device_name(0))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
