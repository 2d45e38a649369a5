#!/usr/bin/env python3
"""Run chip_smoke.py's phase k4 (the grouped W4A8 GEMM, K4) of one or more
checkouts of the repository on one card, each in a process of its own, in
the order given, so that two commits can be compared in one call:

    python3 tools/time_k4_phase.py PARENT_DIR . . PARENT_DIR

Each checkout builds its own csrc/q4_matmul.cu into its own build/
directory. Every output line is printed as JSON with the checkout's
directory under "root"; the card's name and power limit come first. After
the phase, every Vicuna-7B projection at M = 16, 56 and 256 on the
asymmetric grid again: CUDA events, the kernel on the card's clock
(torch.profiler, kernels whose name holds "q4_"), the bound, and the launch
plan where the checkout has one (ops/q4_matmul.py ``_plan``); then, where
the checkout has them, the plan beside the other configurations of the same
kernel: no K split, K split 2, 3, 4 or 8 ways where the plan splits, 64 and
128 weight rows a block; the call also with the L2 flushed by a read; and
T3 (ops/w4_colscale.py, K4's mainloop without the groups) on the same codes.
Needs a CUDA card and nvcc.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys

SHAPES = {"wqkv": (4096, 12288), "wo": (4096, 4096), "gateup": (4096, 22016),
          "down": (11008, 4096)}


def bound_ms(chip_smoke, m, k, n, groups):
    """(ms, what bounds it): the activations, packed weight, scales, offsets
    and f32 output moved once, against 2 M N K int8 operations."""
    b_bytes = (m * k + n * k // 2 + 8 * groups * n + 4 * m * n) / chip_smoke.HBM_BYTES_PER_S * 1e3
    b_ops = 2 * m * n * k / chip_smoke.INT8_OPS_PER_S * 1e3
    return max(b_bytes, b_ops), "bytes" if b_bytes >= b_ops else "operations"


def shapes(torch, chip_smoke, tq4, flush) -> None:
    """Each projection by CUDA events and on the card's clock, beside its
    bound and plan; the layer sums; then the other configurations."""
    from radialog_tpu_torch.ops import w4_colscale as tw
    g = torch.Generator(device="cuda").manual_seed(10)
    read = torch.zeros(16 * 1024 * 1024, device="cuda")
    sums = {}
    for name, (k, n) in SHAPES.items():
        groups = -(-k // tq4.pick_bk(k)) * tq4.pick_bk(k) // tq4.GROUP
        w = torch.randint(-128, 128, (n, k // 2), generator=g, device="cuda", dtype=torch.int8)
        gscale = (torch.rand((groups, n), generator=g, device="cuda") + 0.5) / (4.6 * k ** 0.5)
        goff = (torch.rand((groups, n), generator=g, device="cuda") - 0.5) * gscale
        for m in (16, 56, 256):
            x8 = torch.randint(-127, 128, (m, k), generator=g, device="cuda", dtype=torch.int8)
            ref = tq4.q4_matmul_acc_plain(x8, w, gscale, goff, tq4.GROUP)
            configs = {"call": None}
            if hasattr(tq4, "_plan"):
                plan = tq4._plan(m, n, k, tq4.GROUP, True)
                ktiles = -(-k // tq4.KTILE)
                configs["nosplit"] = dataclasses.replace(plan, splits=1, per=ktiles)
                unit = tq4.group_stages(tq4.GROUP)
                for splits in (2, 3, 4, 8):     # K split s ways, on group boundaries
                    per = -(-(-(-ktiles // splits)) // unit) * unit
                    if plan.splits > 1 and per < ktiles:
                        configs[f"splits{splits}"] = dataclasses.replace(
                            plan, splits=-(-ktiles // per), per=per)
                configs["rows64"] = tq4._plan(m, n, k, tq4.GROUP, True, rows=64)
                if plan.wn <= 32:
                    configs["rows128"] = tq4._plan(m, n, k, tq4.GROUP, True, rows=128)
            bound, by = bound_ms(chip_smoke, m, k, n, groups)
            for cfg, plan in configs.items():
                def fn(plan=plan):
                    if plan is None:
                        return tq4.q4_matmul_acc(x8, w, gscale, goff, tq4.GROUP)
                    return tq4._launch(x8, w, gscale, goff, tq4.GROUP, plan)
                out = fn()
                torch.cuda.synchronize()
                if not torch.equal(out, ref):
                    raise AssertionError(f"K4 {name} M={m} {cfg}: differs from plain")
                ms = chip_smoke.timed_ms(fn, 20, flush)
                dev = chip_smoke._device_ms(torch, fn, flush, "q4_")
                row = {"weight": name, "m": m, "k": k, "n": n, "config": cfg, "bitwise": True,
                       "kernel_ms": ms, "device_ms": dev, "bound_ms": bound, "bound_by": by}
                if cfg == "call":   # the L2 flushed by a read: no dirty lines to write back
                    row["read_flush_ms"] = chip_smoke.timed_ms(fn, 20, read.amax)
                if hasattr(tq4, "_plan"):
                    row["plan"] = dataclasses.asdict(plan or tq4._plan(m, n, k, tq4.GROUP, True))
                print(json.dumps(row), flush=True)
                x = sums.setdefault((m, cfg), {"kernel_ms": 0.0, "device_ms": 0.0,
                                               "bound_ms": 0.0})
                x["kernel_ms"] += ms
                x["device_ms"] += dev
                x["bound_ms"] += bound
            # T3 (per-column W4A8, exact int32) on the same codes and rows: K4's
            # mainloop without the groups, the row sums and the f32 epilogue
            def t3():
                return tw.w4_int32(x8, w)
            t3_ms = chip_smoke.timed_ms(t3, 20, flush)
            t3_dev = chip_smoke._device_ms(torch, t3, flush, "w4_tma_kernel")
            print(json.dumps({"weight": name, "m": m, "config": "T3", "kernel_ms": t3_ms,
                              "device_ms": t3_dev}), flush=True)
            x = sums.setdefault((m, "T3"), {"kernel_ms": 0.0, "device_ms": 0.0, "bound_ms": 0.0})
            x["kernel_ms"] += t3_ms
            x["device_ms"] += t3_dev
        del w
    for (m, cfg), x in sums.items():
        print(json.dumps({"layer_sum": f"one layer's 4 projections at M={m}, asym",
                          "config": cfg, **x}), flush=True)


def run_one(root: str) -> int:
    """Phase k4 of the checkout at ``root``, then ``shapes``, in this process."""
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    os.chdir(root)
    import torch

    import chip_smoke
    from radialog_tpu_torch.ops import _build
    from radialog_tpu_torch.ops import q4_matmul as tq4
    from radialog_tpu_torch.ops.layers import set_precision

    if not torch.cuda.is_available():
        print("time_k4_phase: no CUDA device", file=sys.stderr)
        return 2
    set_precision()
    print(json.dumps({"ptxas": [ln.strip() for ln in _build.build(["q4_matmul"])["q4_matmul"]
                                .splitlines() if "registers" in ln or "spill" in ln]}),
          flush=True)
    flush_buf = torch.empty(64 * 1024 * 1024, dtype=torch.uint8, device="cuda")

    def flush():
        flush_buf.zero_()

    warm = torch.randn((8192, 8192), device="cuda", dtype=torch.bfloat16)
    chip_smoke.timed_ms(lambda: warm @ warm, 50, flush)   # the process's first timed run is slow
    del warm
    chip_smoke.phase_k4(torch, tq4, flush)
    shapes(torch, chip_smoke, tq4, flush)
    return 0


def main() -> int:
    args = sys.argv[1:]
    if len(args) == 2 and args[0] == "--one":
        return run_one(args[1])
    if not args:
        print(__doc__, file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    print(json.dumps({"card": card}), flush=True)
    rc = 0
    for root in args:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", root],
                              capture_output=True, text=True, timeout=900)
        for line in proc.stdout.splitlines():
            try:
                row = json.loads(line)
            except json.JSONDecodeError:
                continue
            print(json.dumps({"root": root, **row}), flush=True)
        if proc.returncode != 0:
            print(f"time_k4_phase: {root} failed (rc {proc.returncode}):\n{proc.stderr[-4000:]}",
                  file=sys.stderr, flush=True)
            rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main())
