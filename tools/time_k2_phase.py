#!/usr/bin/env python3
"""Run chip_smoke.py's phase k2 (int8 flash-decode: K2, K2', K2'') of one or
more checkouts of the repository on one card, each in a process of its own,
in the order given, so that two commits can be compared in one call:

    python3 tools/time_k2_phase.py PARENT_DIR . . PARENT_DIR

Each checkout builds its own csrc/flash_decode.cu into its own build/
directory. Every output line of the phase is printed as JSON with the
checkout's directory under "root"; the card's name and power limit come
first. After the phase, the floor of a call at the report shape: every lane
without a valid slot, so that no cache row is read, with the 48-row shared
prefix (two launches) and without (one), beside an empty pair of CUDA
events. Needs a CUDA card and nvcc.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys


def floor(torch, chip_smoke, tfd, flush) -> None:
    """Time K2 at the report shape (B=56, H=32, D=128, S=384) with no valid
    slot in any lane."""
    b, h, d, s, p0 = 56, 32, 128, 384, 48
    g = torch.Generator(device="cuda").manual_seed(0)
    k8 = torch.randint(-127, 128, (1, b, s, h * d), generator=g, device="cuda", dtype=torch.int8)
    ks = torch.full((1, b, s, h), 0.01, device="cuda", dtype=torch.bfloat16)
    pre = (k8[0, 0, :p0].clone(), ks[0, 0, :p0].clone(), k8[0, 1, :p0].clone(),
           ks[0, 1, :p0].clone())
    q8, qs = tfd.quantize_q(torch.randn((b, h, d), generator=g, device="cuda"))
    zero = torch.zeros(b, dtype=torch.int32, device="cuda")
    empty = torch.full((b,), -1, dtype=torch.int32, device="cuda")
    args = (q8, qs, k8, ks, k8, ks, (zero, zero, empty, zero, empty), 0, d ** -0.5, 64)
    read = torch.zeros(16 * 1024 * 1024, device="cuda")
    row = {"floor": "no valid slot, B=56, H=32, D=128, S=384",
           "empty_event_ms": chip_smoke.timed_ms(lambda: None, 20, flush)}
    for name, kw in (("prefix48", dict(shared=pre, p0=p0)), ("no_prefix", {})):
        def fn():
            return tfd.flash_decode_int8_kernel(*args, **kw)
        row[f"{name}_ms"] = chip_smoke.timed_ms(fn, 20, flush)
        row[f"{name}_read_flush_ms"] = chip_smoke.timed_ms(fn, 20, read.amax)
        row[f"{name}_lane_device_ms"] = chip_smoke._device_ms(torch, fn, flush, "lane_kernel")
    print(json.dumps(row), flush=True)


def run_one(root: str) -> int:
    """Phase k2 of the checkout at ``root``, in this process."""
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    os.chdir(root)
    import torch

    import chip_smoke
    from radialog_tpu_torch.ops import _build
    from radialog_tpu_torch.ops import flash_decode as tfd
    from radialog_tpu_torch.ops.layers import set_precision

    if not torch.cuda.is_available():
        print("time_k2_phase: no CUDA device", file=sys.stderr)
        return 2
    set_precision()
    _build.build(["flash_decode"])
    flush_buf = torch.empty(64 * 1024 * 1024, dtype=torch.uint8, device="cuda")

    def flush():
        flush_buf.zero_()

    warm = torch.randn((8192, 8192), device="cuda", dtype=torch.bfloat16)
    chip_smoke.timed_ms(lambda: warm @ warm, 50, flush)   # the process's first timed run is slow
    del warm
    chip_smoke.phase_k2(torch, tfd, flush)
    floor(torch, chip_smoke, tfd, flush)
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
            print(f"time_k2_phase: {root} failed (rc {proc.returncode}):\n{proc.stderr[-4000:]}",
                  file=sys.stderr, flush=True)
            rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main())
