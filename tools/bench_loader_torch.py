#!/usr/bin/env python3
"""The host input pipeline's feed rate in the PyTorch port: the C++
libjpeg pool against PIL (the port of tools/bench_loader.py).

``--n`` synthetic ``--size`` px JPEGs are written once (in a temporary
directory removed at the end), then each route is timed, one warm-up pass
and ``--repeat`` timed passes, keeping the best:

  pil_loop            one file at a time through PIL: ``ops/image.py``
                      decode, then the numpy resize 512 / crop 448 /
                      normalize
  native_single       ``native/loader.py preprocess_file``, the C++ call
  native_pool_t{1,2,4}  ``CxrLoader``'s C++ pool at 1, 2 and 4 threads
  stage1_iterator     ``data/prefetch.py stage1_raw_batches`` (the pool,
                      caption tokenization and padding) through
                      ``DevicePrefetcher`` onto ``--device``: the stage-1
                      feed as the trainer takes it

Where the native build is unavailable (g++ or libjpeg missing: the card's
machine has no libjpeg), the C++ rows give way to the JAX tool's
``{"mode": "native", "images_s": null, ...}`` line, and ``CxrLoader`` runs
its PIL route at 1, 2 and 4 threads instead (``pil_pool_t*``). That is a
host path, reported as such, not a hidden fallback of a device path.

The header says how many cores the process may use. Rows: the JAX tool's
keys, ``device`` (the card's name and power limit; the rows are host rates,
the card only receives the stage-1 batches) and ``runs_s`` (each timed
pass's seconds; empty in the header). ``device_rate_to_beat`` is the
card's own stage-1 rate at batch 32 (``chip_smoke.py`` stage1, PERF.md).

Usage: python3 tools/bench_loader_torch.py [--n 128] [--repeat 2]
       [--size 512] [--device cuda]
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from tools.bench_torch import clock, device_label, open_device  # noqa: E402

# chip_smoke.py stage1 at batch 32, 448 px, BF16 (NVIDIA H100 80GB HBM3,
# 700.00 W; PERF.md section 5)
DEVICE_RATE = "60.3 img/s (stage-1 b32, NVIDIA H100 80GB HBM3 700 W, chip_smoke.py stage1)"


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=128)
    ap.add_argument("--repeat", type=int, default=2)
    ap.add_argument("--size", type=int, default=512, help="source jpeg side")
    ap.add_argument("--device", default="cuda",
                    help="where the stage-1 iterator row stages its batches")
    return ap


def run(args, device) -> List[Dict]:
    from PIL import Image
    from radialog_tpu_torch.apps.tokenization import WhitespaceTokenizer
    from radialog_tpu_torch.data.prefetch import DevicePrefetcher, stage1_raw_batches
    from radialog_tpu_torch.native.loader import CxrLoader, native_available, preprocess_file
    from radialog_tpu_torch.ops.image import load_image_grayscale, preprocess_cxr_np
    from tools.bench_pipeline_torch import CAPTIONS, _Records

    rng = np.random.default_rng(0)
    tmp = tempfile.mkdtemp(prefix="cxr_bench_")
    label = device_label(device)
    try:
        paths = []
        for i in range(args.n):
            arr = (rng.random((args.size, args.size)) * 255).astype(np.uint8)
            p = os.path.join(tmp, f"img_{i:04d}.jpg")
            Image.fromarray(arr).save(p, quality=92)
            paths.append(p)

        def timed(fn):
            fn()                                # warm (page cache, library init)
            secs = []
            for _ in range(args.repeat):
                t0 = clock(device)
                fn()
                secs.append(clock(device) - t0)
            return {"images_s": round(args.n / min(secs), 1), "device": label,
                    "runs_s": [round(x, 4) for x in secs]}

        def pil_loop():
            for p in paths:
                preprocess_cxr_np(load_image_grayscale(p), resize=512, crop=448)

        def pool(threads):
            def go():
                with CxrLoader(paths, batch=32, resize=512, crop=448, threads=threads) as ld:
                    for _ in ld.epoch(seed=0):
                        pass
            return go

        recs = [{"img_path": p, "text_output": CAPTIONS[i % len(CAPTIONS)]}
                for i, p in enumerate(paths)]
        tok = WhitespaceTokenizer(vocab_size=30523)

        def stage1_iterator():
            with DevicePrefetcher(stage1_raw_batches(_Records(recs), tok, 128, 32, sub_epoch=0,
                                                     threads=4, drop_last=False),
                                  depth=2, device=device) as pf:
                for _ in pf:
                    pass

        rows = [{"mode": "pil_loop", **timed(pil_loop)}]
        native = native_available()
        if native:
            def native_loop():
                for p in paths:
                    preprocess_file(p, resize=512, crop=448)
            rows.append({"mode": "native_single", **timed(native_loop)})
        else:
            rows.append({"mode": "native", "images_s": None, "note": "native build unavailable",
                         "device": label, "runs_s": []})
        for threads in (1, 2, 4):
            rows.append({"mode": f"{'native' if native else 'pil'}_pool_t{threads}",
                         **timed(pool(threads))})
        rows.append({"mode": "stage1_iterator", **timed(stage1_iterator)})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    head = {"n": args.n, "jpeg_side": args.size, "host_cores": len(os.sched_getaffinity(0)),
            "device_rate_to_beat": DEVICE_RATE, "device": label, "runs_s": []}
    for line in [head] + rows:
        print(json.dumps(line), flush=True)
    return [head] + rows


def main(argv: Optional[List[str]] = None) -> List[Dict]:
    args = build_parser().parse_args(argv)
    return run(args, open_device(args.device))


if __name__ == "__main__":
    main()
