#!/usr/bin/env python3
"""Runs one cell of the port's benchmark once, on the card it starts on.

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

The cell (``workloads`` in BENCHMARK.json at the checkout's root) joins a
configuration (``benchmark/configs/<config>.json``: the model's widths, the
served path, the reference's precision), a traffic mix
(``benchmark/traffic/<traffic>.json``: its driver, ``benchmark/drivers/
<driver>.py``, and the mix's parameters) and the limits of its correctness
check (``benchmark/limits/<workload>.json``). Each per-layer metric is read
by ``benchmark/metrics/<metric>.py``. Adding a cell, a mix or a metric adds
files; none here changes.

A run: set-up (imports, weights made on the card from the seed, the port's
packing, a warm-up at the cell's own shapes; ``setup_s``), the measured
window of ``--seconds``, then, with the program's state freed, the check of
what the window produced against the plain reference
(``benchmark/reference/``). With ``--trace 0`` the result line carries the
cell's end-to-end metrics, with ``--trace 1`` its per-layer ones, read from
one profiled stretch of the window. The numbers compared and their limits
are the last lines on standard error and the last key of the result line,
which is the last line on standard output.

A cell measured and left out of BENCHMARK.json keeps its entries in
``benchmark/pending/<workload>.json`` and runs the same way, outside the
driver's checks.

The run fails (exit code 3, no result line) without a card, or with fewer
than the cell asks for, and (exit code 4) when jax, jaxlib, flax or the JAX
package are loaded once the window has closed. ``--cpu-tiny`` runs the
same code on the CPU at the tiny sizes of ``benchmark/tests/tiny.json``
(the kernels' plain versions), for the tests.

Development modes, outside the driver's runs: ``--control`` also reads the
control (the reference one precision lower in the program's place);
``--control-path`` runs the program on the path of the configuration that
the cell's configuration names as its control (``reference.control_path``:
the program's own path one precision lower), judged against the cell's
own reference and limits; ``--sweep r1,r2,...`` (the serving driver) runs
one window at each rate.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "benchmark"
FORBIDDEN = ("jax", "jaxlib", "flax", "radialog_tpu")
EXIT_NO_CARD, EXIT_FORBIDDEN = 3, 4


def parse(argv: Optional[List[str]]) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--cpu-tiny", action="store_true", help="tiny sizes on the CPU (tests)")
    ap.add_argument("--control", action="store_true", help="also read the control")
    ap.add_argument("--control-path", action="store_true",
                    help="run the program on the control configuration's path")
    ap.add_argument("--sweep", help="comma-separated rates (serving driver)")
    return ap.parse_args(argv)


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def cell(workload: str, tiny: bool, control_path: bool = False) -> Dict:
    """The cell's entry, configuration, traffic, limits and metric names;
    with ``control_path``, the configuration's ``path`` is that of the
    configuration it names as its control."""
    bench = load_json(ROOT / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == workload), None)
    pending = BENCH / "pending" / f"{workload}.json"
    if entry is None and pending.exists():
        # a cell measured and left out of BENCHMARK.json, run outside the
        # driver's checks with its own metrics
        left_out = load_json(pending)
        entry = left_out["workload"]
        bench = dict(bench, end_to_end=bench["end_to_end"] + left_out["end_to_end"],
                     per_layer=bench["per_layer"] + left_out["per_layer"])
    if entry is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")

    def config_of(name: str) -> Dict:
        return load_json(ROOT / next(c for c in bench["configs"] if c["name"] == name)["file"])

    config = config_of(entry["config"])
    if control_path:
        if "control_path" not in config["reference"]:
            raise SystemExit(f"{entry['config']} names no control path")
        config = dict(config, path=config_of(config["reference"]["control_path"])["path"])
    traffic = load_json(BENCH / "traffic" / f"{entry['traffic']}.json")
    limits = load_json(BENCH / "limits" / f"{workload}.json")
    if tiny:
        t = load_json(BENCH / "tests" / "tiny.json")
        config = dict(config, **t["config"][config["path"]["weights"]])
        traffic = dict(traffic, **t["traffic"][traffic["driver"]])
        limits = {name: t["limits"][traffic["driver"]][name] for name in limits}

    def applies(metric: Dict) -> bool:
        return "workloads" not in metric or workload in metric["workloads"]

    return {"entry": entry, "config": config, "traffic": traffic, "limits": limits,
            "end_to_end": [m for m in bench["end_to_end"] if applies(m)],
            "per_layer": [m for m in bench["per_layer"] if applies(m)]}


def metric_reader(name: str):
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_").replace("-", "_"),
        BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def open_device(c: Dict, tiny: bool):
    import torch
    if tiny:
        return torch.device("cpu")
    need = c["entry"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"this cell needs {need} CUDA device(s); found {n}", file=sys.stderr)
        raise SystemExit(EXIT_NO_CARD)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def run_once(args, c: Dict, device) -> int:
    """Set-up, the window, the check and the result line of one run."""
    seed = args.seed
    import torch
    from benchmark import common
    from radialog_tpu_torch.ops import _build
    _build.set_build_dir(ROOT / "build" / "kernels")
    driver = importlib.import_module(f"benchmark.drivers.{c['traffic']['driver']}")
    ctx = common.Context(args.workload, c["config"], c["traffic"], seed, device, args.cpu_tiny,
                         bool(args.trace))
    if args.trace:
        ctx.tracer = common.Tracer(device)
        ctx.tracer.warm()
    state = driver.setup(ctx)
    setup_s = common.clock(device) - T_START
    if args.sweep:
        driver.sweep(ctx, state, args.seconds, [float(r) for r in args.sweep.split(",")])
        driver.free(state)
        return 0
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    result = driver.window(ctx, state, args.seconds)
    dev_info = common.device_info(device, args.cpu_tiny)
    found = forbidden_modules()
    if found:
        print(f"loaded once the window closed: {', '.join(found)}", file=sys.stderr)
        return EXIT_FORBIDDEN
    trace = ctx.tracer.reduce() if ctx.tracer is not None else {}
    driver.free(state)
    del state
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks = driver.check(ctx, result["outputs"], control=args.control)
    del result["outputs"]
    gc.collect()
    record = {"workload": args.workload, "config": c["config"], "traffic": c["traffic"],
              "window": result["record"], "trace": trace}
    if args.trace:
        metrics = {}
        for m in c["per_layer"]:
            value = metric_reader(m["name"])(record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev_info.update(busy_s=trace.get("busy_s", 0.0), window_s=trace.get("window_s", 0.0))
    else:
        values = dict(result["metrics"], setup_s=setup_s)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in c["end_to_end"]}
    compared = {name: {"value": checks[name], "limit": lim["limit"]}
                for name, lim in c["limits"].items()}
    correct = all(v["value"] <= v["limit"] for v in compared.values())
    line = {"correct": correct, "attempted": result["attempted"], "failed": result["failed"],
            "metrics": metrics, "device": dev_info}
    if args.trace and trace.get("device_ops"):
        line["breakdown"] = {"device_ops": trace["device_ops"], "idle_gaps": trace["idle_gaps"]}
    line["checks"] = compared
    found = forbidden_modules()
    if found:
        print(f"loaded after the window: {', '.join(found)}", file=sys.stderr)
        return EXIT_FORBIDDEN
    log = ctx.log
    if device.type == "cuda":
        log("card:", common.card_line())
    log("path", json.dumps(c["config"]["path"]))
    log("seed", seed, "setup_s", setup_s, "window", json.dumps(
        {k: v for k, v in result["record"].items() if not isinstance(v, list) or len(v) < 40}))
    if trace:
        log("trace", json.dumps({k: v for k, v in trace.items()
                                 if k in ("window_s", "busy_s", "kernel_count", "families",
                                          "device_span_s", "host_window_s")}))
    log("checks (other):", json.dumps({k: v for k, v in checks.items() if k not in compared}))
    for name, v in compared.items():
        log(f"check {name}: {v['value']!r} limit {v['limit']!r}")
    print(json.dumps(line), flush=True)
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    args = parse(argv)
    sys.path.insert(0, str(ROOT))
    # every build and kernel cache inside the checkout, at fixed paths
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    c = cell(args.workload, args.cpu_tiny, args.control_path)
    import torch
    torch.set_num_threads(min(4, os.cpu_count() or 1))
    device = open_device(c, args.cpu_tiny)
    return run_once(args, c, device)


if __name__ == "__main__":
    sys.exit(main())
