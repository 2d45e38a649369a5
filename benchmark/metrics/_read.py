"""What the per-layer readers share: kernel roofline shares from the traced
stretch's recorded calls and kernel times, and the device's idle share.
Each returns None where the stretch has nothing to read."""
from __future__ import annotations

import importlib.util
from pathlib import Path
from typing import Callable, Dict, Optional

from benchmark import roofline as R


def share(bound_s: float, family: str, trace: Dict) -> Optional[float]:
    fam = trace.get("families", {}).get(family)
    if not fam or fam["seconds"] <= 0 or bound_s <= 0:
        return None
    return 100.0 * bound_s / fam["seconds"]


def k1_pct(rec: Dict) -> Optional[float]:
    t = rec["trace"]
    return share(sum(R.k1_bound(m, n, k)[0] for m, n, k in t.get("k1_calls", [])), "k1", t)


def k2_pct(rec: Dict) -> Optional[float]:
    t = rec["trace"]
    return share(sum(R.k2_bound(b, h, d, rows, p0)[0]
                     for (b, h, d), rows, p0 in t.get("k2_calls", [])), "k2", t)


def k3_pct(rec: Dict) -> Optional[float]:
    """K3 over the traced stretch: the recorded launches' bounds over K3's
    kernel time in the profiler's records. Each call launches one kernel;
    where the counts differ the stretch cut a call in two, and there is
    nothing to read."""
    t = rec["trace"]
    calls = t.get("k3_calls") or []
    fam = t.get("families", {}).get("k3")
    if not calls or not fam or fam["count"] != len(calls):
        return None
    peak = {2: R.BF16_OPS_PER_S, 4: R.F32_OPS_PER_S}
    return share(sum(R.k3_bound(b, tq, h, d, lens, elt, peak[elt])[0]
                     for (b, tq, h, d), _s, lens, elt in calls), "k3", t)


def idle_pct(rec: Dict) -> Optional[float]:
    t = rec["trace"]
    if not t.get("window_s") or not t.get("kernel_count"):
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def per_step(rec: Dict) -> Optional[int]:
    return rec["trace"].get("traced_steps") or None


def window_mfu(rec: Dict) -> Optional[float]:
    """The window's model operations over its seconds, over the peak of the
    configuration's precision."""
    w = rec["window"]
    if not w.get("window_s") or not w.get("model_flops"):
        return None
    return 100.0 * w["model_flops"] / w["window_s"] / R.PEAK_BY_PRECISION[w["precision"]]


def reader(name: str) -> Callable[[Dict], Optional[float]]:
    """The ``read`` of the metric ``name`` (``benchmark/metrics/<name>.py``),
    for a metric of another cell that reads the same quantity."""
    path = Path(__file__).with_name(f"{name}.py")
    spec = importlib.util.spec_from_file_location("benchmark_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
