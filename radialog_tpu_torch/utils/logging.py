"""Metrics logging and profiling (port of radialog_tpu/utils/logging.py):
smoothed meters, the iteration logger, the JSON-lines run log (the
reference's log.txt), optional wandb, a ``torch.profiler`` trace window and
a step timer that waits for the card.
"""
from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict, deque
from pathlib import Path
from typing import Dict, Iterable, Optional


class SmoothedValue:
    """Windowed median and mean, and the mean over every update."""

    def __init__(self, window_size: int = 20, fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.deque: deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value: float, n: int = 1) -> None:
        self.deque.append(value)
        self.count += n
        self.total += value * n

    @property
    def median(self) -> float:
        d = sorted(self.deque)
        return d[len(d) // 2] if d else 0.0

    @property
    def avg(self) -> float:
        return sum(self.deque) / len(self.deque) if self.deque else 0.0

    @property
    def global_avg(self) -> float:
        return self.total / max(self.count, 1)

    def __str__(self) -> str:
        return self.fmt.format(median=self.median, avg=self.avg, global_avg=self.global_avg)


class MetricLogger:
    """Iteration logger: smoothed meters, and the time of each iteration and
    of its wait for data, printed every ``print_freq`` iterations."""

    def __init__(self, delimiter: str = "  ", print_fn=print):
        self.meters: Dict[str, SmoothedValue] = defaultdict(SmoothedValue)
        self.delimiter = delimiter
        self.print_fn = print_fn

    def update(self, **kwargs) -> None:
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def __str__(self) -> str:
        return self.delimiter.join(f"{n}: {m}" for n, m in self.meters.items())

    def log_every(self, iterable: Iterable, print_freq: int, header: str = "") -> Iterable:
        i = 0
        start = time.time()
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        data_time = SmoothedValue(fmt="{avg:.4f}")
        end = time.time()
        for obj in iterable:
            data_time.update(time.time() - end)
            yield obj
            iter_time.update(time.time() - end)
            if i % print_freq == 0:
                self.print_fn(f"{header} [{i}]  {self}  time: {iter_time}  data: {data_time}")
            i += 1
            end = time.time()
        self.print_fn(f"{header} done in {time.time() - start:.1f}s "
                      f"({(time.time() - start) / max(i, 1):.4f} s/it)")

    def global_avgs(self) -> Dict[str, float]:
        return {k: m.global_avg for k, m in self.meters.items()}


class JsonlLogger:
    """Append-only JSON-lines run log, mirrored to a wandb run if given."""

    def __init__(self, path: str | Path, wandb_run=None):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.wandb_run = wandb_run

    def log(self, record: Dict) -> None:
        with open(self.path, "a") as f:
            f.write(json.dumps({k: _jsonable(v) for k, v in record.items()}) + "\n")
        if self.wandb_run is not None:
            self.wandb_run.log(record)


def _jsonable(v):
    try:
        json.dumps(v)
        return v
    except TypeError:
        return float(v)


def maybe_wandb(project: Optional[str], name: Optional[str] = None,
                config: Optional[Dict] = None):
    """``wandb.init`` where wandb is installed and a project is given, else None."""
    if not project:
        return None
    try:
        import wandb
    except ImportError:
        return None
    return wandb.init(project=project, name=name, config=config or {})


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str]):
    """A ``torch.profiler`` window (host, and the card where there is one)
    written as ``log_dir/trace.json`` (Chrome trace format); nothing when
    log_dir is None. Yields the profiler (or None)."""
    if log_dir is None:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(Path(log_dir) / "trace.json"))


class StepTimer:
    """Wall time of each step; a step given a tensor (or a tree of them)
    waits for the card that holds it before the clock stops."""

    def __init__(self):
        self.times: list = []

    @contextlib.contextmanager
    def step(self, sync_on=None):
        t0 = time.perf_counter()
        yield
        if sync_on is not None:
            _sync(sync_on)
        self.times.append(time.perf_counter() - t0)

    def summary(self) -> Dict[str, float]:
        if not self.times:
            return {}
        arr = sorted(self.times)
        return {"mean_s": sum(arr) / len(arr), "p50_s": arr[len(arr) // 2],
                "p90_s": arr[int(len(arr) * 0.9)]}


def _sync(tree) -> None:
    import torch
    if isinstance(tree, dict):
        tree = list(tree.values())
    leaves = tree if isinstance(tree, (list, tuple)) else [tree]
    for dev in {x.device for x in leaves if isinstance(x, torch.Tensor) and x.is_cuda}:
        torch.cuda.synchronize(dev)
