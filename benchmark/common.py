"""What every driver shares: the run's context, the host clock after the
device has finished, a percentile, and the tracer of a ``--trace 1`` run.

The tracer switches ``torch.profiler`` (CPU operators and CUDA kernels)
on for one short stretch of the window and, over the same stretch, records
the shapes of the calls into the port's hand-written kernels, by wrapping
the port's launch functions (``ops/q8_matmul.py q8_matmul_int32``,
``ops/flash_decode.py flash_decode_int8_kernel``,
``ops/flash_attention.py flash_attention_kernel``): the kernels are
launched through ctypes, so the profiler sees their names and times and
nothing of their shapes. ``reduce`` turns the stretch into the record the
per-layer metrics read.

A driver whose kernels are launched from another thread (the serving
ring) holds ``Tracer.guard`` around each call that launches K3, so that
the stretch starts and stops between such calls: every K3 launch recorded
is then in the trace, and every K3 kernel in the trace was recorded.
"""
from __future__ import annotations

import dataclasses
import sys
import threading
import time
from typing import Any, Dict, List, Optional

import torch

# kernel families by a part of the kernel's name (csrc/*.cu)
FAMILIES = {"k1": ("q8_tma_kernel",), "k2": ("lane_kernel", "prefix_kernel"),
            "k3": ("fwd_tma<", "fwd_bf16<", "fwd_f32<"), "copy": ("copy_kernel",)}


@dataclasses.dataclass
class Context:
    workload: str
    config: Dict
    traffic: Dict
    seed: int
    device: torch.device
    tiny: bool
    trace: bool
    tracer: Optional["Tracer"] = None

    def log(self, *parts: Any) -> None:
        print(*parts, file=sys.stderr, flush=True)

    def mark(self, what: str, since: float) -> float:
        """Log the seconds since ``since`` (a set-up phase); returns now."""
        now = clock(self.device)
        self.log(f"setup {what}: {now - since:.3f} s")
        return now


def clock(device) -> float:
    """time.perf_counter() once every launch queued on ``device`` has run."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def percentile(values: List[float], q: float) -> float:
    """The q-th percentile (0-100) by linear interpolation between the
    closest ranks (numpy's default)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


class _Recorder:
    """Wraps one module-level launch function; while ``on``, appends each
    call's arguments to ``calls``. Launch counters the function keeps on
    itself (``fn.launches``) are carried over in both directions."""

    def __init__(self, module, name: str, keep):
        self.module, self.name, self.keep = module, name, keep
        self.orig = getattr(module, name)
        self.calls: List = []
        self.on = False
        rec = self

        def wrapped(*args, **kwargs):
            if rec.on:
                rec.calls.append(rec.keep(*args, **kwargs))
            return rec.orig(*args, **kwargs)

        self.wrapped = wrapped

    def install(self) -> None:
        if hasattr(self.orig, "launches"):
            self.wrapped.launches = self.orig.launches
        setattr(self.module, self.name, self.wrapped)

    def remove(self) -> None:
        setattr(self.module, self.name, self.orig)
        if hasattr(self.orig, "launches"):
            self.orig.launches = self.wrapped.launches


def _keep_k1(x8, w8):
    return (x8.shape[0], w8.shape[0], x8.shape[1])


def _keep_k2(q8, qs, k8, ks, v8, vs, masks, layer_idx, scale, bs, shared=None, p0=0):
    # the mask tensors are made for this call and not written again: keep
    # them, and read them once the stretch is over
    return (tuple(q8.shape), masks, int(p0) if shared is not None else 0)


def _keep_k3(q, k, v, lengths, causal=True, scale=None, with_lse=False):
    return (tuple(q.shape), k.shape[1], lengths, q.element_size())


class Tracer:
    """One profiled stretch of a ``--trace 1`` run."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.prof = None
        self.t0 = self.t1 = None
        self.recorders: List[_Recorder] = []
        self.done = False
        self.counters: Dict[str, Any] = {}
        self.guard = threading.Lock()

    def warm(self) -> None:
        """Start and stop the profiler once on this (the main) thread: its
        first start initializes the profiling library, which must happen on
        the thread that loaded it, and takes a while."""
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.device.type == "cuda"
                                         else [])
        with profile(activities=acts):
            torch.ones(8, device=self.device).sum()
        clock(self.device)

    @property
    def active(self) -> bool:
        return self.prof is not None and self.t1 is None

    def start(self) -> None:
        if self.prof is not None:
            return
        from torch.profiler import ProfilerActivity, profile
        import radialog_tpu_torch.ops.flash_attention as fa
        import radialog_tpu_torch.ops.flash_decode as fd
        import radialog_tpu_torch.ops.q8_matmul as q8
        self.recorders = [_Recorder(q8, "q8_matmul_int32", _keep_k1),
                          _Recorder(fd, "flash_decode_int8_kernel", _keep_k2),
                          _Recorder(fa, "flash_attention_kernel", _keep_k3)]
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        with self.guard:
            clock(self.device)
            self.prof.start()
            for r in self.recorders:
                r.install()
                r.on = True
            self.t0 = time.perf_counter()

    def stop(self) -> None:
        if not self.active:
            return
        with self.guard:
            for r in self.recorders:
                r.on = False
                r.remove()
            self.t1 = clock(self.device)
            self.prof.stop()
        self.done = True

    def reduce(self) -> Dict:
        """The stretch as the per-layer metrics read it: its length on the
        host clock (``window_s``) and from its first kernel's start to its
        last kernel's end (``device_span_s``), the union of kernel intervals (busy), kernel time and count by
        name and by family, the longest idle gaps labelled by the host
        operator running at the gap's start, and the recorded calls."""
        if not self.done:
            return {}
        events = self.prof.profiler.kineto_results.events()
        kernels, host = [], []
        for e in events:
            dt = e.device_type()
            start, dur = e.start_ns(), e.duration_ns()
            if dt == torch.autograd.DeviceType.CUDA:
                kernels.append((start, start + dur, e.name()))
            elif e.name().startswith("aten::") or e.name().startswith("cuda"):
                host.append((start, start + dur, e.name()))
        kernels.sort()
        host.sort()
        out: Dict[str, Any] = {"host_window_s": self.t1 - self.t0, "kernel_count": len(kernels)}
        if not kernels:
            return out
        first, last = kernels[0][0], max(k[1] for k in kernels)
        busy, gaps, end = 0, [], first
        for s, e, _ in kernels:
            if s > end:
                gaps.append((s - end, end))
            if e > end:
                busy += e - max(s, end)
                end = e
        by_name: Dict[str, List[float]] = {}
        for s, e, n in kernels:
            acc = by_name.setdefault(n, [0.0, 0])
            acc[0] += (e - s) * 1e-9
            acc[1] += 1
        fam = {f: [0.0, 0] for f in FAMILIES}
        for n, (sec, cnt) in by_name.items():
            for f, parts in FAMILIES.items():
                if any(p in n for p in parts):
                    fam[f][0] += sec
                    fam[f][1] += cnt
        gaps.sort(reverse=True)
        labelled = []
        for g, at in gaps[:10]:
            label = "host"
            for hs, he, hn in host:     # the innermost host op open at the gap's start
                if hs <= at < he:
                    label = hn
                elif hs > at:
                    break
            labelled.append([label, g * 1e-9])
        ops = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
        out.update(window_s=self.t1 - self.t0, device_span_s=(last - first) * 1e-9,
                   busy_s=busy * 1e-9,
                   families={f: {"seconds": v[0], "count": v[1]} for f, v in fam.items()},
                   device_ops=[[n[:200], v[0]] for n, v in ops], idle_gaps=labelled)
        calls = {r.name: r.calls for r in self.recorders}
        out["k1_calls"] = calls["q8_matmul_int32"]
        out["k2_calls"] = []
        for qshape, masks, p0 in calls["flash_decode_int8_kernel"]:
            lens, a1, b1, a2, b2 = (m.cpu().long() for m in masks)
            rows = int((lens + (b1 - a1 + 1).clamp(min=0) + (b2 - a2 + 1).clamp(min=0)).sum())
            out["k2_calls"].append((qshape, rows, p0))
        out["k3_calls"] = [(qshape, s, [int(x) for x in lengths.cpu()], elt)
                           for qshape, s, lengths, elt in calls["flash_attention_kernel"]]
        out.update(self.counters)
        return out


def device_info(device, tiny: bool) -> Dict:
    """``device`` of the result line: platform, kind, count, the peak of
    memory allocated since the last reset."""
    if tiny:
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def card_line() -> str:
    """nvidia-smi's name, power limit, SM clock, power draw and temperature."""
    import subprocess
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,power.draw,"
                              "temperature.gpu", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi unavailable: {exc}"
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else out.stderr.strip()
