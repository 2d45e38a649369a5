#!/usr/bin/env python3
"""The PyTorch port's optimizer arithmetic (radialog_tpu_torch/train/optim.py)
against the JAX package's (radialog_tpu/train/optim.py, optax) on the CPU,
over whole ranges that the tests only sample.

Parts; bias, sched and adamw against JAX run op by op
(``jax.disable_jit()``, the reference the port is held to bit for bit) and
jitted (as the JAX train step runs it: XLA contracts multiply-adds into
FMAs and forms ``b ** count`` by its own power):

  bias   Adam's divisors ``1 - b ** count`` at b1 0.9 and b2 0.999, counts
         1..--counts (op by op JAX compiles one integer power a count,
         ~50 ms each)
  sched  both schedules at every step of the configurations below
  sqrt   PyTorch's f32 sqrt on the CPU against the correctly rounded one
         (the double root rounded to f32), over 1,000,000 values
  adamw  ``make_adamw`` over --steps updates of a tree of --entries
         entries, at accumulation 1 and 3, clip on and off, decay on and
         off: the most entries apart at one update in mu, nu, the update
         and the parameters, the largest gap in ulps and absolute

One JSON line a part. ``--port-root DIR`` measures the port of another
checkout (e.g. a ``git archive`` of a parent commit) against this one's
JAX package. Usage:
    JAX_PLATFORMS=cpu python tools/optim_parity.py [--parts bias,sched,sqrt,adamw]
        [--counts 10000] [--steps 100] [--entries 100000] [--port-root DIR]
"""
from __future__ import annotations

import argparse
import importlib
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import jax                                        # noqa: E402
import jax.numpy as jnp                           # noqa: E402
import numpy as np                                # noqa: E402
import optax                                      # noqa: E402
import torch                                      # noqa: E402

from radialog_tpu.train import optim as joptim    # noqa: E402

toptim = None             # the port's train/optim.py, imported by main()

# (name, settings, steps): stage 1's rates (configs/stage1_pretrain.yaml) over
# 100,000 steps, finetune_lora's (lr 3e-4, min lr / 10, warm-up 100) over
# 20,000, a min-lr-0 tail where 1 + cos(pi t) cancels, and the step schedule
SCHEDULES = [
    ("linear_warmup_cosine", dict(init_lr=1e-4, min_lr=1e-5, warmup_steps=2000,
                                  total_steps=100000, warmup_start_lr=1e-6), 100010),
    ("linear_warmup_cosine", dict(init_lr=3e-4, min_lr=3e-5, warmup_steps=100,
                                  total_steps=20000), 20010),
    ("linear_warmup_cosine", dict(init_lr=1e-4, min_lr=1e-6, warmup_steps=500,
                                  total_steps=20000, warmup_start_lr=1e-7), 20010),
    ("linear_warmup_cosine", dict(init_lr=3e-5, min_lr=0.0, warmup_steps=0,
                                  total_steps=5000), 5010),
    ("linear_warmup_step", dict(init_lr=1e-4, min_lr=1e-5, warmup_steps=100, decay_rate=0.9,
                                steps_per_epoch=1000), 60000),
]


def ordered(x) -> np.ndarray:
    """f32 bits as integers whose differences count ulps across zero."""
    i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
    return np.where(i < 0, -(i & 0x7FFFFFFF), i)


def gap(a, b) -> dict:
    """Entries apart, the largest gap in ulps (large where two entries near
    0 differ in sign) and the largest absolute difference."""
    d = np.abs(ordered(a) - ordered(b))
    return {"apart": int((d > 0).sum()), "of": int(d.size), "max_ulp": int(d.max()),
            "max_abs": float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())}


def part_bias(counts: int) -> dict:
    decays = jnp.asarray(np.array([0.9, 0.999], np.float32))
    port = np.array([[toptim._bias_correction(b, c) for b in (0.9, 0.999)]
                     for c in range(1, counts + 1)], np.float32)
    with jax.disable_jit():
        eager = np.stack([np.asarray(1 - decays ** jnp.asarray(c, jnp.int32))
                          for c in range(1, counts + 1)])
    jitted = np.asarray(jax.jit(jax.vmap(lambda c: 1 - decays ** c))(
        jnp.arange(1, counts + 1, dtype=jnp.int32)))
    return {"part": "bias", "counts": counts, "eager": gap(port, eager),
            "jit": gap(port, jitted)}


def part_sqrt() -> dict:
    x = torch.from_numpy(np.random.default_rng(0).random(1_000_000, np.float32))
    return {"part": "sqrt", "torch_vs_rounded": gap(torch.sqrt(x).numpy(),
                                                    torch.sqrt(x.double()).float().numpy()),
            "port_vs_rounded": gap(toptim._sqrt(x).numpy(),
                                   torch.sqrt(x.double()).float().numpy())}


def part_sched() -> dict:
    out = []
    for name, kw, n in SCHEDULES:
        js, ts = getattr(joptim, name)(**kw), getattr(toptim, name)(**kw)
        port = np.array([ts(s) for s in range(n)], np.float32)
        eager = np.array([np.asarray(js(s)) for s in range(n)], np.float32)
        one = jax.jit(js)
        jitted = np.array([np.asarray(one(jnp.int32(s))) for s in range(n)], np.float32)
        out.append({"schedule": name, **kw, "steps": n, "eager": gap(port, eager),
                    "jit": gap(port, jitted)})
    return {"part": "sched", "cases": out}


def adamw_run(accum: int, clip, wd: float, steps: int, entries: int, jit: bool) -> dict:
    rng = np.random.default_rng(0)
    cols = 50
    rows = entries // (3 * cols)
    params = {"layers": {"wq": {"a": rng.normal(size=(2, rows, cols)).astype(np.float32)}},
              "img_proj": {"w": rng.normal(size=(rows, cols)).astype(np.float32),
                           "b": rng.normal(size=(cols,)).astype(np.float32)},
              "scale": np.asarray(2.0, np.float32)}
    sched = dict(init_lr=3e-3, min_lr=3e-4, warmup_steps=5, total_steps=steps)
    kw = dict(weight_decay=wd, grad_clip=clip, accum_steps=accum)
    jtx = joptim.make_adamw(joptim.linear_warmup_cosine(**sched), **kw)
    ttx = toptim.make_adamw(toptim.linear_warmup_cosine(**sched), **kw)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = toptim.tree_map(torch.from_numpy, params)
    update = jax.jit(jtx.update) if jit else jtx.update
    with jax.disable_jit(not jit):
        jstate = jtx.init(jp)
    tstate = ttx.init(tp)
    worst = {"params": [], "update": [], "mu": [], "nu": []}
    for step in range(steps * accum):
        grads = jax.tree_util.tree_map(
            lambda p: np.asarray(rng.normal(size=p.shape) * (0.05 if step % 3 else 1.0),
                                 np.float32),
            params)
        with jax.disable_jit(not jit):
            jup, jstate = update(jax.tree_util.tree_map(jnp.asarray, grads), jstate, jp)
            jp = optax.apply_updates(jp, jup)
        tup, tstate = ttx.update(toptim.tree_map(torch.from_numpy, grads), tstate, tp)
        tp = toptim.apply_updates(tp, tup)
        if tup is None:
            continue
        inner_j = jstate.inner_opt_state if accum > 1 else jstate
        adam_j = inner_j[-1][0]            # the chain's adamw, its scale_by_adam
        inner_t = tstate["inner"] if accum > 1 else tstate
        pairs = {"params": (tp, jp), "update": (tup, jup), "mu": (inner_t["mu"], adam_j.mu),
                 "nu": (inner_t["nu"], adam_j.nu)}
        for key, (t, j) in pairs.items():
            tl = [x.numpy().ravel() for x in toptim.tree_leaves(t)]
            jl = [np.asarray(x).ravel() for x in toptim.tree_leaves(_sorted_like(t, j))]
            worst[key].append(gap(np.concatenate(tl), np.concatenate(jl)))
    return {"accum": accum, "clip": clip, "weight_decay": wd, "jit": jit,
            **{k: {"apart_max": max(g["apart"] for g in v), "of": v[0]["of"],
                   "max_ulp": max(g["max_ulp"] for g in v),
                   "max_abs": max(g["max_abs"] for g in v)} for k, v in worst.items()}}


def _sorted_like(torch_tree, jax_tree):
    """The JAX tree as nested dicts in the port tree's key order."""
    if isinstance(torch_tree, dict):
        return {k: _sorted_like(v, jax_tree[k]) for k, v in torch_tree.items()}
    return jax_tree


def part_adamw(steps: int, entries: int) -> dict:
    cases = [(accum, clip, wd) for accum in (1, 3) for clip in (None, 1.0) for wd in (0.0, 0.05)]
    return {"part": "adamw", "steps": steps, "entries": entries,
            "cases": [adamw_run(a, c, w, steps, entries, jit) for jit in (False, True)
                      for a, c, w in cases]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parts", default="bias,sched,sqrt,adamw")
    ap.add_argument("--counts", type=int, default=10000)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--entries", type=int, default=100000)
    ap.add_argument("--port-root", default=str(REPO),
                    help="the checkout whose radialog_tpu_torch is measured")
    args = ap.parse_args()
    jax.config.update("jax_platforms", "cpu")
    global toptim
    sys.path.insert(0, str(Path(args.port_root).resolve()))
    toptim = importlib.import_module("radialog_tpu_torch.train.optim")
    for part in args.parts.split(","):
        if part == "bias":
            line = part_bias(args.counts)
        elif part == "sched":
            line = part_sched()
        elif part == "sqrt":
            line = part_sqrt()
        elif part == "adamw":
            line = part_adamw(args.steps, args.entries)
        else:
            ap.error(f"unknown part {part!r}")
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
