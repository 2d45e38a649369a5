"""Optimizer and learning-rate schedules (port of radialog_tpu/train/optim.py).

The JAX package chains optax transforms into its update; here the same
update is written out on tensors, in optax's order of operations, so that
the two agree step for step (tests/test_torch_train.py): global-norm clip,
then Adam moments with bias correction, then decoupled weight decay on the
leaves of two or more dimensions (norms and biases are skipped), then the
learning rate of the schedule, all wrapped in an accumulation over
``accum_steps`` micro-steps that averages the gradients and applies one
update at the last of them (``optax.MultiSteps``). The schedule's clock is
the number of updates applied, not of micro-steps.

The arithmetic is optax's as JAX runs it op by op (``jax.disable_jit()``),
bit for bit on the CPU and on the card (tests/test_torch_optim.py): the
schedules in f32 in the JAX package's order, Python constants combined in
double and rounded to f32 where they meet an array, as JAX's weak types
are; Adam's divisors ``1 - b ** count`` in f32 by JAX's integer power (a
binary exponentiation in f32); every division by a scalar a division by a
0-dim tensor (``div_scalar``: the card multiplies by the reciprocal of a
Python scalar); square roots correctly rounded on every device (PyTorch's
vectorized f32 ``sqrt`` on the CPU is not). Where the result still parts
from optax: the clip's norm sums each leaf in torch's order, not XLA's,
and under ``jit`` XLA contracts the moment updates into FMAs and forms
``b ** count`` by its own power (the bounds are in the tests).

A transformation is a pair of functions over trees (nested dicts, lists and
tuples of tensors): ``init(params) -> state`` and ``update(grads, state,
params) -> (updates, state)``; ``updates`` is None on a micro-step that only
accumulates. Nothing is changed in place. Counters are Python ints, so no
step waits for the card.
"""
from __future__ import annotations

import ctypes
import ctypes.util
import functools
from typing import Any, Callable, NamedTuple, Optional, Union

import numpy as np
import torch

from ..ops.layers import div_scalar

F32 = np.float32
Schedule = Callable[[int], np.float32]


# -------------------------------------------------------------------- trees
def tree_map(fn, tree, *rest):
    """``fn`` over the tensor leaves of nested dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        mapped = [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
        return type(tree)(*mapped) if hasattr(tree, "_fields") else type(tree)(mapped)
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def _jax_order(tree) -> list:
    """Positions in ``tree_leaves(tree)`` of the leaves in the order JAX
    flattens the tree: dict keys sorted (the port keeps insertion order)."""
    def flat(t):
        if isinstance(t, dict):
            return [x for k in sorted(t) for x in flat(t[k])]
        if isinstance(t, (list, tuple)):
            return [x for v in t for x in flat(v)]
        return [t]
    position = iter(range(len(tree_leaves(tree))))
    return flat(tree_map(lambda _: next(position), tree))


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """sqrt correctly rounded on every device: XLA's and CUDA's f32 sqrt are
    IEEE, PyTorch's vectorized CPU sqrt is not (0.63 % of random f32 values
    an ulp off, tools/optim_parity.py). The square root of an f32 value in
    double, rounded to f32, is the correctly rounded f32 one."""
    return torch.sqrt(x.double()).to(x.dtype)


def global_norm(tree, specs=None, mesh=None) -> torch.Tensor:
    """sqrt of the sum of squares over every leaf, a 0-d tensor.

    With ``specs`` (parallel/partition.py) and ``mesh``, ``tree`` is this
    rank's shard of a tree split over the mesh's ``model`` axis: each split
    leaf's sum of squares is summed over the model group (one all-reduce)
    and each replicated leaf counted once, so every rank gets the norm of
    the whole tree. The leaves' sums are added in JAX's leaf order
    (``optax.global_norm``'s), as without a mesh, so a model axis of one
    rank gives the same bits. Each leaf's sum runs in torch's order, which
    is neither XLA's nor the same on the CPU and the card: the norm is the
    optimizer's one sum that is not bitwise optax's."""
    squares = [torch.sum(x.float() ** 2) for x in tree_leaves(tree)]
    if specs is not None and mesh is not None:
        from ..core.mesh import MODEL_AXIS, axis_group
        from ..parallel.collectives import sum_over
        from ..parallel.partition import map_specs
        split = [i for i, c in enumerate(tree_leaves(
            map_specs(lambda x, s: MODEL_AXIS in s, tree, specs))) if c]
        for i, q in zip(split, sum_over([squares[i] for i in split],
                                        axis_group(mesh, MODEL_AXIS))):
            squares[i] = q
    return _sqrt(sum(squares[i] for i in _jax_order(tree)))


def apply_updates(params, updates):
    """params + updates leaf by leaf; None updates leave params as they are."""
    if updates is None:
        return params
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)


# ---------------------------------------------------------------- schedules
@functools.lru_cache(maxsize=None)
def _libm() -> ctypes.CDLL:
    lib = ctypes.CDLL(ctypes.util.find_library("m"))
    lib.cosf.argtypes, lib.cosf.restype = [ctypes.c_float], ctypes.c_float
    return lib


def _cos(x: np.float32) -> np.float32:
    """cos of an f32 value by the C library's ``cosf``, which XLA's CPU
    backend calls: bitwise ``jnp.cos`` (NumPy's and PyTorch's f32 cos are
    not)."""
    return F32(_libm().cosf(float(x)))


def _pow(b: np.float32, e: np.float32) -> np.float32:
    """b ** e of f32 values: the double power rounded to f32. XLA's f32
    power is not correctly rounded, so the two are an ulp apart at some
    exponents, and XLA flushes a subnormal result to 0
    (tools/optim_parity.py measures the step schedule against JAX)."""
    return F32(float(b) ** float(e))


def _warm(start: float, init_lr: float, warmup_steps: int, step: np.float32) -> np.float32:
    return (F32(start) + F32(init_lr - start) * min(step, F32(warmup_steps))
            / F32(max(warmup_steps, 1)))


def linear_warmup_cosine(init_lr: float, min_lr: float, warmup_steps: int,
                         total_steps: int, warmup_start_lr: float = -1.0) -> Schedule:
    """Linear warm-up, then cosine decay to ``min_lr``; an f32 value, in the
    JAX schedule's f32 operations and order."""
    start = warmup_start_lr if warmup_start_lr >= 0 else init_lr

    def schedule(step: int) -> np.float32:
        s = F32(step)
        if s < F32(warmup_steps):
            return _warm(start, init_lr, warmup_steps, s)
        t = min(max((s - F32(warmup_steps)) / F32(max(total_steps - warmup_steps, 1)),
                    F32(0)), F32(1))
        return F32(min_lr) + F32(0.5 * (init_lr - min_lr)) * (F32(1) + _cos(F32(np.pi) * t))

    return schedule


def linear_warmup_step(init_lr: float, min_lr: float, warmup_steps: int,
                       decay_rate: float, steps_per_epoch: int,
                       warmup_start_lr: float = -1.0) -> Schedule:
    """Linear warm-up, then a decay by ``decay_rate`` per epoch, floored; an
    f32 value, in the JAX schedule's f32 operations and order."""
    start = warmup_start_lr if warmup_start_lr >= 0 else init_lr

    def schedule(step: int) -> np.float32:
        s = F32(step)
        if s < F32(warmup_steps):
            return _warm(start, init_lr, warmup_steps, s)
        epoch = np.floor(s / F32(max(steps_per_epoch, 1)))
        return max(F32(init_lr) * _pow(F32(decay_rate), epoch), F32(min_lr))

    return schedule


# ---------------------------------------------------------------- optimizer
class GradientTransformation(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], tuple]


def _lr_at(learning_rate: Union[float, Schedule], count: int) -> float:
    """The step's learning rate: a schedule's f32 value, or the constant,
    which the leaves' f32 rounds as optax's weak-typed constant."""
    return float(learning_rate(count)) if callable(learning_rate) else learning_rate


def _bias_correction(decay: float, count: int) -> float:
    """``1 - decay ** count`` as optax forms it (``tree_bias_correction``):
    f32(decay) to the int32 count by JAX's integer power, a binary
    exponentiation in f32 (``lax.integer_pow``), subtracted from 1 in f32.
    A Python int keeps the count on the host, so no step waits for the card."""
    x, acc = F32(decay), None
    while count:
        if count & 1:
            acc = x if acc is None else acc * x
        count >>= 1
        if count:
            x = x * x
    return float(F32(1) - acc)


def _clip_by_global_norm(grads, max_norm: float, specs=None, mesh=None):
    norm = global_norm(grads, specs, mesh)
    return tree_map(lambda g: torch.where(norm < max_norm, g,
                                          (g / norm.to(g.dtype)) * max_norm), grads)


def _accumulate(inner: GradientTransformation, every: int) -> GradientTransformation:
    """Mean of the gradients of ``every`` micro-steps, one inner update at
    the last of them."""
    def init(params):
        return {"mini_step": 0, "gradient_step": 0, "inner": inner.init(params),
                "acc": tree_map(torch.zeros_like, params)}

    def update(grads, state, params):
        n = state["mini_step"]
        acc = tree_map(lambda g, a: a + div_scalar(g - a, n + 1), grads, state["acc"])
        if n < every - 1:
            return None, {**state, "mini_step": n + 1, "acc": acc}
        updates, inner_state = inner.update(acc, state["inner"], params)
        return updates, {"mini_step": 0, "gradient_step": state["gradient_step"] + 1,
                         "inner": inner_state, "acc": tree_map(torch.zeros_like, acc)}

    return GradientTransformation(init, update)


def make_adamw(learning_rate: Union[float, Schedule], weight_decay: float = 0.05,
               b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
               grad_clip: Optional[float] = None,
               accum_steps: int = 1, specs=None, mesh=None) -> GradientTransformation:
    """AdamW with the decay masked to leaves of two or more dimensions, an
    optional global-norm clip and gradient accumulation. ``specs`` and
    ``mesh``: the parameters are this rank's shard, and the clip's norm is
    the whole tree's (``global_norm``)."""
    def init(params):
        return {"count": 0, "mu": tree_map(torch.zeros_like, params),
                "nu": tree_map(torch.zeros_like, params)}

    def update(grads, state, params):
        if grad_clip is not None:
            grads = _clip_by_global_norm(grads, grad_clip, specs, mesh)
        mu = tree_map(lambda g, m: (1 - b1) * g + b1 * m, grads, state["mu"])
        nu = tree_map(lambda g, v: (1 - b2) * (g * g) + b2 * v, grads, state["nu"])
        count = state["count"] + 1
        c1, c2 = _bias_correction(b1, count), _bias_correction(b2, count)
        step_size = -_lr_at(learning_rate, state["count"])

        def leaf(m, v, p):
            u = div_scalar(m, c1) / (_sqrt(div_scalar(v, c2)) + eps)
            if p.ndim >= 2:
                u = u + weight_decay * p
            return step_size * u

        return tree_map(leaf, mu, nu, params), {"count": count, "mu": mu, "nu": nu}

    tx = GradientTransformation(init, update)
    return _accumulate(tx, accum_steps) if accum_steps > 1 else tx


def make_sgd(learning_rate: Union[float, Schedule] = 1e-3,
             momentum: float = 0.9) -> GradientTransformation:
    """SGD with a momentum trace: t = g + momentum * t; update = -lr * t."""
    def init(params):
        return {"count": 0, "trace": tree_map(torch.zeros_like, params)}

    def update(grads, state, params):
        trace = tree_map(lambda g, t: g + momentum * t, grads, state["trace"])
        step_size = -_lr_at(learning_rate, state["count"])
        return (tree_map(lambda t: step_size * t, trace),
                {"count": state["count"] + 1, "trace": trace})

    return GradientTransformation(init, update)


def make_optimizer(name: str = "adamw", **kw) -> GradientTransformation:
    if name == "adamw":
        return make_adamw(**kw)
    if name == "sgd":
        return make_sgd(kw.get("learning_rate", 1e-3), momentum=kw.get("momentum", 0.9))
    raise ValueError(f"unknown optimizer '{name}'")
