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

A transformation is a pair of functions over trees (nested dicts, lists and
tuples of tensors): ``init(params) -> state`` and ``update(grads, state,
params) -> (updates, state)``; ``updates`` is None on a micro-step that only
accumulates. Nothing is changed in place. Counters are Python ints, so no
step waits for the card.
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Optional, Union

import torch

Schedule = Callable[[int], float]


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


def global_norm(tree, specs=None, mesh=None) -> torch.Tensor:
    """sqrt of the sum of squares over every leaf, a 0-d tensor.

    With ``specs`` (parallel/partition.py) and ``mesh``, ``tree`` is this
    rank's shard of a tree split over the mesh's ``model`` axis: each split
    leaf's sum of squares is summed over the model group (one all-reduce)
    and each replicated leaf counted once, so every rank gets the norm of
    the whole tree. The leaves' sums are added in the tree's order, as
    without a mesh, so a model axis of one rank gives the same bits."""
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
    return torch.sqrt(sum(squares))


def apply_updates(params, updates):
    """params + updates leaf by leaf; None updates leave params as they are."""
    if updates is None:
        return params
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)


# ---------------------------------------------------------------- schedules
def linear_warmup_cosine(init_lr: float, min_lr: float, warmup_steps: int,
                         total_steps: int, warmup_start_lr: float = -1.0) -> Schedule:
    """Linear warm-up, then cosine decay to ``min_lr``."""
    start = warmup_start_lr if warmup_start_lr >= 0 else init_lr

    def schedule(step: int) -> float:
        if step < warmup_steps:
            return start + (init_lr - start) * min(step, warmup_steps) / max(warmup_steps, 1)
        t = min(max((step - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0), 1.0)
        return min_lr + 0.5 * (init_lr - min_lr) * (1 + math.cos(math.pi * t))

    return schedule


def linear_warmup_step(init_lr: float, min_lr: float, warmup_steps: int,
                       decay_rate: float, steps_per_epoch: int,
                       warmup_start_lr: float = -1.0) -> Schedule:
    """Linear warm-up, then a decay by ``decay_rate`` per epoch, floored."""
    start = warmup_start_lr if warmup_start_lr >= 0 else init_lr

    def schedule(step: int) -> float:
        if step < warmup_steps:
            return start + (init_lr - start) * min(step, warmup_steps) / max(warmup_steps, 1)
        epoch = math.floor(step / max(steps_per_epoch, 1))
        return max(init_lr * (decay_rate ** epoch), min_lr)

    return schedule


# ---------------------------------------------------------------- optimizer
class GradientTransformation(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], tuple]


def _lr_at(learning_rate: Union[float, Schedule], count: int) -> float:
    return learning_rate(count) if callable(learning_rate) else learning_rate


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
        acc = tree_map(lambda g, a: a + (g - a) / (n + 1), grads, state["acc"])
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
        c1, c2 = 1 - b1 ** count, 1 - b2 ** count
        step_size = -_lr_at(learning_rate, state["count"])

        def leaf(m, v, p):
            u = (m / c1) / (torch.sqrt(v / c2) + eps)
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
