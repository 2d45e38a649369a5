"""Parameter partition specs for multi-rank training (port of
radialog_tpu/parallel/partition.py): Megatron's column/row split of the
LLaMA decoder over the ``model`` axis and the batch over ``data``.

  * wq/wk/wv, gate/up:  (L, H, out) split on out -> column parallel
  * wo, down:           (L, in, H) split on in   -> row parallel (their
                        partial outputs summed over ``model``)
  * embed, lm_head:     split on the vocabulary (the logits gathered)
  * norms, img_proj:    replicated
  * LoRA: ``a`` and ``scale`` replicated, ``b`` split like its base
    projection's out dim
  * the int8 training base's {"w_q", "scale"} leaves: ``w_q`` as the float
    ``w``; ``scale`` (per output channel) split with a column-parallel
    ``w_q`` and replicated with a row-parallel one

A spec is a ``PartitionSpec``: for each dimension of the leaf, the mesh
axis it is split over, or None (an empty spec: replicated). The spec trees
equal the JAX package's leaf for leaf.

The JAX package places arrays from one controller (``make_sharding``,
``jax.device_put``) and lets XLA derive the collectives. Here every rank is
a process that holds only its own shard: ``shard_params`` returns this
rank's local tree, ``gather_params`` is its inverse (for checkpoints), and
the collectives are explicit (parallel/collectives.py). ``make_sharding``
has no counterpart: no controller places arrays.

Deliberate difference: a split dimension that the axis does not divide (the
vocabulary: 32,001 rows, or 32,000, over 2 or 4 ranks) is padded with zero
rows to ceil(V / n) a rank. The padded logits are cut off after the gather
(models/llama.py ``_final_logits``), and the embedding lookup reads only
the rank's own rows (``vocab_parallel_embed`` there). JAX's specs name the
vocab axis and leave an uneven split to XLA.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ..core.mesh import DATA_AXIS, MODEL_AXIS, axis_group, axis_rank, axis_size


class PartitionSpec(tuple):
    """The mesh axis (or None) of each dimension of a leaf; a tree leaf."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec


def map_specs(fn, tree, *rest):
    """``fn`` over the leaves of a tree whose PartitionSpecs are leaves."""
    if isinstance(tree, dict):
        return {k: map_specs(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, PartitionSpec):
        return type(tree)(map_specs(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return fn(tree, *rest)


def llama_partition_specs(params: Dict) -> Dict:
    """The spec tree of ``llama_init``'s stacked tree (the leading layer
    axis unsplit), float or with the int8 training base's leaves."""

    def proj(leaf: Dict, col: bool) -> Dict:
        if "w_q" in leaf:
            lead = (None,) if leaf["w_q"].ndim == 3 else ()
            if col:
                return {"w_q": P(*lead, None, MODEL_AXIS), "scale": P(*lead, MODEL_AXIS)}
            return {"w_q": P(*lead, MODEL_AXIS, None), "scale": P(*lead, None)}
        return {"w": P(None, None, MODEL_AXIS) if col else P(None, MODEL_AXIS, None)}

    lyr = params["layers"]
    specs = {
        "embed": P(MODEL_AXIS, None),
        "layers": {"wq": proj(lyr["wq"], True), "wk": proj(lyr["wk"], True),
                   "wv": proj(lyr["wv"], True), "wo": proj(lyr["wo"], False),
                   "gate": proj(lyr["gate"], True), "up": proj(lyr["up"], True),
                   "down": proj(lyr["down"], False), "input_ln": P(), "post_ln": P()},
        "final_ln": P(),
    }
    if "w_q" in params["lm_head"]:
        specs["lm_head"] = {"w_q": P(None, MODEL_AXIS), "scale": P(MODEL_AXIS)}
    else:
        specs["lm_head"] = {"w": P(None, MODEL_AXIS)}
    if "img_proj" in params:
        specs["img_proj"] = replicated_specs(params["img_proj"])
    return specs


def lora_partition_specs(lora: Dict) -> Dict:
    """LoRA adapters: ``a`` replicated, ``b`` split on out; img_proj (when
    the tree has one) and the scale replicated."""
    specs = {"layers": {t: {"a": P(), "b": P(None, None, MODEL_AXIS)} for t in lora["layers"]},
             "scale": P()}
    if "img_proj" in lora:
        specs["img_proj"] = replicated_specs(lora["img_proj"])
    return specs


def lora_grad_axes(lora: Dict) -> Dict:
    """The mesh axes each LoRA leaf's gradient is summed over in a
    multi-rank step. Every leaf's over ``data`` (each data rank sees its own
    rows). Over ``model`` only ``a`` and ``scale``: they are replicated, but
    each model rank's gradient of them comes through its own columns of
    ``b``, a part of the whole. ``b`` is split, so its local gradient is
    whole, and ``img_proj``'s is whole on every rank once the column-parallel
    inputs sum their gradients (``copy_to_group``)."""
    both, data = (DATA_AXIS, MODEL_AXIS), (DATA_AXIS,)
    return {"layers": {t: {"a": both, "b": data} for t in lora["layers"]},
            "img_proj": map_specs(lambda _: data, lora["img_proj"]), "scale": both}


def batch_specs(tree: Any) -> Any:
    """P("data", None, ...) for each leaf of a batch tree (P() for a 0-d one)."""
    return map_specs(lambda x: P(DATA_AXIS, *([None] * (x.ndim - 1)))
                     if getattr(x, "ndim", 0) > 0 else P(), tree)


def replicated_specs(tree: Any) -> Any:
    return map_specs(lambda _: P(), tree)


def mesh_coords(mesh) -> Dict[str, tuple]:
    """{axis: (size, this rank's coordinate)} of ``mesh`` (None: one rank)."""
    return {a: (axis_size(mesh, a), axis_rank(mesh, a)) for a in (DATA_AXIS, MODEL_AXIS)}


def split_leaf(x: torch.Tensor, spec: PartitionSpec, coords: Dict[str, tuple]) -> torch.Tensor:
    """The block of ``x`` at ``coords`` ({axis: (size, rank)}, as
    ``mesh_coords`` gives) under ``spec``, a copy; a dimension that its
    axis does not divide is padded with zeros to ceil(size / n) a rank."""
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        n, r = coords[axis]
        per = -(-x.shape[dim] // n)
        if per * n != x.shape[dim]:     # zero rows up to ceil(size / n) a rank
            pad = list(x.shape)
            pad[dim] = per * n - x.shape[dim]
            x = torch.cat([x, x.new_zeros(pad)], dim=dim)
        x = x.narrow(dim, r * per, per)
    return x.clone()


def shard_params(mesh, params: Any, specs: Any) -> Any:
    """This rank's local tree: each leaf's block of the mesh coordinates
    of this rank, a copy (so the full tree can be freed). A dimension that
    its axis does not divide is padded with zeros first (module
    docstring)."""
    coords = mesh_coords(mesh)
    return map_specs(lambda x, s: split_leaf(x, s, coords), params, specs)


def gather_params(mesh, tree: Any, specs: Any, shapes: Optional[Any] = None) -> Any:
    """The inverse of ``shard_params`` on every rank (collective: every
    rank of the mesh calls it). ``shapes``, a tree of the full leaves'
    shapes, cuts the zero padding of an uneven split; without it a padded
    leaf keeps its padding."""
    from .collectives import _gather

    def one(x, spec, shape=None):
        for dim, axis in enumerate(spec):
            if axis is not None and axis_size(mesh, axis) > 1:
                x = _gather(x.detach(), axis_group(mesh, axis), dim)
                if shape is not None:
                    x = x.narrow(dim, 0, shape[dim])
        return x.detach().clone()
    if shapes is None:
        return map_specs(one, tree, specs)
    return map_specs(one, tree, specs, shapes)



def shapes_of(tree: Any) -> Any:
    """The tree of its leaves' shapes (the ``shapes`` of gather_params)."""
    return map_specs(lambda x: tuple(x.shape), tree)


def with_sharding_constraints(tree: Any, specs: Any, mesh, shapes: Any) -> Any:
    """Check that every local leaf has the shape its spec implies for the
    full ``shapes`` on ``mesh`` (ceil(size / n) on a split dimension), and
    raise ValueError otherwise; returns ``tree``. The JAX function places
    the leaves inside jit instead: here the shards exist already."""
    def check(x, spec, shape):
        want = list(shape)
        for dim, axis in enumerate(spec):
            if axis is not None:
                want[dim] = -(-shape[dim] // axis_size(mesh, axis))
        if tuple(x.shape) != tuple(want):
            raise ValueError(f"local leaf of shape {tuple(x.shape)} under {spec!r}: "
                             f"expected {tuple(want)} of the full {tuple(shape)}")
        return x
    return map_specs(check, tree, specs, shapes)


def shard_like_params(mesh, tree: Any, params: Dict, specs: Dict) -> Any:
    """``tree`` (an optimizer state) with every subtree shaped like
    ``params`` (AdamW's mu and nu, the accumulator, SGD's trace) sharded by
    ``specs``; counters pass through."""
    if isinstance(tree, dict) and set(tree) == set(params):
        return shard_params(mesh, tree, specs)
    if isinstance(tree, dict):
        return {k: shard_like_params(mesh, v, params, specs) for k, v in tree.items()}
    return tree

