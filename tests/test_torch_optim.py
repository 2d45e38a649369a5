"""The port's optimizer arithmetic (radialog_tpu_torch/train/optim.py) against
optax as JAX runs it op by op (``jax.disable_jit()``), on the same numpy
inputs.

Bars: bit for bit (Adam's divisors, the moments, the update and the
parameters over 100 updates), except where the clip's global norm enters.
Each leaf's sum of squares runs in torch's order, not XLA's, so the norm
is a few ulps apart at leaves of hundreds of entries, and a clipped step
carries that into every later update: with the clip on, the parameters
(of magnitude up to ~3) are held within CLIP_TOL absolute: the largest gap
measured over these cases is 2.4e-7, one ulp of a parameter in [2, 4).
The JAX train step runs the chain jitted, where XLA parts from its own op
by op result (tests/test_torch_train.py ``test_adamw_matches_optax``). The
full ranges: tools/optim_parity.py."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from radialog_tpu.train import optim as joptim
from radialog_tpu_torch.train import optim as toptim

CLIP_TOL = 2.5e-7


def leaves_np(tree):
    """Leaves as numpy, dicts in sorted key order (JAX's)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves_np(tree[k])]
    return [tree.numpy() if isinstance(tree, torch.Tensor) else np.asarray(tree)]


def test_bias_correction_is_jax_integer_power():
    """``1 - b ** count`` with an int32 count, as optax forms it: JAX's
    integer power of the f32 decay (a binary exponentiation in f32), then
    an f32 subtraction. Every count up to 64, then the powers of two and
    their neighbours (where the exponentiation's chain grows) to 10,000."""
    decays = jnp.asarray(np.array([0.9, 0.999], np.float32))
    counts = list(range(1, 65)) + [100, 127, 128, 255, 256, 1000, 1023, 1024, 4095, 4096,
                                   8191, 8192, 9999, 10000]
    with jax.disable_jit():
        want = [np.asarray(1 - decays ** jnp.asarray(c, jnp.int32)) for c in counts]
    for c, w in zip(counts, want):
        got = np.array([toptim._bias_correction(b, c) for b in (0.9, 0.999)], np.float32)
        assert got.tobytes() == w.tobytes(), f"count {c}: {got} vs {w}"


def test_global_norm_sums_leaves_in_jax_order():
    """Single-entry leaves (each sum of squares exact), inserted out of key
    order, whose f32 total depends on the order of the sum: it is bitwise
    optax's only if the leaves are added in JAX's sorted order."""
    rng = np.random.default_rng(5)
    keys = [f"k{i:02d}" for i in rng.permutation(60)]
    tree = {k: rng.normal(size=(1,)).astype(np.float32) for k in keys}

    def total(order):
        s = np.float32(0)
        for k in order:
            s = s + tree[k][0] * tree[k][0]
        return s
    assert total(keys) != total(sorted(keys))          # the premise: order shows
    with jax.disable_jit():
        want = np.asarray(optax.global_norm({k: jnp.asarray(v) for k, v in tree.items()}))
    got = toptim.global_norm({k: torch.from_numpy(v) for k, v in tree.items()})
    assert got.numpy().tobytes() == want.tobytes()


def _tree(rng):
    return {"layers": {"wq": {"a": rng.normal(size=(2, 24, 16)).astype(np.float32)}},
            "img_proj": {"w": rng.normal(size=(24, 16)).astype(np.float32),
                         "b": rng.normal(size=(16,)).astype(np.float32)},
            "scale": np.asarray(2.0, np.float32)}


@pytest.mark.parametrize("accum", [1, 3])
@pytest.mark.parametrize("clip", [None, 1.0])
@pytest.mark.parametrize("wd", [0.0, 0.05])
def test_adamw_matches_eager_optax(accum, clip, wd):
    """100 updates (Adam's counts 1 to 100) of a tree with 0-d to 3-d
    leaves under the finetune trainer's warm-up-cosine schedule, gradients
    large enough on every third micro-step for the clip to bite: the
    moments, the update and the parameters after every update."""
    rng = np.random.default_rng(accum * 10 + (clip is not None) * 2 + (wd > 0))
    params = _tree(rng)
    kw = dict(weight_decay=wd, grad_clip=clip, accum_steps=accum)
    sched = dict(init_lr=3e-3, min_lr=3e-4, warmup_steps=10, total_steps=100)
    jtx = joptim.make_adamw(joptim.linear_warmup_cosine(**sched), **kw)
    ttx = toptim.make_adamw(toptim.linear_warmup_cosine(**sched), **kw)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = toptim.tree_map(torch.from_numpy, params)
    with jax.disable_jit():
        jstate = jtx.init(jp)
    tstate = ttx.init(tp)
    for step in range(100 * accum):
        grads = jax.tree_util.tree_map(
            lambda p: np.asarray(rng.normal(size=p.shape) * (1.0 if step % 3 == 0 else 0.05),
                                 np.float32), params)
        with jax.disable_jit():
            jup, jstate = jtx.update(jax.tree_util.tree_map(jnp.asarray, grads), jstate, jp)
            jp = optax.apply_updates(jp, jup)
        tup, tstate = ttx.update(toptim.tree_map(torch.from_numpy, grads), tstate, tp)
        tp = toptim.apply_updates(tp, tup)
        if tup is None:
            continue
        adam = (jstate.inner_opt_state if accum > 1 else jstate)[-1][0]
        inner = tstate["inner"] if accum > 1 else tstate
        if clip is None:
            for what, t, j in (("mu", inner["mu"], adam.mu), ("nu", inner["nu"], adam.nu),
                               ("update", tup, jup), ("params", tp, jp)):
                for got, want in zip(leaves_np(t), leaves_np(j)):
                    assert got.tobytes() == want.tobytes(), f"{what} apart at count {adam.count}"
        else:
            for got, want in zip(leaves_np(tp), leaves_np(jp)):
                np.testing.assert_allclose(got, want, rtol=0, atol=CLIP_TOL,
                                           err_msg=f"count {adam.count}")
    assert inner["count"] == int(adam.count) == 100
