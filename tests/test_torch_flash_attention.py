"""Flash attention of the PyTorch port (radialog_tpu_torch/ops/flash_attention.py,
the plain version of K3) against the JAX package's Pallas kernel run in
interpret mode, on the same inputs and block sizes.

Tolerances: in f32, atol=rtol=1e-5 (both walk the same blocks with the same
online update; only the order of the f32 sums inside a block differs). In
bf16, outputs are compared in f32 at atol=rtol=1e-2: the products are
exact in f32 on both sides, but an ulp of difference in p can flip its
bf16 rounding before p @ v, and the output's own bf16 step near 1 is
3.9e-3. lse is f32 on both sides: atol=1e-5, rtol=1e-6.

The backward: ``jax.grad`` through the Pallas kernels in interpret mode (the
custom FA2 VJP, ``_dq_kernel`` and ``_dkv_kernel``) against the port's
autograd through ``flash_attention`` (on the CPU: the plain backward), f32,
the same blocks on both sides, atol=2e-4 and rtol=1e-3 as the JAX package's
own gradient test has them."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radialog_tpu.ops.flash_attention import _fwd_call
from radialog_tpu.ops.flash_attention import flash_attention as jflash
from radialog_tpu_torch.ops import flash_attention as tfa

TOL = {"float32": dict(atol=1e-5, rtol=1e-5), "bfloat16": dict(atol=1e-2, rtol=1e-2)}


def _inputs(b, t, s, h, d, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32)
            for shape in ((b, t, h, d), (b, s, h, d), (b, s, h, d))]


def _to(x, dtype):
    return jnp.asarray(x, getattr(jnp, dtype)), torch.from_numpy(x).to(getattr(torch, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,t,h,d,lens,causal,blk", [
    (2, 40, 2, 16, [40, 40], True, 16),      # T not a multiple of the block
    (3, 40, 2, 16, [40, 23, 1], True, 16),   # ragged, one length below T
    (2, 72, 4, 32, [72, 50], False, 32),     # non-causal
    (1, 300, 2, 16, [300], True, 256),       # the default block, T > 256
])
def test_plain_matches_pallas_interpret(dtype, b, t, h, d, lens, causal, blk):
    q, k, v = _inputs(b, t, t, h, d)
    (jq, tq), (jk, tk), (jv, tv) = (_to(x, dtype) for x in (q, k, v))
    lengths = np.asarray(lens, np.int32)
    ref = np.asarray(jflash(jq, jk, jv, jnp.asarray(lengths), causal=causal, bq=blk, bk=blk,
                            interpret=True).astype(jnp.float32))
    got = tfa.flash_attention(tq, tk, tv, torch.from_numpy(lengths), causal=causal)
    if blk != 256:
        got = tfa.flash_attention_plain(tq, tk, tv, torch.from_numpy(lengths),
                                        causal=causal, bq=blk, bk=blk)
    assert got.dtype == tq.dtype
    np.testing.assert_allclose(got.float().numpy(), ref, **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lse_matches_pallas_interpret(dtype):
    b, t, h, d, blk = 3, 40, 2, 16, 16
    q, k, v = _inputs(b, t, t, h, d, seed=1)
    lengths = np.asarray([40, 17, 3], np.int32)
    tp = 48                                   # padded to the block multiple

    def padded(x):
        x = np.pad(x, ((0, 0), (0, tp - t), (0, 0), (0, 0))).transpose(0, 2, 1, 3)
        return jnp.asarray(x, getattr(jnp, dtype))

    _, jlse = _fwd_call(padded(q), padded(k), padded(v), jnp.asarray(lengths), True,
                        d ** -0.5, blk, blk, True, True)
    ref = np.asarray(jlse)[:, :, :t, 0]
    tq, tk, tv = (_to(x, dtype)[1] for x in (q, k, v))
    _, lse = tfa.flash_attention_plain(tq, tk, tv, torch.from_numpy(lengths), with_lse=True,
                                       bq=blk, bk=blk)
    assert lse.shape == (b, h, t) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), ref, atol=1e-5, rtol=1e-6)


def test_zero_length_lane_is_zero_with_dead_lse():
    """What the JAX docstring states for a lane of length 0 (its arithmetic
    gives the mean of the zero-padded V blocks instead; no caller passes a
    zero length)."""
    q, k, v = (torch.from_numpy(x) for x in _inputs(2, 8, 8, 2, 16, seed=2))
    out, lse = tfa.flash_attention(q, k, v, torch.tensor([0, 5], dtype=torch.int32),
                                   with_lse=True)
    assert torch.equal(out[0], torch.zeros_like(out[0]))
    assert bool((lse[0] == tfa.LSE_DEAD).all())
    assert bool(torch.isfinite(out[1]).all()) and bool((lse[1] < 1e29).all())


def test_wrapper_takes_the_plain_version_on_the_cpu(monkeypatch):
    calls = []
    monkeypatch.setattr(tfa, "flash_attention_kernel", lambda *a, **kw: calls.append(1))
    q = torch.zeros(1, 4, 1, 16)
    tfa.flash_attention(q, q, q, torch.tensor([4], dtype=torch.int32))
    assert not calls


# ------------------------------------------------------------------ backward
def _loss_weights(b, t, h, d, lens, seed):
    """A fixed random weighting of the output, zero on rows past a
    sequence's length (the loss never reads them)."""
    w = np.random.default_rng(seed).normal(size=(b, t, h, d)).astype(np.float32)
    return w * (np.arange(t)[None, :, None, None] < np.asarray(lens)[:, None, None, None])


@pytest.mark.parametrize("b,t,h,d,lens,causal,blk", [
    (1, 64, 2, 64, [64], True, 32),          # full length
    (2, 64, 1, 64, [64, 37], True, 32),      # ragged lengths
    (1, 96, 1, 64, [96], True, 64),          # T not a multiple of the block
    (1, 64, 1, 64, [50], False, 32),         # non-causal, length mask only
    (2, 40, 2, 16, [40, 23], True, 16),      # the mock's head size
])
def test_grads_match_pallas_interpret(b, t, h, d, lens, causal, blk, monkeypatch):
    q, k, v = _inputs(b, t, t, h, d, seed=1)
    w = _loss_weights(b, t, h, d, lens, seed=2)
    lengths = np.asarray(lens, np.int32)

    def jloss(q_, k_, v_):
        o = jflash(q_, k_, v_, jnp.asarray(lengths), causal=causal, bq=blk, bk=blk,
                   interpret=True)
        return jnp.sum(o * w)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    # the port's wrapper on the CPU walks the default blocks; give the plain
    # versions the JAX call's blocks
    plain_fwd, plain_bwd = tfa.flash_attention_plain, tfa.flash_attention_bwd_plain
    monkeypatch.setattr(tfa, "flash_attention_plain",
                        lambda *a, **kw: plain_fwd(*a, **kw, bq=blk, bk=blk))
    monkeypatch.setattr(tfa, "flash_attention_bwd_plain",
                        lambda *a, **kw: plain_bwd(*a, **kw, bq=blk, bk=blk))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    out = tfa.flash_attention(tq, tk, tv, torch.from_numpy(lengths), causal=causal)
    got = torch.autograd.grad((out * torch.from_numpy(w)).sum(), (tq, tk, tv))
    for g, r, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=2e-4, rtol=1e-3,
                                   err_msg=f"d{name}")


def test_primal_unchanged_under_autograd():
    q, k, v = (torch.from_numpy(x) for x in _inputs(2, 40, 40, 2, 16, seed=3))
    lengths = torch.tensor([40, 19], dtype=torch.int32)
    direct, lse = tfa.flash_attention(q, k, v, lengths, with_lse=True)
    tq = q.clone().requires_grad_(True)
    out, lse_g = tfa.flash_attention(tq, k, v, lengths, with_lse=True)
    assert out.requires_grad and not lse_g.requires_grad
    assert torch.equal(out.detach(), direct) and torch.equal(lse_g, lse)
    with torch.no_grad():                    # no graph, no saved tensors
        assert not tfa.flash_attention(tq, k, v, lengths).requires_grad


def test_zero_length_lane_gives_zero_grads():
    q, k, v = (torch.from_numpy(x).requires_grad_(True) for x in _inputs(2, 8, 8, 2, 16, seed=2))
    out = tfa.flash_attention(q, k, v, torch.tensor([0, 5], dtype=torch.int32))
    grads = torch.autograd.grad(out.sum(), (q, k, v))
    for g in grads:
        assert torch.isfinite(g).all()
        assert torch.equal(g[0], torch.zeros_like(g[0]))
    assert bool(grads[0][1].any())
    # rows of k/v past the live lane's length get no gradient either
    assert not grads[1][1, 5:].any() and not grads[2][1, 5:].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_backward_rounds_where_the_kernels_do(dtype):
    """dq/dk/dv come back in the input dtype, and in bf16 they are the
    gradients of the rounded products: close to the f32 gradients (2e-2 of
    the largest one), not equal to them."""
    q, k, v = _inputs(2, 40, 40, 2, 16, seed=4)
    do = _loss_weights(2, 40, 2, 16, [40, 31], seed=5)
    lengths = torch.tensor([40, 31], dtype=torch.int32)

    def run(dt):
        tq, tk, tv, tdo = (torch.from_numpy(x).to(dt) for x in (q, k, v, do))
        out, lse = tfa.flash_attention_plain(tq, tk, tv, lengths, with_lse=True)
        return tfa.flash_attention_bwd_plain(tq, tk, tv, lengths, out, lse, tdo, True, None,
                                             bq=16, bk=16)

    got, ref = run(getattr(torch, dtype)), run(torch.float32)
    for g, r in zip(got, ref):
        assert g.dtype == getattr(torch, dtype)
        err = float((g.float() - r).abs().max())
        assert err <= 2e-2 * float(r.abs().max())
        assert (err == 0.0) == (dtype == "float32")


def test_backward_wrappers_take_the_plain_versions_on_the_cpu(monkeypatch):
    calls = []
    for name in ("flash_attention_kernel", "flash_attention_bwd_kernel",
                 "flash_attention_dq_kernel", "flash_attention_dkv_kernel"):
        monkeypatch.setattr(tfa, name, lambda *a, **kw: calls.append(1))
    q = torch.ones(1, 4, 1, 16, requires_grad=True)
    tfa.flash_attention(q, q, q, torch.tensor([4], dtype=torch.int32)).sum().backward()
    assert not calls and q.grad is not None


# ------------------------------------------------- K3's kernel choice and grid
@pytest.mark.parametrize("dtype,d,want", [
    (torch.bfloat16, 128, "tma"), (torch.bfloat16, 64, "tma"), (torch.bfloat16, 16, "mma"),
    (torch.bfloat16, 96, "mma"), (torch.float32, 128, "fma"), (torch.float32, 16, "fma")])
def test_route_follows_dtype_and_head_dim(dtype, d, want):
    assert tfa._route(dtype, d) == want


@pytest.mark.parametrize("name,b,t,h,blocks", [
    ("qa binary prefix", 1, 431, 32, (4, 32, 1)),
    ("qa follow-up", 1, 436, 32, (4, 32, 1)),
    ("serve admission", 1, 256, 32, (2, 32, 1)),
    ("report prefill", 12, 448, 32, (4, 32, 12)),
    ("train micro-batch", 2, 600, 32, (5, 32, 2))])
def test_grid_at_the_paths_shapes(name, b, t, h, blocks):
    """128 query rows a block on the TMA route (two warpgroups of 64): the
    qa prefix fills 128 of the H100's 132 SMs in one wave; the mma.sync
    kernel's 64-row blocks give 224 at the same shape."""
    grid = tfa._grid(b, t, h, "tma")
    assert grid == blocks
    assert grid[0] * tfa.TQ >= t > (grid[0] - 1) * tfa.TQ
    small = tfa._grid(b, t, h, "mma")
    assert small[0] * tfa.BQ_MMA >= t > (small[0] - 1) * tfa.BQ_MMA


def test_kernel_strides_of_views_and_unit_dims():
    """q/k/v views of one fused projection keep their strides; a dim of
    size 1 gets the dense stride (TMA takes only 16-byte multiples)."""
    qkv = torch.zeros((2, 10, 3 * 4 * 64), dtype=torch.bfloat16)
    q = qkv.reshape(2, 10, 3, 4, 64)[:, :, 0]
    assert tfa._strides(q) == (10 * 3 * 4 * 64, 3 * 4 * 64, 64)
    one = torch.zeros((1, 1, 1, 64), dtype=torch.bfloat16).expand(1, 1, 1, 64)
    assert tfa._strides(one.as_strided((1, 1, 1, 64), (0, 0, 0, 1))) == (64, 64, 64)
    assert tfa._strides(torch.zeros((1, 5, 2, 16))) == (5 * 2 * 16, 2 * 16, 16)


# ------------------------------------------ K5a/K5b's kernel choice and grid
@pytest.mark.parametrize("dtype,d,want", [
    (torch.bfloat16, 128, "tma"), (torch.bfloat16, 64, "tma"), (torch.bfloat16, 16, "mma"),
    (torch.bfloat16, 32, "mma"), (torch.float32, 128, "fma"), (torch.float32, 16, "fma")])
def test_bwd_route_follows_dtype_and_head_dim(dtype, d, want):
    assert tfa._bwd_route(dtype, d) == want


@pytest.mark.parametrize("kind", ["dq", "dkv"])
@pytest.mark.parametrize("name,b,t,h", [
    ("train micro-batch", 2, 600, 32),
    ("qa binary prefix", 1, 431, 32),
    ("serve admission", 1, 256, 32)])
def test_bwd_grid_covers_every_row_once_heaviest_first(kind, name, b, t, h):
    """The TMA route's grid is (heads, lanes, tiles of 64 rows): every query
    (K5a) or key (K5b) row lies in exactly one tile, and the tiles launch
    heaviest first under causal masking, counted in the kernels' own steps
    (one 64-row tile of the other axis each; K5a: the last query tiles walk
    the most key tiles, K5b: the first key tiles the most query tiles), so
    that the light ones fill the last wave."""
    grid = tfa._bwd_grid(kind, b, t, t, h, "tma")
    tiles = grid[2]
    assert grid[:2] == (h, b) and (tiles - 1) * tfa.BWD_ROWS < t <= tiles * tfa.BWD_ROWS
    order = tfa._bwd_tile_order(kind, tiles)
    covered = np.zeros(t, int)
    for z in order:
        covered[z * tfa.BWD_ROWS:(z + 1) * tfa.BWD_ROWS] += 1
    assert sorted(order) == list(range(tiles)) and (covered == 1).all()

    def work(z):      # tiles of the other axis that hold a valid pair at full length
        last = min((z + 1) * tfa.BWD_ROWS, t) - 1
        return last // tfa.BWD_ROWS + 1 if kind == "dq" else tiles - z

    loads = [work(z) for z in order]
    assert loads == sorted(loads, reverse=True)
    assert tfa._bwd_grid(kind, b, t, t, h, "mma") == (tiles, h, b)


def test_tma_ok_refuses_broadcast_and_misaligned_rows():
    """A TMA map takes neither a stride of 0 (autograd's gradient of a sum)
    nor rows that start off a 16-byte boundary: the wrapper densifies both."""
    assert tfa._tma_ok(torch.zeros(2, 8, 2, 64, dtype=torch.bfloat16))
    ones = torch.ones(1, 1, 1, 64, dtype=torch.bfloat16)
    assert not tfa._tma_ok(ones.expand(2, 8, 2, 64))
    assert tfa._tma_ok(ones.expand(1, 1, 1, 64))
    wide = torch.zeros(2, 8, 2 * 64 + 1, dtype=torch.bfloat16)
    assert not tfa._tma_ok(wide[..., :128].unflatten(-1, (2, 64)))


@pytest.mark.parametrize("b,t,h,d,lens,causal,blk", [
    (1, 64, 2, 64, [64], True, 32),
    (2, 40, 1, 64, [40, 23], True, 16),      # T not a multiple of 4 after the block
    (2, 72, 2, 16, [72, 50], False, 32),     # non-causal, the mock's head size
])
def test_dq_delta_plain_matches_pallas_bwd(b, t, h, d, lens, causal, blk):
    """The folded-delta plain twin (K5a's version that computes delta from
    out) and K5b's plain version against the JAX package's `_flash_bwd`
    under Pallas interpret mode, fed the JAX forward's own out and lse; f32,
    the same blocks, the JAX gradient test's atol 2e-4 / rtol 1e-3. delta
    against rowsum(do * out) in numpy."""
    from radialog_tpu.ops.flash_attention import _flash_bwd
    q, k, v = _inputs(b, t, t, h, d, seed=6)
    do = _loss_weights(b, t, h, d, lens, seed=7)
    lengths = np.asarray(lens, np.int32)
    scale = d ** -0.5
    tp = -(-t // blk) * blk

    def padded(x):
        return jnp.asarray(np.pad(x, ((0, 0), (0, tp - t), (0, 0), (0, 0))).transpose(0, 2, 1, 3))

    qt, kt, vt, dot = (padded(x) for x in (q, k, v, do))
    out, lse = _fwd_call(qt, kt, vt, jnp.asarray(lengths), causal, scale, blk, blk, True, True)
    jdq, jdk, jdv, _ = _flash_bwd(causal, scale, blk, blk, True,
                                  (qt, kt, vt, jnp.asarray(lengths), out, lse), dot)
    out_np = np.asarray(out)[:, :, :t].transpose(0, 2, 1, 3)
    tq, tk, tv, tdo, tout = (torch.from_numpy(np.ascontiguousarray(x))
                             for x in (q, k, v, do, out_np))
    tlse = torch.from_numpy(np.ascontiguousarray(np.asarray(lse)[:, :, :t, 0]))
    tlens = torch.from_numpy(lengths)
    dq, delta = tfa.flash_attention_dq_delta_plain(tq, tk, tv, tlens, tlse, tout, tdo, causal,
                                                   bq=blk, bk=blk)
    dk, dv = tfa.flash_attention_dkv_plain(tq, tk, tv, tlens, tlse, delta, tdo, causal,
                                           bq=blk, bk=blk)
    np.testing.assert_allclose(delta.numpy(), (do * out_np).sum(-1).transpose(0, 2, 1),
                               atol=1e-5, rtol=1e-5)
    for got, want, name in ((dq, jdq, "dq"), (dk, jdk, "dk"), (dv, jdv, "dv")):
        want = np.asarray(want)[:, :, :t].transpose(0, 2, 1, 3)
        np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=1e-3, err_msg=name)


@pytest.mark.parametrize("dtype,d,folded", [
    (torch.bfloat16, 64, True), (torch.bfloat16, 128, True), (torch.bfloat16, 16, False),
    (torch.float32, 128, False)])
def test_whole_backward_folds_delta_only_on_the_tma_route(monkeypatch, dtype, d, folded):
    """``flash_attention_bwd_kernel`` hands K5a the forward's out on the TMA
    route (K5a computes delta) and a PyTorch delta on the others; with the
    kernels standing in as their plain versions, it equals the plain
    backward bit for bit either way."""
    calls = []

    def stand_in(name, plain):
        return lambda *a: calls.append(name) or plain(*a)

    monkeypatch.setattr(tfa, "flash_attention_dq_delta_kernel",
                        stand_in("dq+delta", tfa.flash_attention_dq_delta_plain))
    monkeypatch.setattr(tfa, "flash_attention_dq_kernel",
                        stand_in("dq", tfa.flash_attention_dq_plain))
    monkeypatch.setattr(tfa, "flash_attention_dkv_kernel",
                        stand_in("dkv", tfa.flash_attention_dkv_plain))
    q, k, v = (torch.from_numpy(x).to(dtype) for x in _inputs(2, 40, 40, 2, d, seed=8))
    do = torch.from_numpy(_loss_weights(2, 40, 2, d, [40, 29], seed=9)).to(dtype)
    lengths = torch.tensor([40, 29], dtype=torch.int32)
    out, lse = tfa.flash_attention_plain(q, k, v, lengths, with_lse=True)
    got = tfa.flash_attention_bwd_kernel(q, k, v, lengths, out, lse, do)
    assert calls == (["dq+delta", "dkv"] if folded else ["dq", "dkv"])
    for g, w in zip(got, tfa.flash_attention_bwd_plain(q, k, v, lengths, out, lse, do)):
        assert torch.equal(g, w)


def test_backward_kernels_raise_on_cpu_tensors():
    """The kernel wrappers take CUDA tensors only; on the CPU the dispatching
    ``flash_attention`` uses the plain versions instead (tested above)."""
    q = torch.zeros(1, 8, 2, 64, dtype=torch.bfloat16)
    lens = torch.tensor([8], dtype=torch.int32)
    stat = torch.zeros(1, 2, 8)
    for call in (lambda: tfa.flash_attention_dq_delta_kernel(q, q, q, lens, stat, q, q),
                 lambda: tfa.flash_attention_dq_kernel(q, q, q, lens, stat, stat, q),
                 lambda: tfa.flash_attention_dkv_kernel(q, q, q, lens, stat, stat, q)):
        with pytest.raises(ValueError, match="CUDA"):
            call()
    with pytest.raises(ValueError, match="TMA route"):
        tfa.flash_attention_dq_delta_kernel(q.float(), q.float(), q.float(), lens, stat,
                                            q.float(), q.float())
