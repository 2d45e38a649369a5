"""The port's partition specs and shards (radialog_tpu_torch/parallel/
partition.py) and the tensor-parallel forward of the stacked layout
(models/llama.py with ``tp_group``) against radialog_tpu/parallel/
partition.py and JAX's unsharded ``llama_apply``.

Spec trees: equal to JAX's leaf for leaf (float and int8 base, LoRA,
batches). Shards: each (data, model) coordinate's local leaf bitwise the
block that JAX's NamedSharding puts on the device at that coordinate of its
(4, 2) mesh (vocab 256, which 2 divides). Two gloo rank processes
(tests/torch_tp_ranks.py) on a (1, 2) mesh: ``shard_params`` then
``gather_params`` bitwise the identity at vocab 257 (padded to 2 x 129
rows) and 256, the local shapes checked, a wrong one refused; the TP = 2
forward with LoRA and the image splice within 1e-5 of JAX's unsharded
logits (FP32, sums in another order; JAX's own bar in tests/
test_parallel.py), the vocab-split lookup bitwise the plain one.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

from radialog_tpu.core.mesh import MeshSpec as JMeshSpec, make_mesh as jmake_mesh
from radialog_tpu.models import llama as jl
from radialog_tpu.ops import layers as jlayers
from radialog_tpu.ops import quant as jquant
from radialog_tpu.parallel import partition as jpt
from radialog_tpu_torch import bridge
from radialog_tpu_torch.core import mesh as tm
from radialog_tpu_torch.parallel import partition as tpt

import torch_tp_ranks

B, T = 4, 24


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pairs(jtree, ttree, path=""):
    """(path, JAX leaf, port leaf) over a spec or param tree of each side."""
    if isinstance(ttree, dict):
        assert sorted(jtree) == sorted(ttree), path
        for k in ttree:
            yield from _pairs(jtree[k], ttree[k], f"{path}/{k}")
    else:
        yield path, jtree, ttree


def _models(vocab, seed=0):
    cfg = dataclasses.replace(jl.TINY_LLAMA, vocab_size=vocab)
    key = jax.random.PRNGKey(seed)
    base = _np(jl.llama_init(key, cfg))
    lora = _np(jl.lora_init(jax.random.PRNGKey(seed + 1), cfg))
    rng = np.random.default_rng(seed)
    for t in lora["layers"]:
        lora["layers"][t]["b"] = (rng.normal(size=lora["layers"][t]["b"].shape)
                                  * 0.1).astype(np.float32)
    return cfg, base, lora


@pytest.mark.parametrize("quantized", [False, True])
def test_spec_trees_match_jax(quantized):
    _, base, lora = _models(256)
    if quantized:
        base = _np(jquant.quantize_llama(base))
    tbase, tlora = bridge.llama_stacked(base, "cpu"), bridge.lora(lora, "cpu")
    got = list(_pairs(jpt.llama_partition_specs(base), tpt.llama_partition_specs(tbase)))
    got += list(_pairs(jpt.lora_partition_specs(lora), tpt.lora_partition_specs(tlora)))
    assert len(got) == (20 if quantized else 12) + 7
    for path, j, t in got:
        assert isinstance(t, tpt.PartitionSpec) and tuple(t) == tuple(j), path
    batch = {"tokens": np.zeros((B, T), np.int32), "img_embs": np.zeros((B, 4, 32)),
             "n": np.zeros(())}
    for path, j, t in _pairs(jpt.batch_specs(batch), tpt.batch_specs(batch)):
        assert tuple(t) == tuple(j), path
    for path, j, t in _pairs(jpt.replicated_specs(lora), tpt.replicated_specs(tlora)):
        assert tuple(t) == tuple(j) == (), path


def test_lora_grad_axes_pin_which_sum():
    """Over data: every leaf. Over model: a and scale only (each model rank
    sees its own columns of b); b is split and img_proj's gradient is whole
    on every rank once copy_to_group sums the input gradients."""
    _, _, lora = _models(256)
    axes = tpt.lora_grad_axes(bridge.lora(lora, "cpu"))
    assert axes["scale"] == ("data", "model")
    for t in ("wq", "wv"):
        assert axes["layers"][t] == {"a": ("data", "model"), "b": ("data",)}
    assert axes["img_proj"] == {"w": ("data",), "b": ("data",)}


class _Coord:
    """A DeviceMesh stand-in at one (data, model) coordinate."""
    mesh_dim_names = ("data", "model")

    def __init__(self, shape, coord):
        self.shape, self.coord = shape, coord

    def get_local_rank(self, axis):
        return self.coord[self.mesh_dim_names.index(axis)]

    def size(self, dim):
        return self.shape[dim]


@pytest.mark.parametrize("quantized", [False, True])
def test_local_shards_are_jax_placements(quantized):
    """Every leaf of the base and the adapters: the port's shard at each of
    the (4, 2) mesh's coordinates is bitwise JAX's block on that device."""
    _, base, lora = _models(256)
    if quantized:
        base = _np(jquant.quantize_llama(base))
    mesh = jmake_mesh(JMeshSpec(model=2))
    shape = mesh.devices.shape
    for tree, jspecs, tspecs in ((base, jpt.llama_partition_specs(base),
                                  tpt.llama_partition_specs(bridge.llama_stacked(base, "cpu"))),
                                 (lora, jpt.lora_partition_specs(lora),
                                  tpt.lora_partition_specs(bridge.lora(lora, "cpu")))):
        local = {c: tpt.shard_params(_Coord(shape, c), bridge.to_torch(tree, "cpu"), tspecs)
                 for c in np.ndindex(shape)}
        for path, jspec, _ in _pairs(jspecs, tspecs):
            keys = path.strip("/").split("/")
            leaf = tree
            for k in keys:
                leaf = leaf[k]
            placed = jax.device_put(jnp.asarray(leaf), NamedSharding(mesh, jspec))
            for shard in placed.addressable_shards:
                coord = tuple(int(i) for i in np.argwhere(mesh.devices == shard.device)[0])
                mine = local[coord]
                for k in keys:
                    mine = mine[k]
                want = np.asarray(shard.data)
                got = mine.float().numpy() if mine.dtype == torch.bfloat16 else mine.numpy()
                np.testing.assert_array_equal(got, want.astype(got.dtype), err_msg=path)


def _inputs(cfg, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(3, cfg.vocab_size - 6, (B, T)).astype(np.int32)
    tokens[:, 2:2 + cfg.num_img_tokens] = cfg.img_token_id
    tokens[0, 5] = cfg.vocab_size - 1          # the last row, in rank 1's shard
    lengths = np.asarray([T, 19, T, 11], np.int32)
    img = rng.normal(size=(B, cfg.num_img_tokens, cfg.qformer_dim)).astype(np.float32)
    return tokens, lengths, img


def _jax_logits(cfg, base, lora, tokens, lengths, img):
    b, t = tokens.shape
    logits, _ = jl.llama_apply(
        base, cfg, jnp.asarray(tokens), jnp.broadcast_to(jnp.arange(t), (b, t)),
        jl.prefill_bias(jnp.asarray(lengths), t), img_embs=jnp.asarray(img),
        img_start=jl.find_img_start(jnp.asarray(tokens), cfg.img_token_id), lora=lora,
        policy=jlayers.FP32, lengths=jnp.asarray(lengths))
    return np.asarray(logits)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    cases, want = {}, {}
    for vocab in (256, 257):
        cfg, base, lora = _models(vocab)
        tokens, lengths, img = _inputs(cfg)
        cases[f"float{vocab}"] = dict(
            cfg=dataclasses.asdict(cfg), base=bridge.llama_stacked(base, "cpu"),
            lora=bridge.lora(lora, "cpu"), tokens=tokens, lengths=lengths, img_embs=img)
        want[f"float{vocab}"] = (_jax_logits(cfg, base, lora, tokens, lengths, img),
                                 np.asarray(base["embed"])[tokens])
    _, base, lora = _models(257)
    cases["int8_257"] = dict(base=bridge.llama_stacked(_np(jquant.quantize_llama(base)), "cpu"),
                             lora=bridge.lora(lora, "cpu"))
    got = torch_tp_ranks.run_ranks({"kind": "partition", "cases": cases}, 2,
                                   tmp_path_factory.mktemp("partition"))
    return got, cases, want


@pytest.mark.parametrize("case", ["float256", "float257", "int8_257"])
def test_shard_then_gather_is_the_identity(ranks, case):
    got, cases, _ = ranks
    vocab = 257 if case.endswith("257") else 256
    for out in got:
        res = out[case]
        assert res["base_identity"] and res["lora_identity"]
        assert not out["jax_imported"]
        # ceil(V / 2) vocabulary rows a rank (zeros padded), half of wq's columns
        assert res["vocab_rows"] == (-(-vocab // 2),) * 2 and res["wq_cols"] == 32
        assert "expected" in res["refused"]


@pytest.mark.parametrize("vocab", [256, 257])
def test_tp_forward_matches_jax_unsharded(ranks, vocab):
    got, _, want = ranks
    logits, embed = want[f"float{vocab}"]
    for out in got:
        res = out[f"float{vocab}"]
        assert res["logits"].shape == logits.shape == (B, T, vocab)
        np.testing.assert_allclose(res["logits"], logits, rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(res["embed"], embed)     # one term of the sum is not 0
    np.testing.assert_array_equal(got[0][f"float{vocab}"]["logits"],
                                  got[1][f"float{vocab}"]["logits"])


def test_shards_need_the_mesh_to_divide():
    """A shard config whose heads the model axis does not divide raises, as
    JAX's MeshSpec.resolve refuses a model axis that does not divide."""
    from radialog_tpu_torch.models.llama import TINY_LLAMA
    from radialog_tpu_torch.parallel.tp_serving import shard_config
    with pytest.raises(ValueError, match="not divisible"):
        shard_config(TINY_LLAMA, 3)
    with pytest.raises(ValueError, match="does not divide"):
        tm.MeshSpec(model=3).resolve(2)
