"""Tensor-parallel continuous batching of the port (radialog_tpu_torch/
parallel/tp_ring.py) against the port's ``RingBatcher`` (TP = 1) and the
JAX package's ``TPRingBatcher`` on 2 CPU devices (TP = 2), on TINY_LLAMA
W8A8 with LoRA and images, FP32, the bf16 ring, 2 lanes, 2 steps a call,
the staggered schedule of tests/test_tp_ring.py.

TP = 2 runs in two gloo rank processes (tests/torch_tp_ranks.py): rank 0
drives the batcher, then ``RaDialogServer`` over it from 2 client threads;
rank 1 runs ``serve_follower``. Held: TP = 1 tokens equal to
``RingBatcher``'s; TP = 2 first tokens (the admission prefill) equal to
JAX's, and at these seeds every later token too; the served sessions' tokens equal to the driven ones (each lane's
arithmetic is independent of the others'); both ranks' chunk tokens equal;
a mesh with data > 1 refused, as in JAX."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radialog_tpu.core.mesh import MeshSpec as JMeshSpec, make_mesh as jmake_mesh
from radialog_tpu.decode.engine import DecodeParams as JDecodeParams
from radialog_tpu.models.llama import TINY_LLAMA as JTINY, llama_init, lora_init
from radialog_tpu.ops.layers import FP32 as JFP32
from radialog_tpu.parallel import tp_ring as jring
from radialog_tpu.parallel import tp_serving as jtp
from radialog_tpu_torch import bridge
from radialog_tpu_torch.decode.continuous import RingBatcher
from radialog_tpu_torch.decode.engine import DecodeParams
from radialog_tpu_torch.models.llama import TINY_LLAMA
from radialog_tpu_torch.ops import quant as tquant
from radialog_tpu_torch.ops.layers import FP32
from radialog_tpu_torch.parallel.tp_ring import TPRingBatcher
from radialog_tpu_torch.parallel.tp_serving import shard_lora, shard_quantized_llama

import torch_tp_ranks

DP = dict(max_new_tokens=6, eos_token_id=-1)
RING = dict(lanes=2, cache_len=64, prompt_len=32, steps_per_call=2)


@pytest.fixture(scope="module")
def setup():
    """tests/test_tp_ring.py's weights and prompts, with a LoRA B that is
    not zero."""
    cfg = JTINY
    key = jax.random.PRNGKey(0)
    host = jax.tree_util.tree_map(np.asarray, llama_init(key, cfg))
    lora = jax.tree_util.tree_map(np.asarray, lora_init(key, cfg))
    rng = np.random.default_rng(7)
    for t in lora["layers"]:
        lora["layers"][t]["b"] = (rng.normal(size=lora["layers"][t]["b"].shape)
                                  * 0.1).astype(np.float32)
    prompts = [[int(x) for x in rng.integers(3, 200, (n,))] for n in (9, 14, 5, 11)]
    imgs = [(rng.normal(size=(1, cfg.num_img_tokens, cfg.qformer_dim)) * 0.1
             ).astype(np.float32) for _ in prompts]
    for p in prompts:
        p[2:2 + cfg.num_img_tokens] = [cfg.img_token_id] * cfg.num_img_tokens
    return host, lora, prompts, imgs


def _drive(batcher, prompts, imgs, as_img):
    return torch_tp_ranks._drive(batcher, prompts, [as_img(x) for x in imgs],
                                 DP["max_new_tokens"])


@pytest.fixture(scope="module")
def ranks(setup, tmp_path_factory):
    host, lora, prompts, imgs = setup
    job = dict(kind="ring", cfg=dataclasses.asdict(TINY_LLAMA), host=host, lora=lora,
               prompts=prompts, imgs=imgs, dp=DP)
    return torch_tp_ranks.run_ranks(job, 2, tmp_path_factory.mktemp("tp_ring"))


def test_tp1_equals_ring_batcher(setup):
    """No mesh: TP = 1, the shard is the whole model and no rank follows."""
    host, lora, prompts, imgs = setup
    dp = DecodeParams(**DP)
    ref = RingBatcher(tquant.quantize_llama_host(host, device="cpu"), TINY_LLAMA, dp=dp,
                      lora=bridge.lora(lora, "cpu"), policy=FP32, device="cpu", **RING)
    want = _drive(ref, prompts, imgs, torch.from_numpy)
    tp = TPRingBatcher(None, shard_quantized_llama(host, TINY_LLAMA, 1, 0, device="cpu"),
                       TINY_LLAMA, dp=dp, lora=shard_lora(bridge.lora(lora, "cpu"), TINY_LLAMA, 1, 0),
                       policy=FP32, device="cpu", **RING)
    assert _drive(tp, prompts, imgs, torch.from_numpy) == want
    with pytest.raises(ValueError, match="serve_follower"):
        tp.serve_follower()


def test_tp2_first_tokens_match_jax(setup, ranks):
    host, lora, prompts, imgs = setup
    mesh = jmake_mesh(JMeshSpec(data=1, model=2), devices=jax.devices()[:2])
    gp, specs = jtp.shard_quantized_llama(host, JTINY, 2)
    gl, lspecs = jtp.shard_lora(lora, JTINY, 2)
    tp = jring.TPRingBatcher(mesh, gp, specs, JTINY, dp=JDecodeParams(**DP), glora=gl,
                             lora_specs=lspecs, policy=JFP32, **RING)
    want = _drive(tp, prompts, imgs, jnp.asarray)
    got = ranks[0]["drive"]
    assert [len(t) for t in got] == [DP["max_new_tokens"]] * len(prompts)
    assert [t[0] for t in got] == [t[0] for t in want]
    assert got == want


def test_server_serves_the_tp_batcher(ranks):
    assert ranks[0]["served"] == ranks[0]["drive"]


def test_ranks_agree(ranks):
    assert ranks[1]["chunks"] == len(ranks[0]["digests"]) > 0
    assert ranks[0]["digests"] == ranks[1]["digests"]
    assert ranks[0]["init"] == ranks[1]["init"] == (True, True, "gloo")
    assert not ranks[0]["jax_imported"] and not ranks[1]["jax_imported"]


def test_data_axis_refused(ranks):
    for out in ranks:
        assert "model axis only" in out["data_refused"]
