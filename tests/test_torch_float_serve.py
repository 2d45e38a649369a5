"""The ring batcher and the server of the PyTorch port over the stacked float
params (the float path's serving: the bf16 ring), against the JAX package's
``RingBatcher`` and ``RaDialogServer`` on the same TINY_LLAMA weights and
LoRA through the bridge, FP32 policy, on the CPU: token-equal, as
tests/test_torch_serve.py holds the W8A8 server. The int8 ring stays
refused on these params, as in the JAX package."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radialog_tpu.apps.serve import RaDialogServer as JServer
from radialog_tpu.decode.continuous import RingBatcher as JRing
from radialog_tpu.decode.engine import DecodeParams as JDecodeParams
from radialog_tpu.models import llama as jl
from radialog_tpu_torch import bridge
from radialog_tpu_torch.apps.serve import RaDialogServer
from radialog_tpu_torch.decode.continuous import RingBatcher
from radialog_tpu_torch.decode.engine import DecodeParams
from radialog_tpu_torch.models import llama as tl

CFG = tl.TINY_LLAMA
TIMEOUT = 300
KW = dict(lanes=2, cache_len=96, prompt_len=32, steps_per_call=2)


@pytest.fixture(scope="module")
def models():
    params = jl.llama_init(jax.random.PRNGKey(0), jl.TINY_LLAMA)
    lora = jl.lora_init(jax.random.PRNGKey(1), jl.TINY_LLAMA)      # holds img_proj
    conv = lambda t: jax.tree_util.tree_map(np.array, t)   # noqa: E731
    return params, lora, bridge.llama_stacked(conv(params), "cpu"), bridge.lora(conv(lora), "cpu")


def _requests():
    """Four prompts of 4 to 13 words, the second with the <IMG> run and
    an image spliced at admission."""
    rng = np.random.default_rng(3)
    emb = rng.normal(size=(1, CFG.num_img_tokens, CFG.qformer_dim)).astype(np.float32)
    prompts = [[int(x) for x in np.random.default_rng(40 + i).integers(3, 200, 4 + 3 * i)]
               for i in range(4)]
    prompts[1] = prompts[1][:2] + [CFG.img_token_id] * CFG.num_img_tokens + prompts[1][2:]
    return prompts, [None, emb, None, None]


def test_ring_batcher_on_stacked_params_matches_jax(models):
    """Five sessions through two lanes with chunks of 3 until the ring of
    64 slots wraps; then the int8 ring refused on these params."""
    params, lora, tp, tlora = models
    prompts, embs = _requests()
    prompts.append(prompts[0][::-1] + prompts[2])
    embs.append(None)
    kw = dict(KW, steps_per_call=3)
    jrb = JRing(params, jl.TINY_LLAMA, dp=JDecodeParams(max_new_tokens=23, eos_token_id=-1),
                lora=lora, **kw)
    trb = RingBatcher(tp, CFG, dp=DecodeParams(max_new_tokens=23, eos_token_id=-1), lora=tlora,
                      device="cpu", **kw)
    out = []
    for rb, conv in ((jrb, jnp.asarray), (trb, torch.from_numpy)):
        sids = [rb.submit(p, img_embs=None if e is None else conv(e))
                for p, e in zip(prompts, embs)]
        finished = rb.run()
        out.append([finished[s].tokens for s in sids])
    assert trb.ring_pos > trb.ring_len and not trb.cache.quantized
    assert out[1] == out[0] and all(len(t) == 23 for t in out[1])
    with pytest.raises(ValueError, match="unrolled serving params"):
        RingBatcher(tp, CFG, dp=DecodeParams(max_new_tokens=6), kv_int8=True, device="cpu",
                    **KW)


def test_server_on_stacked_params_matches_jax_server(models):
    params, lora, tp, tlora = models
    prompts, embs = _requests()
    jsrv = JServer(params, jl.TINY_LLAMA, dp=JDecodeParams(max_new_tokens=6, eos_token_id=-1),
                   lora=lora, **KW)
    tsrv = RaDialogServer(tp, CFG, dp=DecodeParams(max_new_tokens=6, eos_token_id=-1),
                          lora=tlora, device="cpu", **KW)
    try:
        jf = [jsrv.submit(p, img_embs=None if e is None else jnp.asarray(e))
              for p, e in zip(prompts, embs)]
        tf = [tsrv.submit(p, img_embs=None if e is None else torch.from_numpy(e))
              for p, e in zip(prompts, embs)]
        bad = tsrv.submit(list(range(3, 40)))         # a 64-row bucket: over the region
        want = [f.result(timeout=TIMEOUT) for f in jf]
        got = [f.result(timeout=TIMEOUT) for f in tf]
        with pytest.raises(ValueError, match="prompt region"):
            bad.result(timeout=TIMEOUT)
    finally:
        jsrv.shutdown()
        tsrv.shutdown()
    assert got == want and all(len(t) == 6 for t in got)
    assert isinstance(tsrv._rb.params["layers"], dict) and not tsrv._rb.cache.quantized
