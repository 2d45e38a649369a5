"""Q-Former image-grounded pass and blip2_forward_image of the PyTorch port
against the JAX package, weights through the bridge, FP32 policy.
Tolerance rtol=atol=1e-5: float32 on both sides, other summation order."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from radialog_tpu.models import blip2 as jblip
from radialog_tpu.models import qformer as jq
from radialog_tpu.ops.layers import layernorm as jlayernorm
from radialog_tpu_torch import bridge
from radialog_tpu_torch.models import blip2 as tblip
from radialog_tpu_torch.models import qformer as tq
from radialog_tpu_torch.ops.layers import layernorm

TOL = dict(rtol=1e-5, atol=1e-5)


def _setup(nq=8):
    jcfg = dataclasses.replace(jq.TINY_QFORMER, num_query_tokens=nq)
    tcfg = dataclasses.replace(tq.TINY_QFORMER, num_query_tokens=nq)
    params = jq.qformer_init(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(0)
    ln = {"scale": rng.normal(size=48).astype(np.float32),
          "bias": rng.normal(size=48).astype(np.float32)}
    tokens = rng.normal(size=(2, 6, 48)).astype(np.float32)
    return jcfg, tcfg, params, ln, tokens


def test_config_matches_jax():
    for field in ("num_query_tokens", "encoder_width", "cross_attention_freq"):
        assert getattr(tq.QFormerConfig(), field) == getattr(jq.QFormerConfig(), field)
        assert getattr(tq.TINY_QFORMER, field) == getattr(jq.TINY_QFORMER, field)
    assert tq.QFormerConfig().bert.hidden_size == 768


def test_image_grounded_with_and_without_mask():
    jcfg, tcfg, params, _, tokens = _setup()
    tp = bridge.to_torch(jax.tree_util.tree_map(np.asarray, params), device="cpu")
    mask = np.asarray([[1, 1, 1, 1, 0, 0], [1] * 6], np.int32)
    for m in (None, mask):
        ref, _ = jq.qformer_image_grounded(params, jcfg, jnp.asarray(tokens),
                                           None if m is None else jnp.asarray(m))
        got = tq.qformer_image_grounded(tp, tcfg, torch.from_numpy(tokens),
                                        None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_blip2_forward_image_after_ln_vision():
    jcfg, tcfg, params, ln, tokens = _setup(nq=32)
    patch = jlayernorm(ln, jnp.asarray(tokens))
    ref = jblip.blip2_forward_image({"qformer": params, "ln_vision": ln},
                                    jblip.Blip2Config(qformer=jcfg), patch)
    tp = bridge.qformer(jax.tree_util.tree_map(np.asarray, params), ln, device="cpu")
    got = tblip.blip2_forward_image(tp, tblip.Blip2Config(qformer=tcfg),
                                    layernorm(tp["ln_vision"], torch.from_numpy(tokens)))
    assert got.shape == (2, 32, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
