"""BioViL-T, its channel-major patch tokens, and the CheXpert classifier of
the PyTorch port against the JAX package, weights through the bridge,
FP32 policy, small trunks ((1,1,1,1) stages) to keep the CPU run short.
Tolerance rtol=atol=1e-4: float32 convolutions summed in another order,
compounded over the trunk's depth."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radialog_tpu.models import biovil_t as jb
from radialog_tpu.models import chexpert as jc
from radialog_tpu.models import vit_pooler as jv
from radialog_tpu.ops.layers import linear_init
from radialog_tpu_torch import bridge
from radialog_tpu_torch.models import biovil_t as tb
from radialog_tpu_torch.models import chexpert as tc
from radialog_tpu_torch.models import vit_pooler as tv

TOL = dict(rtol=1e-4, atol=1e-4)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("bottleneck,size", [(False, 64), (True, 64)])
def test_biovil_t_and_patch_tokens(bottleneck, size):
    params, state = jb.biovil_t_init(jax.random.PRNGKey(1), joint_feature_size=48,
                                     resnet_layers=(1, 1, 1, 1), bottleneck=bottleneck)
    tp, ts = bridge.biovil_t(_np(params), _np(state))
    x = np.random.default_rng(0).random((2, size, size, 3)).astype(np.float32)
    ref, _ = jb.biovil_t_apply(params, state, jnp.asarray(x))
    got = tb.biovil_t_apply(tp, ts, torch.from_numpy(x))
    for name in ref._fields:
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                   **TOL)
    np.testing.assert_allclose(
        tb.patch_tokens_for_qformer(got.projected_patch_embeddings).numpy(),
        np.asarray(jb.patch_tokens_for_qformer(ref.projected_patch_embeddings)), **TOL)


def test_vit_pooler_with_prior():
    p = jv.vit_pooler_init(jax.random.PRNGKey(2), dim=32, grid=(2, 3), num_blocks=2)
    rng = np.random.default_rng(1)
    cur = rng.normal(size=(2, 2, 3, 32)).astype(np.float32)
    prev = rng.normal(size=(2, 2, 3, 32)).astype(np.float32)
    ref = jv.vit_pooler_apply(p, jnp.asarray(cur), jnp.asarray(prev), num_heads=4)
    got = tv.vit_pooler_apply(bridge.to_torch(_np(p)), torch.from_numpy(cur),
                              torch.from_numpy(prev), num_heads=4)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(tv.sine_position_embedding((2, 3), 16).numpy(),
                               np.asarray(jv.sine_position_embedding((2, 3), 16)), **TOL)


def test_chexpert_classifier_at_488():
    k = jax.random.split(jax.random.PRNGKey(3), 3)
    params = {}
    params["biovil"], state = jb.biovil_t_init(k[0], joint_feature_size=128,
                                               resnet_layers=(1, 1, 1, 1), bottleneck=False)
    params["fc1"] = linear_init(k[1], 128 * 4 * 4, 512)
    params["fc2"] = linear_init(k[2], 512, jc.NUM_CLASSES)
    state = {"biovil": state}
    x = np.random.default_rng(2).random((1, jc.CLASSIFIER_CROP, jc.CLASSIFIER_CROP, 3))
    x = x.astype(np.float32)
    ref, _ = jc.chexpert_classifier_apply(params, state, jnp.asarray(x))
    tp, ts = bridge.chexpert(_np(params), _np(state))
    got = tc.chexpert_classifier_apply(tp, ts, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_array_equal(tc.predicted_findings(got).numpy(),
                                  np.asarray(jc.predicted_findings(ref)))
    assert tc.CHEXPERT_CLASSES == jc.CHEXPERT_CLASSES
