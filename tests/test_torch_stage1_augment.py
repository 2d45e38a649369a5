"""ops/augment.py of the PyTorch port against radialog_tpu/ops/augment.py on
the same parameters, and the raw stage-1 step with ``augment=True`` over
JAX's own augmentation draws and negatives (the setup, the runs and their
tolerances are test_torch_stage1_train.py's).

``random_affine`` is bitwise except at pixels whose sampling coordinate
lies within 1e-4 of a rounding tie (the two sides' f32 sin, cos and tan may
differ in the last bit; at most 1e-4 of the pixels); ``color_jitter`` and
the whole batch augmentation within 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radialog_tpu.ops import augment as ja
from radialog_tpu_torch.ops import augment as ta
from test_torch_stage1_train import _raw_run, jax_augment_draws, setup  # noqa: F401


def test_stage1_raw_step_augmented(setup, monkeypatch):
    _raw_run(setup, monkeypatch, augment=True)(lambda u: u)


def _tie_pixels(angle, shear, h, w, eps=1e-4):
    """Pixels whose float64 sampling coordinate lies within eps of .5."""
    m = ta._inverse_rss(torch.tensor([angle], dtype=torch.float64),
                        torch.tensor([shear], dtype=torch.float64))[0].numpy()
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    cy, cx = (h - 1) / 2, (w - 1) / 2
    xin = m[0, 0] * (xs - cx) + m[0, 1] * (ys - cy) + cx
    yin = m[1, 0] * (xs - cx) + m[1, 1] * (ys - cy) + cy
    near = lambda v: np.abs(v - np.floor(v) - 0.5) < eps  # noqa: E731
    return near(xin) | near(yin)


@pytest.mark.parametrize("size", [64, 448])
def test_random_affine_on_given_parameters(size):
    img = np.random.default_rng(size).random((size, size, 3)).astype(np.float32)
    affine = jax.jit(ja.random_affine)
    for seed in range(6):
        key = jax.random.PRNGKey(seed)
        want = np.asarray(affine(jnp.asarray(img), key))
        angle, shear = (float(v) for v in ja.affine_params(key))
        got = ta.random_affine(torch.from_numpy(img)[None], torch.tensor([angle]),
                               torch.tensor([shear]))[0].numpy()
        off = (got != want).any(-1)
        assert not (off & ~_tie_pixels(angle, shear, size, size)).any()
        assert off.mean() < 1e-4
        assert (got == 0).all(-1).any() and not (got == 0).all()    # the fill, and content


def test_color_jitter_and_augment_batch_on_given_parameters():
    imgs = np.random.default_rng(3).random((6, 32, 32, 3)).astype(np.float32)
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        d = jax_augment_draws(key, 6)
        want = np.asarray(ja.augment_cxr_batch(jnp.asarray(imgs), key))
        got = ta.random_affine(torch.from_numpy(imgs), d["angle"], d["shear"])
        got = ta.color_jitter(got, d["brightness"], d["contrast"], d["brightness_first"])
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
        one = np.asarray(ja.color_jitter(jnp.asarray(imgs[0]), key))
        kb, kc, ko = jax.random.split(key, 3)
        bf = float(jax.random.uniform(kb, (), minval=0.8, maxval=1.2))
        cf = float(jax.random.uniform(kc, (), minval=0.8, maxval=1.2))
        np.testing.assert_allclose(
            ta.color_jitter(torch.from_numpy(imgs[:1]), torch.tensor([bf]), torch.tensor([cf]),
                            torch.tensor([bool(jax.random.bernoulli(ko))]))[0].numpy(),
            one, rtol=0, atol=1e-6)


def test_augment_draws_ranges():
    d = ta.augment_draws(256, torch.Generator().manual_seed(0))
    assert (d["angle"].abs() <= 30).all() and (d["shear"].abs() <= 15).all()
    for k in ("brightness", "contrast"):
        assert ((d[k] >= 0.8) & (d[k] <= 1.2)).all()
    assert 0.3 < d["brightness_first"].float().mean() < 0.7
    out = ta.augment_cxr(torch.rand(16, 16, 3, generator=torch.Generator().manual_seed(1)),
                         torch.Generator().manual_seed(2))
    assert out.shape == (16, 16, 3) and out.min() >= 0 and out.max() <= 1
