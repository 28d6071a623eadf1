"""Port vs JAX: LPIPS.

`train/lpips.py::lpips` and its input gradient against
`train/lpips_jax.py::lpips` and `jax.grad`, with `random_weights(0)`, at
64x64 and batch 2 (value to rtol 1e-5, gradient to 1e-5 of its largest
entry); the weight layout; `make_perceptual`'s fallback and weight file."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussianeditor_tpu.train import lpips_jax as jlpips
from gaussianeditor_tpu_torch.train import lpips
from gaussianeditor_tpu_torch.train.perceptual import multiscale_gradient_loss


def _images(seed, shape):
    rng = np.random.RandomState(seed)
    return (rng.rand(*shape).astype(np.float32),
            rng.rand(*shape).astype(np.float32))


def test_lpips_value_and_gradient_match_jax():
    a, b = _images(0, (2, 64, 64, 3))
    w = jlpips.random_weights(0)
    jv, jg = jax.jit(jax.value_and_grad(
        lambda x, y: jlpips.lpips(w, x, y)))(jnp.asarray(a), jnp.asarray(b))
    tw = lpips.torch_weights(lpips.random_weights(0), "cpu")
    x = torch.from_numpy(a).requires_grad_(True)
    tv = lpips.lpips(tw, x, torch.from_numpy(b))
    (tg,) = torch.autograd.grad(tv, x)
    assert tv.dtype == torch.float32 and tv.dim() == 0
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-5)
    jg = np.asarray(jg)
    np.testing.assert_allclose(tg.numpy(), jg, rtol=0,
                               atol=1e-5 * np.abs(jg).max())
    # an [H, W, 3] pair is a batch of one, and the distance to itself is 0
    one = lpips.lpips(tw, x[0].detach(), torch.from_numpy(b[0]))
    np.testing.assert_allclose(float(one), float(jlpips.lpips(
        w, jnp.asarray(a[0]), jnp.asarray(b[0]))), rtol=1e-5)
    assert float(lpips.lpips(tw, x[:1].detach(), x[:1].detach())) == 0.0


def test_weight_layout_matches_jax():
    tw, jw = lpips.random_weights(0), jlpips.random_weights(0)
    assert tw.keys() == jw.keys()
    for k in jw:
        np.testing.assert_array_equal(tw[k], jw[k], err_msg=k)
    oihw = lpips.torch_weights(tw, "cpu")
    assert tuple(oihw["conv0_w"].shape) == (64, 3, 3, 3)
    assert torch.equal(oihw["conv3_w"].permute(2, 3, 1, 0),
                       torch.from_numpy(tw["conv3_w"]))


def test_make_perceptual_falls_back_and_loads(tmp_path, monkeypatch):
    monkeypatch.delenv(lpips.DEFAULT_WEIGHTS_ENV, raising=False)
    monkeypatch.setenv("HOME", str(tmp_path))
    with pytest.warns(UserWarning, match="LPIPS weights not found"):
        assert lpips.make_perceptual() is multiscale_gradient_loss
    path = str(tmp_path / "w.npz")
    lpips.save_weights(path, lpips.random_weights(1))
    loaded = lpips.load_weights(path)
    for k, v in lpips.random_weights(1).items():
        np.testing.assert_array_equal(loaded[k], v, err_msg=k)
    a, b = _images(1, (24, 32, 3))
    want = lpips.lpips(lpips.torch_weights(loaded, "cpu"),
                       torch.from_numpy(a), torch.from_numpy(b))
    for perceptual in (lpips.make_perceptual(path), _from_env(monkeypatch,
                                                              path)):
        assert isinstance(perceptual, lpips.LPIPS)
        got = perceptual(torch.from_numpy(a), torch.from_numpy(b))
        assert float(got) == float(want) > 0


def _from_env(monkeypatch, path):
    monkeypatch.setenv(lpips.DEFAULT_WEIGHTS_ENV, path)
    return lpips.make_perceptual()
