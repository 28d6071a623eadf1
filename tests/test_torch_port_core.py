"""Port vs JAX: cameras, spherical harmonics, quaternion normalization."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussianeditor_tpu.core import cameras as jcam
from gaussianeditor_tpu.core import sh as jsh
from gaussianeditor_tpu.core.transforms import quat_normalize as jquat_normalize
from gaussianeditor_tpu_torch.core import cameras as tcam
from gaussianeditor_tpu_torch.core import sh as tsh
from gaussianeditor_tpu_torch.core.transforms import quat_normalize
from tests.torch_port_helpers import (  # noqa: F401
    assert_camera_equal as _assert_camera_equal,
    one_torch_thread,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def test_lookat_camera_matches():
    args = (np.array([0.3, -0.2, -4.0]), np.array([0.1, 0.0, 0.2]),
            np.array([0.0, 1.0, 0.0]), 0.8, 0.6, 40, 72)
    _assert_camera_equal(tcam.lookat_camera(*args, device="cpu"),
                         jcam.lookat_camera(*args))


def test_from_Rt_and_orbit_match():
    rng = np.random.RandomState(3)
    q, _ = np.linalg.qr(rng.randn(3, 3))
    t = rng.randn(3)
    _assert_camera_equal(
        tcam.Camera.from_Rt(q, t, 0.9, 0.7, 48, 64, translate=np.ones(3),
                            scale=1.5, device="cpu"),
        jcam.Camera.from_Rt(q, t, 0.9, 0.7, 48, 64, translate=np.ones(3),
                            scale=1.5))
    tcs = tcam.orbit_cameras(5, 3.0, 0.8, 0.8, 32, 32, elevation=0.3,
                             device="cpu")
    jcs = jcam.orbit_cameras(5, 3.0, 0.8, 0.8, 32, 32, elevation=0.3)
    for tc, jc in zip(tcs, jcs):
        _assert_camera_equal(tc, jc)


def test_fov_focal_and_projection():
    assert tcam.fov2focal(0.8, 512) == jcam.fov2focal(0.8, 512)
    assert tcam.focal2fov(600.0, 512) == jcam.focal2fov(600.0, 512)
    np.testing.assert_array_equal(
        tcam.get_projection_matrix(0.01, 100.0, 0.8, 0.6),
        jcam.get_projection_matrix(0.01, 100.0, 0.8, 0.6))


@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_eval_sh_matches(degree):
    rng = np.random.RandomState(degree)
    k = (degree + 1) ** 2
    sh = rng.randn(64, k, 3).astype(np.float32)
    dirs = rng.randn(64, 3).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    want = np.asarray(jax.jit(jsh.eval_sh, static_argnums=0)(
        degree, jnp.asarray(sh), jnp.asarray(dirs)))
    got = tsh.eval_sh(degree, torch.from_numpy(sh),
                      torch.from_numpy(dirs)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_eval_sh_active_degree_gating():
    rng = np.random.RandomState(9)
    sh = rng.randn(32, 16, 3).astype(np.float32)
    dirs = rng.randn(32, 3).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    f = jax.jit(jsh.eval_sh, static_argnums=0)
    for active in range(4):
        want = np.asarray(f(3, jnp.asarray(sh), jnp.asarray(dirs),
                            jnp.asarray(active)))
        got = tsh.eval_sh(3, torch.from_numpy(sh), torch.from_numpy(dirs),
                          torch.tensor(active)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    rgb = np.linspace(0, 1, 12, dtype=np.float32)
    np.testing.assert_allclose(tsh.rgb2sh(torch.from_numpy(rgb)).numpy(),
                               np.asarray(jsh.rgb2sh(jnp.asarray(rgb))),
                               rtol=1e-6)
    np.testing.assert_allclose(tsh.sh2rgb(torch.from_numpy(rgb)).numpy(),
                               np.asarray(jsh.sh2rgb(jnp.asarray(rgb))),
                               rtol=1e-6)


def test_quat_normalize_matches_incl_zero():
    q = np.random.RandomState(1).randn(20, 4).astype(np.float32)
    q[3] = 0.0  # dead slots carry zero quaternions
    want = np.asarray(jax.jit(jquat_normalize)(jnp.asarray(q)))
    got = quat_normalize(torch.from_numpy(q)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert np.all(got[3] == 0.0)
