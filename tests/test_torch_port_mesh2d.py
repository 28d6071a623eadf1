"""Port vs JAX: the 2-D (view x tile) sharded train step on spawned gloo
ranks (`testing.run_ranks`), one spawn per mesh, at the cases and
tolerances of `tests/test_mesh2d.py`:
  * 2x4 ranks (8 spawned, as JAX's 2x4 virtual mesh): the step without
    the perceptual term;
  * 2x2 ranks: the full objective (L1, 1 - SSIM on the strips
    reassembled by `gather_rows` at lambda_p 10, anchors).
Each is held against JAX's single-device step (`make_train_step(impl=
"pallas")`), and every rank ends it with bitwise equal parameters. The
halo SSIM case is `test_torch_port_tile_sharding.py`'s."""

import jax.numpy as jnp
import numpy as np
import pytest

from gaussianeditor_tpu.core.cameras import orbit_cameras as jorbit_cameras
from gaussianeditor_tpu.train import losses as jlosses
from gaussianeditor_tpu.train import optim as joptim
from gaussianeditor_tpu.train import trainer as jtrainer
from tests.helpers import random_scene
from gaussianeditor_tpu_torch.testing import run_ranks
from tests.torch_port_helpers import (  # noqa: F401
    PARAMS,
    one_torch_thread,
    port_camera,
    scene_fields,
)
from tests.torch_port_ranks import camera_args, mesh2d_rank

pytestmark = pytest.mark.usefixtures("one_torch_thread")

MI_2D = 8192       # tests/test_mesh2d.py


def _jax_single_step(js, jcams, targets, lambda_p, perceptual):
    jopt = joptim.GaussianAdam(config=joptim.OptimConfig())
    step = jtrainer.make_train_step(
        jopt, jtrainer.LossWeights(lambda_p=lambda_p),
        perceptual=perceptual, impl="pallas", max_instances=MI_2D)
    state, m = step(jtrainer.init_train_state(js, jopt),
                    jtrainer.stack_cameras(jcams), jnp.asarray(targets))
    out = {k: np.asarray(getattr(state.scene.params, k)) for k in PARAMS}
    for f in ("xyz_gradient_accum", "max_radii2d"):
        out["stats." + f] = np.asarray(getattr(state.stats, f))
    out.update({"metric." + k: float(v) for k, v in m.items()})
    return out


def _run_2d(shape, seed, target_seed, lambda_p, perceptual):
    js = random_scene(100, seed=seed)
    jcams = jorbit_cameras(2, 4.0, 0.8, 0.8, 64, 64)
    targets = np.random.RandomState(target_seed).rand(2, 64, 64, 3).astype(
        np.float32)
    ranks = run_ranks(mesh2d_rank, shape[0] * shape[1], shape,
                      scene_fields(js), js.max_sh_degree,
                      [camera_args(port_camera(c)) for c in jcams], targets,
                      MI_2D, lambda_p, perceptual)
    jperc = (lambda p, t: 1.0 - jlosses.ssim(p, t)) if perceptual else None
    return ranks, _jax_single_step(js, jcams, targets, lambda_p, jperc)


@pytest.fixture(scope="module")
def step_2x4():
    return _run_2d((2, 4), seed=5, target_seed=0, lambda_p=10.0,
                   perceptual=False)


@pytest.fixture(scope="module")
def step_2x2_perceptual():
    return _run_2d((2, 2), seed=6, target_seed=1, lambda_p=10.0,
                   perceptual=True)


def _assert_ranks_equal(ranks):
    for r in ranks[1:]:
        for k, v in ranks[0].items():
            assert (v.tobytes() == r[k].tobytes()
                    if isinstance(v, np.ndarray) else v == r[k]), k


def test_2d_step_matches_single_device(step_2x4):
    """tests/test_mesh2d.py:23-55 on a 2x4 mesh of 8 ranks."""
    ranks, want = step_2x4
    got = ranks[0]
    np.testing.assert_allclose(got["metric.loss"], want["metric.loss"],
                               rtol=2e-5)
    for f in ("xyz", "opacity_raw", "log_scales", "quats", "features_dc"):
        np.testing.assert_allclose(got[f], want[f], atol=2e-5, err_msg=f)
    np.testing.assert_allclose(got["stats.xyz_gradient_accum"],
                               want["stats.xyz_gradient_accum"], atol=1e-5)
    np.testing.assert_array_equal(got["stats.max_radii2d"],
                                  want["stats.max_radii2d"])
    assert got["metric.overflow"] == 0.0
    _assert_ranks_equal(ranks)


def test_2d_step_full_objective_with_perceptual(step_2x2_perceptual):
    """tests/test_mesh2d.py:58-96 on a 2x2 mesh: 1 - SSIM on the strips
    reassembled by gather_rows, lambda_p 10."""
    ranks, want = step_2x2_perceptual
    got = ranks[0]
    for k in ("loss", "loss_p"):
        np.testing.assert_allclose(got["metric." + k], want["metric." + k],
                                   rtol=2e-5, err_msg=k)
    assert got["metric.overflow"] == 0.0
    for f in ("xyz", "opacity_raw", "log_scales", "quats", "features_dc"):
        np.testing.assert_allclose(got[f], want[f], atol=2e-5, err_msg=f)
    _assert_ranks_equal(ranks)
