"""Shared helpers of the PyTorch port's tests: carry JAX scenes, cameras
and preprocess outputs over to the port as numpy arrays."""

import numpy as np
import pytest
import torch

from gaussianeditor_tpu_torch.models.convert import (
    camera_from_numpy,
    scene_from_numpy,
)
from gaussianeditor_tpu_torch.ops.preprocess import ProcessedGaussians

PARAMS = ("xyz", "features_dc", "features_rest", "opacity_raw", "log_scales",
          "quats")
CAM_FIELDS = ("world_view", "full_proj", "cam_pos", "tan_fovx", "tan_fovy",
              "focal_x", "focal_y")


@pytest.fixture(scope="module")
def one_torch_thread():
    """Run a module's tests on one torch intra-op thread, and restore the
    count after it. The suite runs several pytest workers on a few cores:
    a thread pool per worker oversubscribes them, and the many small ops
    of a training loop then wait on descheduled threads (the recon and
    CLI tests ran three to ten times slower so). A module opts in by
    importing it and setting
    `pytestmark = pytest.mark.usefixtures("one_torch_thread")`."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_camera_equal(tc, jc):
    """A port Camera against a JAX Camera: sizes equal, fields to 1e-6."""
    assert (tc.height, tc.width) == (jc.height, jc.width)
    for f in CAM_FIELDS:
        np.testing.assert_allclose(getattr(tc, f).cpu().numpy(),
                                   np.asarray(getattr(jc, f)), rtol=1e-6,
                                   atol=1e-7, err_msg=f)


def scene_fields(scene) -> dict:
    """A JAX GaussianScene's fields as numpy arrays."""
    d = {}
    for k in PARAMS:
        d["params." + k] = np.asarray(getattr(scene.params, k))
        d["anchor." + k] = np.asarray(getattr(scene.anchor, k))
    for k in ("alive", "mask", "generation", "anchor_weights",
              "n_generations", "active_sh_degree"):
        d[k] = np.asarray(getattr(scene, k))
    return d


def port_scene(scene):
    """The port's CPU GaussianScene holding a JAX scene's values."""
    return scene_from_numpy(scene_fields(scene), scene.max_sh_degree,
                            device="cpu")


def port_camera(cam):
    """The port's CPU Camera holding a JAX camera's values."""
    return camera_from_numpy(
        np.asarray(cam.world_view), np.asarray(cam.full_proj),
        np.asarray(cam.cam_pos), np.asarray(cam.tan_fovx),
        np.asarray(cam.tan_fovy), cam.height, cam.width, device="cpu")


def port_proc(proc) -> ProcessedGaussians:
    """The port's ProcessedGaussians holding a JAX stage's output."""
    return ProcessedGaussians(*(torch.from_numpy(np.array(np.asarray(v)))
                                for v in proc))


def port_adam_state(state):
    """The port's CPU AdamState holding a JAX AdamState's values."""
    from gaussianeditor_tpu_torch.models.convert import adam_state_from_numpy

    fields = {"count": int(state.count)}
    for k in PARAMS:
        fields["mu." + k] = np.asarray(getattr(state.mu, k))
        fields["nu." + k] = np.asarray(getattr(state.nu, k))
    return adam_state_from_numpy(fields, device="cpu")


def port_stats(stats):
    """The port's CPU DensifyStats holding a JAX DensifyStats' values."""
    from gaussianeditor_tpu_torch.models.convert import densify_stats_from_numpy

    return densify_stats_from_numpy(
        np.asarray(stats.xyz_gradient_accum), np.asarray(stats.denom),
        np.asarray(stats.max_radii2d), device="cpu")
