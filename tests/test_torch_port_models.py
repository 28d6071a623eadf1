"""Port vs JAX: GaussianScene construction, numpy carry-over, PLY I/O."""

import numpy as np
import pytest
import torch

from gaussianeditor_tpu.models import ply as jply
from gaussianeditor_tpu.models.gaussians import GaussianScene as JScene
from gaussianeditor_tpu.ops.knn import mean_sq_dist_to_3nn
from gaussianeditor_tpu_torch.models import ply as tply
from gaussianeditor_tpu_torch.models.gaussians import PARAM_NAMES, GaussianScene
from tests.helpers import random_scene
from tests.torch_port_helpers import (  # noqa: F401
    one_torch_thread,
    port_scene,
    scene_fields,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _assert_params_equal(tscene, jscene, n=None):
    for k in PARAM_NAMES:
        got = getattr(tscene, k).detach().numpy()
        want = np.asarray(getattr(jscene.params, k))
        if n is not None:
            got, want = got[:n], want[:n]
        np.testing.assert_array_equal(got, want, err_msg=k)


def test_scene_from_numpy_carries_every_field():
    js = random_scene(40, seed=1, max_sh_degree=2, capacity=64)
    ts = port_scene(js)
    assert isinstance(ts, torch.nn.Module)
    assert {n for n, _ in ts.named_parameters()} == set(PARAM_NAMES)
    assert ts.capacity == 64 and ts.max_sh_degree == 2
    _assert_params_equal(ts, js)
    for k in PARAM_NAMES:
        np.testing.assert_array_equal(getattr(ts, "anchor_" + k).numpy(),
                                      np.asarray(getattr(js.anchor, k)))
    for k in ("alive", "mask", "generation", "anchor_weights",
              "n_generations", "active_sh_degree"):
        np.testing.assert_array_equal(getattr(ts, k).numpy(),
                                      np.asarray(getattr(js, k)), err_msg=k)
    np.testing.assert_allclose(ts.get_opacity.detach().numpy(),
                               np.asarray(js.get_opacity), rtol=1e-6)
    assert int(ts.n_alive) == 40
    assert np.all(ts.get_opacity.detach().numpy()[40:] == 0.0)
    np.testing.assert_array_equal(ts.get_features.detach().numpy(),
                                  np.asarray(js.get_features))


def test_ply_round_trip_port_to_jax(tmp_path):
    ts = port_scene(random_scene(50, seed=2, max_sh_degree=3, capacity=80))
    path = str(tmp_path / "port.ply")
    tply.save_ply(ts, path)
    assert tply.ply_vertex_count(path) == 50
    js = jply.load_ply(path, capacity=80)
    _assert_params_equal(ts, js)
    np.testing.assert_array_equal(np.asarray(js.alive), ts.alive.numpy())
    assert js.max_sh_degree == 3


def test_ply_round_trip_jax_to_port(tmp_path):
    js = random_scene(50, seed=3, max_sh_degree=1, capacity=70)
    path = str(tmp_path / "jax.ply")
    jply.save_ply(js, path)
    ts = tply.load_ply(path, capacity=200, device="cpu")
    assert ts.capacity == 200 and ts.max_sh_degree == 1
    assert int(ts.active_sh_degree) == 1 and int(ts.n_alive) == 50
    _assert_params_equal(ts, js, n=50)
    for k in PARAM_NAMES:  # the padding slots are dead and zero
        assert np.all(getattr(ts, k).detach().numpy()[50:] == 0.0)
    jl = jply.load_ply(path, capacity=200)
    for k, v in scene_fields(jl).items():
        got = (getattr(ts, k.replace(".", "_").replace("params_", ""))
               if "." in k else getattr(ts, k))
        np.testing.assert_array_equal(got.detach().numpy(), v, err_msg=k)


def test_from_points_and_pad_match():
    rng = np.random.RandomState(4)
    pts = rng.uniform(-1, 1, (30, 3)).astype(np.float32)
    cols = rng.uniform(0, 1, (30, 3)).astype(np.float32)
    ts = GaussianScene.from_points(pts, cols, max_sh_degree=2, capacity=40,
                                   device="cpu")
    js = JScene.from_points(pts, cols, max_sh_degree=2, capacity=40)
    for k in PARAM_NAMES:
        if k != "log_scales":
            np.testing.assert_array_equal(getattr(ts, k).detach().numpy(),
                                          np.asarray(getattr(js.params, k)))
    want = np.log(np.sqrt(np.maximum(
        mean_sq_dist_to_3nn(pts, prefer_native=False), 1e-7)))
    np.testing.assert_allclose(ts.log_scales.detach().numpy()[:30, 0], want,
                               rtol=1e-6)
    tp, jp = ts.pad_to_capacity(64), js.pad_to_capacity(64)
    assert tp.capacity == 64
    for k in ("alive", "mask", "generation"):
        np.testing.assert_array_equal(getattr(tp, k).numpy(),
                                      np.asarray(getattr(jp, k)))
    assert np.all(tp.xyz.detach().numpy()[40:] == 0.0)


def test_cuda_requested_without_cuda_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    path = str(tmp_path / "s.ply")
    jply.save_ply(random_scene(5, seed=0), path)
    with pytest.raises(RuntimeError, match="cuda"):
        tply.load_ply(path)  # the default device is the card
