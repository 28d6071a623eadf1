"""Port vs JAX: the view-sharded train step on 4 spawned gloo ranks.

Inputs of `tests/test_parallel.py` (`random_scene(64, 0)`, 8 orbit views
at 32 px, targets from `RandomState(0)`), handed to every rank as numpy.
One spawn (`testing.run_ranks`) runs two steps, then one step again
from the same scene; each case below reads its part. Held at
`tests/test_parallel.py:46-58`'s tolerances against JAX's
`make_sharded_train_step` on 4 devices and the port's single-process
step (after one step and after two; `tests/test_parallel.py` holds JAX's
sharded step against its single-device one); every rank's parameters
bitwise equal after every step; the meshes' shapes and names. Whether a
repeat at a fixed rank count is bitwise under gloo is measured here: it
is (the ring all-reduce sums in a fixed order at a fixed world
size)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussianeditor_tpu.core.cameras import orbit_cameras as jorbit_cameras
from gaussianeditor_tpu.parallel.mesh import make_mesh as jmake_mesh
from gaussianeditor_tpu.parallel.sharded_step import (
    make_sharded_train_step as jmake_sharded,
)
from gaussianeditor_tpu.train import optim as joptim
from gaussianeditor_tpu.train import trainer as jtrainer
from gaussianeditor_tpu_torch.train.optim import GaussianAdam, OptimConfig
from gaussianeditor_tpu_torch.train.trainer import (
    LossWeights,
    init_train_state,
    make_train_step,
)
from tests.helpers import random_scene
from gaussianeditor_tpu_torch.testing import run_ranks
from tests.torch_port_helpers import (  # noqa: F401
    PARAMS,
    one_torch_thread,
    port_camera,
    port_scene,
    scene_fields,
)
from tests.torch_port_ranks import camera_args, sharded_step_rank, snapshot

pytestmark = pytest.mark.usefixtures("one_torch_thread")

WORLD, N_VIEWS, HW, MI = 4, 8, 32, 4096


@pytest.fixture(scope="module")
def case():
    js = random_scene(64, seed=0)
    jcams = jorbit_cameras(N_VIEWS, 4.0, 0.8, 0.8, HW, HW)
    targets = np.random.RandomState(0).rand(N_VIEWS, HW, HW, 3).astype(
        np.float32)
    cams = [port_camera(c) for c in jcams]
    ranks = run_ranks(sharded_step_rank, WORLD, scene_fields(js),
                      js.max_sh_degree, [camera_args(c) for c in cams],
                      targets, MI)

    # JAX: the sharded step on 4 devices
    jopt = joptim.GaussianAdam(config=joptim.OptimConfig())
    jsharded = jmake_sharded(jopt, jtrainer.LossWeights(), jmake_mesh(WORLD),
                             max_instances=MI, tile_cap=256, chunk=32)
    j1, jm1 = jsharded(jtrainer.init_train_state(js, jopt),
                       jtrainer.stack_cameras(jcams), jnp.asarray(targets))

    # the port in this process, one rank, two steps
    optim = GaussianAdam(OptimConfig())
    step = make_train_step(optim, LossWeights(), max_instances=MI)
    state = init_train_state(port_scene(js), optim)
    single = []
    for _ in range(2):
        state, m = step(state, cams, torch.from_numpy(targets))
        single.append(snapshot(state, m))
    return dict(ranks=ranks, jax1=(j1, jm1), port_single=single)


def _jax_snap(state, metrics):
    out = {k: np.asarray(getattr(state.scene.params, k)) for k in PARAMS}
    for f in ("xyz_gradient_accum", "denom", "max_radii2d"):
        out["stats." + f] = np.asarray(getattr(state.stats, f))
    out.update({"metric." + k: float(v) for k, v in metrics.items()})
    return out


def _assert_step_close(got, want):
    """tests/test_parallel.py:46-58."""
    np.testing.assert_allclose(got["xyz"], want["xyz"], atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(got["stats.xyz_gradient_accum"],
                               want["stats.xyz_gradient_accum"], atol=1e-5,
                               rtol=1e-3)
    np.testing.assert_array_equal(got["stats.max_radii2d"],
                                  want["stats.max_radii2d"])
    np.testing.assert_allclose(got["metric.loss"], want["metric.loss"],
                               rtol=1e-5)


@pytest.mark.parametrize("against", ["jax_sharded", "port_single"])
def test_matches_single_device(case, against):
    want = (_jax_snap(*case["jax1"]) if against == "jax_sharded"
            else case["port_single"][0])
    _assert_step_close(case["ranks"][0]["step1"], want)


def test_metric_keys_are_jax(case):
    got = {k[len("metric."):] for k in case["ranks"][0]["step1"]
           if k.startswith("metric.")}
    assert got == set(case["jax1"][1])
    for k in got:
        np.testing.assert_allclose(case["ranks"][0]["step1"]["metric." + k],
                                   float(case["jax1"][1][k]), rtol=1e-4,
                                   atol=1e-7, err_msg=k)


def test_two_steps_stay_in_sync(case):
    got = case["ranks"][0]["step2"]
    assert got["step"] == 2 and np.isfinite(got["metric.loss"])
    _assert_step_close(got, case["port_single"][1])


@pytest.mark.parametrize("part", ["step1", "step2", "repeat1"])
def test_ranks_bitwise_equal(case, part):
    r0 = case["ranks"][0][part]
    for r in case["ranks"][1:]:
        for k, v in r0.items():
            if isinstance(v, np.ndarray):
                assert v.tobytes() == r[part][k].tobytes(), k
            else:
                assert v == r[part][k], k


def test_repeat_at_fixed_world_size_is_bitwise(case):
    for r in case["ranks"]:
        for k, v in r["step1"].items():
            w = r["repeat1"][k]
            assert (v.tobytes() == w.tobytes() if isinstance(v, np.ndarray)
                    else v == w), k


def test_mesh_construction(case):
    r = case["ranks"]
    assert all(x["mesh"] == ((WORLD,), ("data",)) for x in r)
    assert [x["mesh2d"] for x in r] == [
        ((2, 2), ("view", "tile"), (i // 2, i % 2)) for i in range(WORLD)]
    assert all("need 5 ranks, have 4" in x["mesh_error"] for x in r)


def test_fingerprint_tells_one_bit():
    from gaussianeditor_tpu_torch.testing import fingerprint

    rng = np.random.RandomState(0)
    a = [torch.from_numpy(rng.randn(3000).astype(np.float32)),
         torch.from_numpy(rng.randn(7, 5).astype(np.float32))]
    b = [t.clone() for t in a]
    assert torch.equal(fingerprint(a), fingerprint(b))
    b[1].view(-1).view(torch.int32)[17] += 1       # one ulp of one entry
    assert not torch.equal(fingerprint(a), fingerprint(b))


def test_cuda_rank_without_a_card_raises():
    """No fallback to the CPU: a rank asked to run on CUDA where there is
    none raises before it joins a group."""
    from gaussianeditor_tpu_torch.parallel.mesh import initialize_distributed

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="cuda"):
        initialize_distributed("127.0.0.1:1", 1, 0, device="cuda")
    assert not torch.distributed.is_initialized()
