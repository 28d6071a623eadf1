"""The reference against images worked out by hand, and against the
program's CPU render (the kernels' plain versions) at a small size."""

import math

import numpy as np
import pytest
import torch

from benchmark import reference as R
from benchmark import scene as S


def two_gaussians():
    """Two round Gaussians in one 16 x 16 tile, the front one red."""
    t = torch.tensor
    return dict(
        mean2d=t([[5.0, 6.0], [9.5, 8.0]]),
        conic=t([[0.1, 0.0, 0.1], [0.05, 0.01, 0.08]]),
        opacity=t([0.8, 0.6]),
        color=t([[1.0, 0.0, 0.0], [0.0, 0.5, 1.0]]),
        depth=t([1.0, 2.0]),
        rect=t([[0, 0, 1, 1], [0, 0, 1, 1]]),
        tiles=t([1, 1]),
        visible=t([True, True]),
        grid=(1, 1), size=(16, 16))


def hand_image(p):
    img = np.zeros((16, 16, 3))
    for y in range(16):
        for x in range(16):
            T = 1.0
            for g in (0, 1):   # depth order
                dx = float(p["mean2d"][g, 0]) - x
                dy = float(p["mean2d"][g, 1]) - y
                a, b, c = (float(v) for v in p["conic"][g])
                power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
                alpha = min(0.99, float(p["opacity"][g]) * math.exp(power))
                if power > 0 or alpha < 1 / 255:
                    continue
                if T * (1 - alpha) < 1e-4:
                    break
                img[y, x] += alpha * T * p["color"][g].numpy()
                T *= 1 - alpha
    return img


def test_two_gaussians_by_hand():
    p = two_gaussians()
    work = dict(pairs=0, contrib=0, sum_nc=0)
    got = R.render(p, R.bin_tiles(p), work).numpy()
    np.testing.assert_allclose(got, hand_image(p), atol=1e-6)
    assert work["contrib"] > 0 and work["pairs"] >= work["contrib"]


def test_order_is_by_depth():
    p = two_gaussians()
    p["depth"] = torch.tensor([2.0, 1.0])
    b = R.bin_tiles(p)
    assert b["gauss"].tolist() == [1, 0]


def test_a_gaussian_on_the_axis_lands_on_the_centre():
    pose = dict(eye=np.array([0.0, 0.0, -4.0]), target=np.zeros(3),
                up=np.array([0.0, 1.0, 0.0]), fovx=0.8, fovy=0.8,
                height=64, width=64)
    p = {k: torch.zeros(s) for k, s in (
        ("xyz", (1, 3)), ("features_dc", (1, 1, 3)),
        ("features_rest", (1, 15, 3)), ("opacity_raw", (1, 1)),
        ("log_scales", (1, 3)), ("quats", (1, 4)))}
    p["quats"][0, 0] = 1.0
    p["log_scales"] -= 3.0
    proc = R.project(p, R.camera(pose, "cpu"), 3)
    assert proc["mean2d"][0].tolist() == pytest.approx([31.5, 31.5])
    assert float(proc["depth"][0]) == pytest.approx(4.0)
    assert proc["color"][0].tolist() == pytest.approx([0.5] * 3)


def test_agrees_with_the_program_on_the_cpu():
    from gaussianeditor_tpu_torch.core.cameras import lookat_camera
    from gaussianeditor_tpu_torch.models.gaussians import GaussianScene
    from gaussianeditor_tpu_torch.ops.render import render

    cfg = dict(n_gaussians=3000, capacity=4000, sh_degree=3,
               lo=[-1, -1, -1], hi=[1, 1, 1])
    params = S.scene_params(cfg, 11, "cpu")
    params["features_rest"].normal_(0.0, 0.1,
                                    generator=S.generator(11, 3, "cpu"))
    params["features_rest"][3000:] = 0
    pose = S.camera_poses(dict(rings=[dict(count=1, radius=4.0,
                                           elevation=0.3)],
                               fovx=0.8, fovy=0.8, height=48, width=80))[0]
    scene = GaussianScene.create(params, max_sh_degree=3, active_sh_degree=3,
                                 alive=np.arange(4000) < 3000)
    cam = lookat_camera(pose["eye"], pose["target"], pose["up"], 0.8, 0.8,
                        48, 80, device="cpu")
    with torch.no_grad():
        want = render(scene, cam, torch.zeros(3)).color
    got = R.frame(params, torch.arange(4000) < 3000, 3, pose, "cpu")
    assert float((got - want).abs().max()) < 1e-4


@pytest.mark.parametrize("percent", [0.01, 1.0])
def test_densify_agrees_with_the_program_on_the_cpu(percent):
    from gaussianeditor_tpu_torch.models.gaussians import GaussianScene
    from gaussianeditor_tpu_torch.train.densify import (
        DensifyConfig,
        DensifyStats,
        densify_and_prune,
    )

    cfg = dict(n_gaussians=3000, capacity=4000, sh_degree=3,
               lo=[-1, -1, -1], hi=[1, 1, 1])
    params = S.scene_params(cfg, 5, "cpu")
    g = S.generator(5, 9, "cpu")
    params["log_scales"][:3000] += 3.0 * torch.rand((3000, 1), generator=g)
    params["opacity_raw"][:3000] -= 6.0 * torch.rand((3000, 1), generator=g)
    alive = torch.arange(4000) < 3000
    accum = torch.rand(4000, generator=g) * alive
    denom = torch.randint(0, 5, (4000,), generator=g).float() * alive
    noise = (torch.randn((4000, 3), generator=g),
             torch.randn((4000, 3), generator=g))
    ref_p, ref_alive = R.densify(
        {k: v.clone() for k, v in params.items()}, alive, alive.clone(),
        accum, denom, noise, dict(max_densify_percent=percent,
                                  percent_dense=0.01, extent=4.4,
                                  max_grad=0.05, min_opacity=0.005))
    scene = GaussianScene.create(params, max_sh_degree=3, active_sh_degree=3,
                                 alive=alive.numpy())
    res = densify_and_prune(
        scene, DensifyStats(accum, denom, torch.zeros(4000)),
        DensifyConfig(max_grad=0.05, max_densify_percent=percent,
                      min_opacity=0.005, percent_dense=0.01),
        4.4, 0.1, 1.3, noise=noise)
    assert int(res.n_cloned) + int(res.n_split) > 0
    assert int(res.n_pruned) > 0
    assert torch.equal(scene.alive, ref_alive)
    for k, v in ref_p.items():
        got = getattr(scene, k).detach()
        assert float((got - v)[ref_alive].abs().max()) < 1e-5, k
