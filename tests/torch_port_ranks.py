"""What each spawned gloo rank runs in the port's multi-device tests
(`gaussianeditor_tpu_torch/testing.py::run_ranks`). Torch and the port
only: a rank imports this module afresh, and JAX has no place there.
Inputs come in as numpy arrays (a scene's fields, cameras as
`camera_args` tuples) and results go back as numpy arrays and floats."""

import copy

import numpy as np
import torch
import torch.distributed as dist

from gaussianeditor_tpu_torch.models.convert import (
    camera_from_numpy,
    scene_from_numpy,
)
from gaussianeditor_tpu_torch.models.gaussians import PARAM_NAMES
from gaussianeditor_tpu_torch.parallel.halo import (
    gather_rows,
    halo_exchange_rows,
    ssim_sharded,
)
from gaussianeditor_tpu_torch.parallel.mesh import (
    make_mesh,
    make_mesh_2d,
)
from gaussianeditor_tpu_torch.parallel.mesh2d import make_2d_train_step
from gaussianeditor_tpu_torch.parallel.sharded_step import (
    make_sharded_train_step,
)
from gaussianeditor_tpu_torch.parallel.tile_sharded import (
    make_tile_sharded_render,
    render_strip,
)
from gaussianeditor_tpu_torch.train.losses import ssim
from gaussianeditor_tpu_torch.train.optim import GaussianAdam, OptimConfig
from gaussianeditor_tpu_torch.train.trainer import (
    LossWeights,
    init_train_state,
)

GRAD_PARAMS = ("xyz", "opacity_raw", "log_scales", "quats", "features_dc")


def camera_args(cam):
    """A port Camera as the positional arguments of `camera_from_numpy`."""
    return (cam.world_view.numpy(), cam.full_proj.numpy(),
            cam.cam_pos.numpy(), np.asarray(cam.tan_fovx),
            np.asarray(cam.tan_fovy), cam.height, cam.width)


def _camera(args):
    return camera_from_numpy(*args, device="cpu")


def one_minus_ssim(pred, target):
    return 1.0 - ssim(pred, target)


def snapshot(state, metrics) -> dict:
    out = {k: getattr(state.scene, k).detach().numpy().copy()
           for k in PARAM_NAMES}
    for f in ("xyz_gradient_accum", "denom", "max_radii2d"):
        out["stats." + f] = getattr(state.stats, f).numpy().copy()
    out["step"] = state.step
    out.update({"metric." + k: float(v) for k, v in metrics.items()})
    return out


def sharded_step_rank(rank, world, fields, sh_degree, cams, targets, mi):
    """Two view-sharded steps from the scene, then one more from the
    scene again (the repeat); the meshes' shapes and names."""
    scene = scene_from_numpy(fields, sh_degree, device="cpu")
    cams = [_camera(c) for c in cams]
    targets = torch.from_numpy(targets)
    optim = GaussianAdam(OptimConfig())
    mesh = make_mesh(world)
    step = make_sharded_train_step(optim, LossWeights(), mesh,
                                   max_instances=mi)
    out = {"mesh": (tuple(mesh.shape), mesh.mesh_dim_names)}
    m2 = make_mesh_2d((2, world // 2))
    out["mesh2d"] = (tuple(m2.shape), m2.mesh_dim_names,
                     tuple(int(c) for c in m2.get_coordinate()))
    try:
        make_mesh(world + 1)
    except ValueError as e:
        out["mesh_error"] = str(e)
    state = init_train_state(copy.deepcopy(scene), optim)
    state, m = step(state, cams, targets)
    out["step1"] = snapshot(state, m)
    state, m = step(state, cams, targets)
    out["step2"] = snapshot(state, m)
    state = init_train_state(copy.deepcopy(scene), optim)
    state, m = step(state, cams, targets)
    out["repeat1"] = snapshot(state, m)
    return out


def strips_rank(rank, world, fields, sh_degree, cam, bg, probe, mi,
                ssim_a, ssim_b):
    """On a 1-D "tile" mesh: the strip-sharded render; the strips'
    gradients of sum(color * probe) + 0.05 sum(final_T), summed over the
    ranks; the halo SSIM and its gradient on row strips of (a, b)."""
    scene = scene_from_numpy(fields, sh_degree, device="cpu")
    cam = _camera(cam)
    mesh = make_mesh(world, axis="tile")
    group = mesh.get_group("tile")
    fn = make_tile_sharded_render(mesh, scene.capacity, cam,
                                  max_instances_per_shard=mi)
    with torch.no_grad():
        color, ovf = fn(scene, torch.from_numpy(bg))
    out = {"color": color.numpy(), "overflow": bool(ovf)}

    gy_local = (cam.height // 16) // world
    hs = gy_local * 16
    strip = render_strip(scene, cam, rank * gy_local, gy_local,
                         max_instances=mi)
    pr = torch.from_numpy(probe[rank * hs:(rank + 1) * hs])
    loss = torch.sum(strip.color * pr) + 0.05 * torch.sum(strip.final_T)
    grads = torch.autograd.grad(loss, [getattr(scene, k)
                                       for k in GRAD_PARAMS])
    for k, g in zip(GRAD_PARAMS, grads):
        g = g.clone()
        dist.all_reduce(g, group=group)
        out["grad." + k] = g.numpy()
    out["visible"] = strip.visible.numpy()
    out["radii"] = strip.radii.numpy()

    hs = ssim_a.shape[0] // world
    a = torch.from_numpy(ssim_a[rank * hs:(rank + 1) * hs]).requires_grad_()
    b = torch.from_numpy(ssim_b[rank * hs:(rank + 1) * hs])
    s = ssim_sharded(a, b, group)
    (ga,) = torch.autograd.grad(s, [a])
    out["ssim"] = float(s)
    out["ssim_grad"] = ga.numpy()
    # the exchanges themselves: the halo rows are the neighbours' rows
    ext = halo_exchange_rows(a.detach(), 5, group)
    out["halo"] = ext.numpy()
    out["gathered"] = gather_rows(a.detach(), group).numpy()
    return out


def mesh2d_rank(rank, world, shape, fields, sh_degree, cams, targets, mi,
                lambda_p, perceptual):
    """One 2-D (view x tile) step on a mesh of `shape`."""
    scene = scene_from_numpy(fields, sh_degree, device="cpu")
    cams = [_camera(c) for c in cams]
    targets = torch.from_numpy(targets)
    optim = GaussianAdam(OptimConfig())
    mesh = make_mesh_2d(shape)
    step = make_2d_train_step(
        optim, LossWeights(lambda_p=lambda_p), mesh, impl="pallas",
        max_instances=mi, perceptual=one_minus_ssim if perceptual else None)
    state = init_train_state(scene, optim)
    state, m = step(state, cams, targets)
    return snapshot(state, m)
