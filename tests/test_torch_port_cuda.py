"""The CUDA kernels against their plain versions, on the card.

Marked `cuda`: they skip on a machine without a CUDA device (the kernels
have no CPU mode). This file imports neither JAX nor the JAX test
helpers, so on a GPU machine without JAX it runs with
    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_port_cuda.py
"""

import numpy as np
import pytest
import torch

from gaussianeditor_tpu_torch.core.cameras import lookat_camera
from gaussianeditor_tpu_torch.models.gaussians import GaussianScene
from gaussianeditor_tpu_torch.ops import _kernels
from gaussianeditor_tpu_torch.ops.binning_sorted import (
    binning_key,
    binning_key_plain,
    key_depth_bits,
    sorted_bin,
)
from gaussianeditor_tpu_torch.ops.render import preprocess_scene, render
from gaussianeditor_tpu_torch.ops.tile_composite import (
    forward_tiles,
    forward_tiles_plain,
)
from gaussianeditor_tpu_torch.testing import assert_images_close, fraction_equal

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _scene(n, device, seed=0, capacity=None, sh=1):
    rng = np.random.RandomState(seed)
    cap = capacity or n
    k = (sh + 1) ** 2

    def pad(x):
        out = np.zeros((cap,) + x.shape[1:], np.float32)
        out[:n] = x
        return torch.as_tensor(out, device=device)

    quats = rng.randn(n, 4).astype(np.float32)
    params = dict(
        xyz=pad(rng.uniform(-1, 1, (n, 3))),
        features_dc=pad(rng.randn(n, 1, 3) * 0.5),
        features_rest=pad(rng.randn(n, k - 1, 3) * 0.1),
        opacity_raw=pad(rng.uniform(-1, 3, (n, 1))),
        log_scales=pad(np.log(rng.uniform(0.01, 0.06, (n, 3)))),
        quats=pad(quats),
    )
    return GaussianScene.create(params, max_sh_degree=sh,
                                active_sh_degree=sh,
                                alive=np.arange(cap) < n)


def _proc(scene, hw, device):
    cam = lookat_camera((0, 0, -4), (0, 0, 0), (0, 1, 0), 0.8, 0.8, hw, hw,
                        device=device)
    with torch.no_grad():
        return preprocess_scene(scene, cam)


@pytest.mark.parametrize("budget", [1 << 20, 3000])
def test_binning_key_kernel_matches_plain(cuda, budget):
    proc = _proc(_scene(20000, cuda, capacity=30000), 256, cuda)
    gx = 16
    b_incl = torch.cumsum(proc.tiles_touched, 0, dtype=torch.int32)
    total = int(b_incl[-1])
    n = min(total, budget) + 64  # some dead ranks past `total` as well
    kdb = key_depth_bits(gx * gx)
    key, payload = binning_key(proc, b_incl, n, total, gx, kdb)
    want_key, want_payload = binning_key_plain(
        b_incl, proc.tiles_touched, proc.rect_min, proc.rect_max,
        proc.mean2d, proc.conic, proc.opacity, proc.depth, proc.color, n,
        total, gx, kdb)
    torch.cuda.synchronize()
    assert torch.equal(key, want_key)
    assert torch.equal(payload, want_payload)


@pytest.mark.parametrize("ch", [1, 3])
def test_forward_tile_kernel_matches_plain(cuda, ch):
    proc = _proc(_scene(20000, cuda, seed=ch), 200, cuda)
    if ch == 1:
        proc = proc._replace(color=proc.color[:, :1].contiguous())
    gx = 13
    sb = sorted_bin(proc, gx, gx, 1 << 22)
    got = forward_tiles(sb, gx, ch)
    want, _, _ = forward_tiles_plain(sb.tile_bounds, sb.payload, gx, ch)
    torch.cuda.synchronize()
    assert_images_close(got.color, want.color, name="color")
    assert_images_close(got.depth, want.depth, loose=2e-2, name="depth")
    assert_images_close(got.final_T, want.final_T, name="final_T")
    assert fraction_equal(got.n_contrib, want.n_contrib) >= 0.999


def test_render_on_cuda_counts_launches(cuda):
    scene = _scene(5000, cuda, capacity=8000)
    cam = lookat_camera((0, 0, -4), (0, 0, 0), (0, 1, 0), 0.8, 0.8, 64, 64,
                        device="cpu")
    _kernels.reset_launch_counts()
    with torch.no_grad():
        out = render(scene, cam)
    torch.cuda.synchronize()
    assert _kernels.launch_counts() == {"binning_key": 1, "forward_tile": 1}
    assert out.color.is_cuda and torch.isfinite(out.color).all()
    assert out.color.shape == (64, 64, 3) and out.color.max() > 0


def test_render_on_cuda_without_compiler_raises(cuda, monkeypatch, tmp_path):
    monkeypatch.setattr(_kernels, "_libs", {})
    monkeypatch.setattr(_kernels, "BUILD_DIR", tmp_path)

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(_kernels, "nvcc_path", no_nvcc)
    scene = _scene(500, cuda)
    cam = lookat_camera((0, 0, -4), (0, 0, 0), (0, 1, 0), 0.8, 0.8, 32, 32,
                        device=cuda)
    with torch.no_grad(), pytest.raises(RuntimeError, match="nvcc"):
        render(scene, cam)
