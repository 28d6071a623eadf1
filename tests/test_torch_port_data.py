"""Port vs JAX: COLMAP reading and writing, CamScene, and the viewer's
scene and camera loading (`apps/webui.py::build_state`)."""

import os

import numpy as np
import pytest

from gaussianeditor_tpu.core.transforms import rotmat_to_quat
from gaussianeditor_tpu.data.camera_scene import CamScene as JCamScene
from gaussianeditor_tpu.data.colmap import read_colmap_model as jread_model
from gaussianeditor_tpu.models import ply as jply
from gaussianeditor_tpu_torch.apps.webui import build_state
from gaussianeditor_tpu_torch.data.camera_scene import CamScene
from gaussianeditor_tpu_torch.data.colmap import (
    ColmapCamera,
    ColmapImage,
    read_colmap_model,
    write_colmap_model_bin,
)
from tests.helpers import random_scene
from tests.torch_port_helpers import (  # noqa: F401
    assert_camera_equal,
    one_torch_thread,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _views(n_views=5):
    """COLMAP images on a ring of radius 3, looking at the origin."""
    imgs = {}
    for i in range(n_views):
        th = 2 * np.pi * i / n_views + 0.1
        eye = np.array([3 * np.cos(th), 0.4, 3 * np.sin(th)])
        fwd = -eye / np.linalg.norm(eye)
        right = np.cross(fwd, [0, 1, 0])
        right /= np.linalg.norm(right)
        down = np.cross(fwd, right)
        w2c = np.stack([right, down, fwd], axis=1).T
        imgs[i + 1] = ColmapImage(i + 1, rotmat_to_quat(w2c).astype(np.float64),
                                  -w2c @ eye, 1 + i % 2, f"img_{i}.jpg")
    return imgs


CAMS = {1: ColmapCamera(1, "PINHOLE", 640, 480,
                        np.array([500.0, 510.0, 320.0, 240.0])),
        2: ColmapCamera(2, "SIMPLE_PINHOLE", 320, 240,
                        np.array([260.0, 160.0, 120.0]))}


def _write_txt(sparse, cams, imgs):
    os.makedirs(sparse, exist_ok=True)
    with open(os.path.join(sparse, "cameras.txt"), "w") as f:
        f.write("# CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[]\n")
        for c in cams.values():
            f.write(f"{c.camera_id} {c.model} {c.width} {c.height} "
                    + " ".join(repr(float(p)) for p in c.params) + "\n")
    with open(os.path.join(sparse, "images.txt"), "w") as f:
        f.write("# IMAGE_ID, QW, QX, QY, QZ, TX, TY, TZ, CAMERA_ID, NAME\n")
        for im in imgs.values():
            vals = [*im.qvec, *im.tvec]
            f.write(f"{im.image_id} " + " ".join(repr(float(v)) for v in vals)
                    + f" {im.camera_id} {im.name}\n")
            f.write("12.5 40.0 -1 80.0 16.5 3\n")  # POINTS2D: x, y, id


def _write_points(sparse):
    with open(os.path.join(sparse, "points3D.txt"), "w") as f:
        rng = np.random.RandomState(0)
        for j in range(30):
            x, y, z = rng.uniform(-1, 1, 3)
            r, g, b = rng.randint(0, 255, 3)
            f.write(f"{j} {x} {y} {z} {r} {g} {b} 0.5 1 0\n")


@pytest.fixture(params=["bin", "txt"])
def workspace(request, tmp_path):
    sparse = str(tmp_path / "sparse" / "0")
    if request.param == "bin":
        write_colmap_model_bin(sparse, CAMS, _views())
    else:
        _write_txt(sparse, CAMS, _views())
    _write_points(sparse)
    return str(tmp_path)


def test_read_colmap_model_matches(workspace):
    sparse = os.path.join(workspace, "sparse", "0")
    cams, imgs = read_colmap_model(sparse)
    jcams, jimgs = jread_model(sparse)
    assert cams.keys() == jcams.keys() and imgs.keys() == jimgs.keys()
    for k, c in cams.items():
        j = jcams[k]
        assert (c.model, c.width, c.height, c.focal) == (
            j.model, j.width, j.height, j.focal)
        np.testing.assert_array_equal(c.params, j.params)
    for k, im in imgs.items():
        j = jimgs[k]
        assert (im.camera_id, im.name) == (j.camera_id, j.name)
        np.testing.assert_array_equal(im.qvec, j.qvec)
        np.testing.assert_array_equal(im.tvec, j.tvec)
        np.testing.assert_array_equal(im.rotmat(), j.rotmat())


@pytest.mark.parametrize("h,w", [(128, 128), (48, 80), (0, 0)])
def test_camscene_matches(workspace, h, w):
    got = CamScene(workspace, h=h, w=w, device="cpu")
    want = JCamScene(workspace, h=h, w=w)
    assert len(got) == len(want) == 5
    assert got.image_names == want.image_names
    assert got.cameras_extent == pytest.approx(want.cameras_extent, rel=1e-12)
    for tc, jc in zip(got.cameras, want.cameras):
        assert_camera_equal(tc, jc)
    for a, b in zip(got.load_points(), want.load_points()):
        np.testing.assert_array_equal(a, b)


def test_build_state_loads_at_4x_capacity(workspace):
    js = random_scene(30, seed=4, max_sh_degree=1)
    ply = os.path.join(workspace, "scene.ply")
    jply.save_ply(js, ply)
    state = build_state(ply, workspace, device="cpu")
    assert state.scene.capacity == 120 and int(state.scene.n_alive) == 30
    assert len(state.cameras) == 5
    assert state.cameras[0].height == state.cameras[0].width == 512
    want = JCamScene(workspace, h=512, w=512)
    assert state.cameras_extent == pytest.approx(want.cameras_extent,
                                                 rel=1e-12)
    np.testing.assert_allclose(state.center,
                               np.asarray(js.params.xyz).mean(axis=0),
                               rtol=1e-5, atol=1e-6)
