"""Wonder3D image-to-3D subprocess adapter for the Add pipeline.

Counterpart of `gaussianeditor_tpu/edit/wonder3d_adapter.py`
(`mvdiffusion_command`, `nsr_command`, `Wonder3DGenerator`). The
reference shells out to its vendored Wonder3D checkout three times
(`threestudio/systems/GassuianEditorAdd.py:121-157`):

  1. `accelerate launch test_mvdiffusion_seq.py ...` -- multiview
     diffusion producing 14 color and normal predictions,
  2. `python launch.py --config configs/neuralangelo-ortho-wmask.yaml
     ... --train` in instant-nsr-pl -- NeuS reconstruction to
     `inpaint_mesh.obj`,
  3. `python train_from_mesh.py --mesh ... --prompt ...` -- mesh to
     Gaussians with ip2p texture refinement.

Stages 1-2 run as subprocesses against any Wonder3D checkout, with the
reference's cache layout and skip-if-cached rule; stage 3 runs in
process through `edit/mesh_to_gs.py`, on `device`. The stage commands
are built by pure functions and run by an injectable runner, so a test
drives the whole pipeline with a stub that writes the expected files.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
from typing import Callable, List, Optional, Sequence

import numpy as np


def mvdiffusion_command(python_prefix: str, save_dir: str, root_dir: str,
                        filename: str = "removed_bg.png") -> List[str]:
    """Stage-1 command line (GassuianEditorAdd.py:121-129)."""
    return (
        f"{python_prefix}/bin/accelerate launch --config_file 1gpu.yaml "
        f"test_mvdiffusion_seq.py --save_dir {save_dir} "
        f"--config configs/mvdiffusion-joint-ortho-6views.yaml "
        f"validation_dataset.root_dir={root_dir} "
        f"validation_dataset.filepaths=[{filename}]"
    ).split(" ")


def nsr_command(python_prefix: str, save_dir: str, mv_image_dir: str
                ) -> List[str]:
    """Stage-2 command line (GassuianEditorAdd.py:131-142)."""
    return (
        f"{python_prefix}/bin/python launch.py "
        f"--config configs/neuralangelo-ortho-wmask.yaml "
        f"--save_dir {save_dir} --gpu 0 --train "
        f"dataset.root_dir={os.path.dirname(mv_image_dir)} "
        f"dataset.scene={os.path.basename(mv_image_dir)}"
    ).split(" ")


def _default_runner(cmd: Sequence[str], cwd: str) -> None:
    proc = subprocess.Popen(list(cmd), cwd=cwd)
    proc.wait()
    if proc.returncode != 0:
        raise RuntimeError(
            f"subprocess failed (rc={proc.returncode}): {' '.join(cmd)}"
        )


@dataclasses.dataclass
class Wonder3DGenerator:
    """`ObjectGenerator` backed by a Wonder3D checkout.

    wonder3d_root must contain `test_mvdiffusion_seq.py` and an
    `instant-nsr-pl/` subdirectory (the layout of the reference's
    vendored `threestudio/utils/wonder3D`). The runner is injectable for
    tests; `python_prefix` defaults to the current interpreter's prefix
    (the reference uses `sys.prefix`)."""

    wonder3d_root: str
    cache_dir: str
    python_prefix: str = sys.prefix
    cache_overwrite: bool = False
    refine_prompt: str = ""
    guidance: Optional[object] = None    # ip2p refinement for stage 3
    n_gaussians: int = 20000
    runner: Callable[[Sequence[str], str], None] = dataclasses.field(
        default=None
    )
    device: str = "cuda"                 # where the object scene is built

    def __post_init__(self):
        if self.runner is None:
            self.runner = _default_runner

    # cache layout (GassuianEditorAdd.py:61-69)
    @property
    def mv_image_dir(self) -> str:
        return os.path.join(self.cache_dir, "multiview_pred_images")

    @property
    def mesh_path(self) -> str:
        return os.path.join(self.cache_dir, "inpaint_mesh.obj")

    def _remove_background(self, image: np.ndarray) -> np.ndarray:
        """RGBA cutout via rembg when available (GassuianEditorAdd.py:
        112-113); otherwise treat near-white as background."""
        img = np.clip(np.asarray(image, np.float32), 0, 1)
        if img.shape[-1] == 4:
            return img
        try:
            import rembg
            from PIL import Image

            out = rembg.remove(
                Image.fromarray((img * 255).astype(np.uint8))
            )
            return np.asarray(out, np.float32) / 255.0
        except ImportError:
            alpha = (img.max(axis=-1) < 0.98).astype(np.float32)
            return np.concatenate([img, alpha[..., None]], axis=-1)

    def __call__(self, image: np.ndarray, prompt: str):
        from PIL import Image

        from gaussianeditor_tpu_torch.edit.mesh_to_gs import mesh_to_gaussians

        os.makedirs(self.mv_image_dir, exist_ok=True)
        rgba = self._remove_background(image)
        removed_bg_path = os.path.join(self.cache_dir, "removed_bg.png")
        Image.fromarray(
            (np.clip(rgba, 0, 1) * 255).astype(np.uint8)
        ).save(removed_bg_path)

        # stage 1: multiview diffusion (skip when the 14 predictions
        # are cached, GassuianEditorAdd.py:120)
        if self.cache_overwrite or len(os.listdir(self.mv_image_dir)) != 14:
            self.runner(
                mvdiffusion_command(self.python_prefix, self.mv_image_dir,
                                    self.cache_dir),
                self.wonder3d_root,
            )

        # stage 2: NeuS mesh reconstruction
        if self.cache_overwrite or not os.path.exists(self.mesh_path):
            self.runner(
                nsr_command(self.python_prefix, self.cache_dir,
                            self.mv_image_dir),
                os.path.join(self.wonder3d_root, "instant-nsr-pl"),
            )
        if not os.path.exists(self.mesh_path):
            raise RuntimeError(
                f"Wonder3D pipeline produced no mesh at {self.mesh_path}"
            )

        # stage 3: mesh -> Gaussians, in-process (train_from_mesh role);
        # optional ip2p texture refinement mirrors train_from_mesh.py's
        # phase 2 (:140-173)
        scene = mesh_to_gaussians(self.mesh_path,
                                  n_samples=self.n_gaussians,
                                  device=self.device)
        if self.guidance is not None:
            from gaussianeditor_tpu_torch.edit.mesh_to_gs import (
                refine_with_guidance,
            )

            scene = refine_with_guidance(
                scene, self.guidance, self.refine_prompt or prompt
            )
        return scene
