"""Image, grid and video writers.

Counterpart of `gaussianeditor_tpu/utils/saving.py` (`_to_u8`,
`save_image`, `save_image_grid`, `save_video`): channels-last float
images in [0, 1] (or uint8) as 8-bit files. The JAX package writes with
imageio; the port writes PNG and GIF with Pillow, and mp4 through an
`ffmpeg` executable where one is on the PATH.
"""

from __future__ import annotations

import os
import shutil
import subprocess
from typing import Optional, Sequence

import numpy as np


def _to_u8(img: np.ndarray) -> np.ndarray:
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    return img


def _makedirs_for(path: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)


def save_image(path: str, img: np.ndarray) -> None:
    from PIL import Image

    _makedirs_for(path)
    Image.fromarray(_to_u8(img)).save(path)


def save_image_grid(path: str, images: Sequence[np.ndarray],
                    cols: Optional[int] = None) -> None:
    """Horizontal (or wrapped, `cols` a row) grid of same-size images."""
    imgs = [_to_u8(im) for im in images]
    h, w = imgs[0].shape[:2]
    assert all(im.shape[:2] == (h, w) for im in imgs)
    n = len(imgs)
    cols = cols or n
    rows = -(-n // cols)
    grid = np.zeros((rows * h, cols * w, 3), np.uint8)
    for i, im in enumerate(imgs):
        r, c = divmod(i, cols)
        grid[r * h:(r + 1) * h, c * w:(c + 1) * w] = im[..., :3]
    save_image(path, grid)


def _save_gif(path: str, frames, fps: int) -> str:
    from PIL import Image

    ims = [Image.fromarray(f[..., :3]) for f in frames]
    ims[0].save(path, save_all=True, append_images=ims[1:],
                duration=1000.0 / fps, loop=0)
    return path


def _save_mp4(path: str, frames, fps: int, ffmpeg: str) -> bool:
    """H.264 through ffmpeg's stdin; False if ffmpeg fails (say, an
    encoder without the odd sizes yuv444p allows)."""
    h, w = frames[0].shape[:2]
    cmd = [ffmpeg, "-y", "-loglevel", "error", "-f", "rawvideo",
           "-pix_fmt", "rgb24", "-s", f"{w}x{h}", "-r", str(fps), "-i", "-",
           "-pix_fmt", "yuv444p", path]
    data = b"".join(np.ascontiguousarray(f[..., :3]).tobytes()
                    for f in frames)
    proc = subprocess.run(cmd, input=data, capture_output=True)
    return proc.returncode == 0


def save_video(path: str, frames: Sequence[np.ndarray], fps: int = 30) -> str:
    """Write a turntable and return the path written. A `.gif` path is a
    GIF. Any other path is an mp4 where an `ffmpeg` executable is on the
    PATH and encodes it; otherwise (no ffmpeg, or ffmpeg failed) the
    frames go to a GIF beside it, `<stem>.gif`, as the JAX function falls
    back without an ffmpeg backend."""
    _makedirs_for(path)
    u8 = [_to_u8(f) for f in frames]
    if path.endswith(".gif"):
        return _save_gif(path, u8, fps)
    ffmpeg = shutil.which("ffmpeg")
    if ffmpeg is not None and _save_mp4(path, u8, fps, ffmpeg):
        return path
    return _save_gif(os.path.splitext(path)[0] + ".gif", u8, fps)
