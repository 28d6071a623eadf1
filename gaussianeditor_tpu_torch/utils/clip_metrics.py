"""CLIP similarity metrics for edit evaluation.

Counterpart of `gaussianeditor_tpu/utils/clip_metrics.py`
(`ClipEmbedder`, `compute_clip_directional`, `TorchClipSimilarity`),
copied: the metric is numpy over embeddings, and the JAX package's
embedder is already the torch CLIP model. Real CLIP needs the `clip`
package and its downloaded weights; `TorchClipSimilarity` raises
ImportError without the package, and `compute_clip_directional` takes
any embedder of the protocol, so tests pass a fake.
"""

from __future__ import annotations

from typing import Protocol, Sequence, runtime_checkable

import numpy as np


@runtime_checkable
class ClipEmbedder(Protocol):
    def embed_image(self, image: np.ndarray) -> np.ndarray: ...
    def embed_text(self, text: str) -> np.ndarray: ...


def _norm(v: np.ndarray) -> np.ndarray:
    return v / (np.linalg.norm(v) + 1e-10)


def compute_clip_directional(
    embedder: ClipEmbedder,
    origin_images: Sequence[np.ndarray],
    edited_images: Sequence[np.ndarray],
    origin_text: str,
    edited_text: str,
) -> dict:
    """Directional similarity: cos(delta_image, delta_text) averaged over
    views, and the edited images' similarity to the edited text."""
    dt = _norm(embedder.embed_text(edited_text)
               - embedder.embed_text(origin_text))
    sims, dir_sims = [], []
    for o, e in zip(origin_images, edited_images):
        eo = _norm(embedder.embed_image(o))
        ee = _norm(embedder.embed_image(e))
        di = _norm(ee - eo)
        dir_sims.append(float(np.dot(di, dt)))
        sims.append(float(np.dot(ee, _norm(embedder.embed_text(edited_text)))))
    return {
        "clip_similarity": float(np.mean(sims)),
        "clip_directional": float(np.mean(dir_sims)),
    }


class TorchClipSimilarity:
    """openai/CLIP ViT-B/32 embedder on `device` (needs the `clip`
    package and its downloaded weights)."""

    def __init__(self, device="cuda"):
        try:
            import clip
        except ImportError as e:
            raise ImportError(
                "openai-clip is unavailable; pass a custom ClipEmbedder"
            ) from e
        from gaussianeditor_tpu_torch import resolve_device

        self.device = resolve_device(device)
        self.model, self.preprocess = clip.load("ViT-B/32",
                                                device=self.device)

    def embed_image(self, image: np.ndarray) -> np.ndarray:
        import PIL.Image
        import torch

        im = PIL.Image.fromarray(
            (np.clip(image, 0, 1) * 255).astype(np.uint8)
        )
        with torch.no_grad():
            x = self.preprocess(im)[None].to(self.device)
            return self.model.encode_image(x)[0].float().cpu().numpy()

    def embed_text(self, text: str) -> np.ndarray:
        import clip
        import torch

        with torch.no_grad():
            t = clip.tokenize([text]).to(self.device)
            return self.model.encode_text(t)[0].float().cpu().numpy()
