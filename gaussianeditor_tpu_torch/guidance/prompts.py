"""View-dependent prompt processing and prompt-library lookup.

Counterpart of `gaussianeditor_tpu/guidance/prompts.py`, copied
(`DirectionConfig`, `camera_angles`, `view_direction`, `PromptProcessor`,
the Perp-Neg weights and combination, `get_debiased_prompts`,
`BertViewProbe`, `DEFAULT_PROMPT_LIBRARY`, `resolve_prompt`): the math is
numpy on the host, so both packages give the same strings and the same
numbers. The reference's prompt processors
(`threestudio/models/prompt_processors/base.py:226-295`) classify each
view as side / front / back / overhead from the camera's azimuth and
elevation and template "<prompt>, <dir> view"; the CLIP embedding cache
they add is left to whichever guidance backend consumes the strings.
`BertViewProbe` needs `transformers` and its weights, as in JAX.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence

import numpy as np

from gaussianeditor_tpu_torch.core.cameras import Camera


@dataclasses.dataclass
class DirectionConfig:
    """Thresholds in degrees (reference defaults, base.py:241-266)."""

    overhead_threshold: float = 60.0
    front_threshold: float = 45.0
    back_threshold: float = 45.0


def camera_angles(camera: Camera, center=None):
    """(azimuth_deg, elevation_deg) of the camera position about `center`
    — the quantities the reference datamodules feed the processor."""
    if center is None:
        center = np.zeros(3)
    pos = (camera.cam_pos.detach().cpu().numpy().astype(np.float64)
           - np.asarray(center))
    r = np.linalg.norm(pos)
    elevation = math.degrees(math.asin(np.clip(pos[1] / max(r, 1e-9), -1, 1)))
    azimuth = math.degrees(math.atan2(pos[0], pos[2]))
    return azimuth, elevation


def view_direction(azimuth_deg: float, elevation_deg: float,
                   cfg: Optional[DirectionConfig] = None) -> str:
    """base.py:247-266: overhead wins; front is azimuth in
    (-front_thr, front_thr]; back is |azimuth| > 180 - back_thr; else side."""
    cfg = cfg or DirectionConfig()
    if elevation_deg > cfg.overhead_threshold:
        return "overhead"
    a = ((azimuth_deg + 180.0) % 360.0) - 180.0
    if -cfg.front_threshold < a <= cfg.front_threshold:
        return "front"
    if a > 180.0 - cfg.back_threshold or a <= -180.0 + cfg.back_threshold:
        return "back"
    return "side"


@dataclasses.dataclass
class PromptProcessor:
    """Templated per-view prompts (PromptProcessorOutput role)."""

    prompt: str
    negative_prompt: str = ""
    use_view_dependent: bool = True
    direction_config: DirectionConfig = dataclasses.field(
        default_factory=DirectionConfig
    )

    def for_camera(self, camera: Camera, center=None) -> str:
        if not self.use_view_dependent:
            return self.prompt
        az, el = camera_angles(camera, center)
        d = view_direction(az, el, self.direction_config)
        return f"{self.prompt}, {d} view"

    def for_cameras(self, cameras: Sequence[Camera], center=None) -> List[str]:
        return [self.for_camera(c, center) for c in cameras]


# --- Perp-Neg view-dependent negative prompting -------------------------
# Reference: prompt_processors/base.py:80-165 (get_text_embeddings_perp_neg)
# with the canonical decay tuples (:198-205) and utils/ops.py:423-442
# (shifted_expotional_decay / perpendicular_component). The reference
# works directly on CLIP embeddings; this port splits the math into (a)
# the embedding-free blend/weight computation per view (testable here)
# and (b) `perp_neg_combine` applying the weighted perpendicular
# components to any embedding/noise arrays.

# a * exp(-b * r) + c, constants chosen so the weight hits 0 at r = 1
PERP_NEG_F_SB = (1.0, 0.5, -0.606)
PERP_NEG_F_FSB = (1.0, 0.5, +0.967)
PERP_NEG_F_FS = (4.0, 0.5, -2.426)
PERP_NEG_F_SF = (4.0, 0.5, -2.426)

_DIR_IDX = {"side": 0, "front": 1, "back": 2, "overhead": 3}


def shifted_exponential_decay(a: float, b: float, c: float, r: float) -> float:
    return a * math.exp(-b * r) + c


@dataclasses.dataclass
class PerpNegViewPrompt:
    """Embedding-free description of one view's Perp-Neg prompt set:
    pos = sum(coeff * dir_embedding[idx]); negatives are (dir_idx,
    guidance_weight) pairs (weights <= 0, as in the reference)."""

    pos_blend: List  # [(dir_idx, coeff)]
    negatives: List  # [(dir_idx, weight)]


def perp_neg_view_prompt(azimuth_deg: float, elevation_deg: float,
                         cfg: Optional[DirectionConfig] = None
                         ) -> PerpNegViewPrompt:
    """base.py:104-152: overhead is pure; |azimuth| < 90 interpolates
    front<->side with [front, side] negatives; otherwise side<->back with
    [side, front] negatives."""
    d = view_direction(azimuth_deg, elevation_deg, cfg)
    if d == "overhead":
        return PerpNegViewPrompt(pos_blend=[(3, 1.0)], negatives=[])
    azi = ((azimuth_deg + 180.0) % 360.0) - 180.0
    if abs(azi) < 90.0:
        r = 1.0 - abs(azi) / 90.0  # 1 = full front, 0 = full side
        return PerpNegViewPrompt(
            pos_blend=[(1, r), (0, 1.0 - r)],
            negatives=[
                (1, -shifted_exponential_decay(*PERP_NEG_F_FS, r)),
                (0, -shifted_exponential_decay(*PERP_NEG_F_SF, 1.0 - r)),
            ],
        )
    r = 2.0 - abs(azi) / 90.0  # 1 = full side, 0 = full back
    return PerpNegViewPrompt(
        pos_blend=[(0, r), (2, 1.0 - r)],
        negatives=[
            (0, -shifted_exponential_decay(*PERP_NEG_F_SB, r)),
            (1, -shifted_exponential_decay(*PERP_NEG_F_FSB, r)),
        ],
    )


def perpendicular_component(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Component of x perpendicular to y (utils/ops.py:431-442)."""
    num = float(np.sum(x * y))
    den = max(float(np.sum(y * y)), 1e-6)
    return x - (num / den) * y


def perp_neg_combine(e_pos: np.ndarray, e_uncond: np.ndarray,
                     negatives) -> np.ndarray:
    """Perp-Neg noise combination (Armandpour et al.; the consumption
    side of get_text_embeddings_perp_neg): delta = (pos - uncond) +
    sum_i w_i * perp(neg_i - uncond, pos - uncond). Operates on any
    same-shape arrays (noise predictions or embeddings); the caller
    applies its guidance scale to the returned delta."""
    d_pos = e_pos - e_uncond
    accum = np.array(d_pos, np.float32)
    for e_neg, w in negatives:
        accum = accum + float(w) * perpendicular_component(
            np.asarray(e_neg) - e_uncond, d_pos
        )
    return accum


def get_debiased_prompts(prompt: str, view_probe,
                         n_views: int = 4,
                         mask_ids: Optional[Sequence[int]] = None
                         ) -> List[str]:
    """BERT-style prompt debiasing (prompt_processors/base.py:443-501):
    for each candidate word, drop it and re-probe the view-word
    distribution; if the pointwise mutual information
    `full / lerp(part, full, 0.5)` for a view falls below 0.95, that
    word is removed from THAT view's prompt (it was biasing the view).

    `view_probe(text) -> array [n_views]` is the masked-LM probability
    of each view word in "This image is depicting a [MASK] view of
    {text}" (see `BertViewProbe`); injecting it keeps this logic
    hermetically testable without BERT weights."""
    words = prompt.split(" ")
    prompts = [list(words) for _ in range(n_views)]
    full = np.asarray(view_probe(prompt), np.float64)
    ids = list(mask_ids) if mask_ids is not None else range(len(words))
    for idx in ids:
        part_prompt = " ".join(words[:idx] + words[idx + 1:])
        part = np.asarray(view_probe(part_prompt), np.float64)
        pmi = full / (0.5 * (part + full))
        for i in range(n_views):
            if pmi[i] < 0.95:
                prompts[i][idx] = ""
    return [" ".join(w for w in p if w) for p in prompts]


class BertViewProbe:
    """Masked-LM view-word probe for `get_debiased_prompts` — the
    reference's BertForMaskedLM path (base.py:446-472). Import-gated:
    needs `transformers` weights locally; tests use a fake probe."""

    def __init__(self, model_name: str = "bert-base-uncased",
                 view_names: Sequence[str] = ("side", "front", "back",
                                              "overhead")):
        import torch
        from transformers import AutoTokenizer, BertForMaskedLM

        self.torch = torch
        self.tokenizer = AutoTokenizer.from_pretrained(model_name)
        self.model = BertForMaskedLM.from_pretrained(model_name)
        ids = self.tokenizer(" ".join(view_names),
                             return_tensors="pt").input_ids[0]
        self.view_ids = ids[1:1 + len(view_names)]

    def __call__(self, prompt: str):
        torch = self.torch
        text = f"This image is depicting a [MASK] view of {prompt}"
        tokens = self.tokenizer(text, padding="max_length", truncation=True,
                                add_special_tokens=True, return_tensors="pt")
        mask_idx = torch.where(
            tokens.input_ids == self.tokenizer.mask_token_id
        )[1]
        with torch.no_grad():
            logits = self.model(**tokens).logits
        probs = torch.softmax(logits[0, mask_idx], dim=-1)[0, self.view_ids]
        probs = probs / probs.sum()
        return probs.numpy()


# --- prompt library lookup (base.py:297-298, :417-437) ---

# A small library in the reference's JSON shape ({"dreamfusion": [prompt,
# ...]}); `library_path` loads a user file in the same format.
DEFAULT_PROMPT_LIBRARY = {
    "dreamfusion": [
        "a DSLR photo of a hamburger",
        "a DSLR photo of a panda wearing a chef hat",
        "a marble statue of a lion",
        "a ripe strawberry on a plate",
        "a zoomed out DSLR photo of a wizard raccoon casting a spell",
        "a blue jay standing on a large basket of rainbow macarons",
        "a plush dragon toy",
        "an astronaut riding a horse",
    ]
}


def resolve_prompt(prompt: str, library: Optional[dict] = None,
                   library_path: Optional[str] = None) -> str:
    """A prompt of the form "lib:keyword1_keyword2" resolves to the unique
    library entry containing every keyword (case-insensitive); zero or
    several matches raise ValueError. Other prompts pass through."""
    if not prompt.startswith("lib:"):
        return prompt
    if library is None:
        if library_path is not None:
            import json

            with open(library_path) as f:
                library = json.load(f)
        else:
            library = DEFAULT_PROMPT_LIBRARY
    keywords = prompt[4:].lower().split("_")
    candidate = None
    for entry in library["dreamfusion"]:
        if all(k in entry.lower() for k in keywords):
            if candidate is not None:
                raise ValueError(
                    f"Multiple prompts matched with keywords {keywords} "
                    "in library"
                )
            candidate = entry
    if candidate is None:
        raise ValueError(
            f"Cannot find prompt with keywords {keywords} in library"
        )
    return candidate
