"""Comparison helpers shared by the port's tests and `chip_smoke.py`.

`assert_images_close` is a copy of `tests/helpers.py::assert_images_close`
(the JAX suite's image tolerance), kept here so that code which must not
import the JAX test helpers can apply the same bounds.
"""

from __future__ import annotations

import numpy as np


def _host(a) -> np.ndarray:
    if hasattr(a, "detach"):
        a = a.detach().cpu().numpy()
    return np.asarray(a)


def assert_images_close(a, b, tight=3e-5, loose=6e-3, frac=0.995,
                        name="image"):
    """Two numerically equivalent rasterizers can flip the alpha-cutoff
    test (alpha < 1/255) on borderline Gaussians through a different
    rounding order; each flip moves a pixel by up to ~alpha_min * color
    ~ 4e-3. So the vast majority of pixels must match tightly and all
    pixels within the cutoff-flip bound."""
    a, b = _host(a), _host(b)
    diff = np.abs(a - b)
    assert diff.max() <= loose, f"{name}: max diff {diff.max()} > {loose}"
    ok = np.mean(diff <= tight)
    assert ok >= frac, f"{name}: only {ok:.4f} of pixels within {tight}"


def fraction_equal(a, b) -> float:
    """Share of entries where `a` and `b` are equal."""
    return float(np.mean(_host(a) == _host(b)))
