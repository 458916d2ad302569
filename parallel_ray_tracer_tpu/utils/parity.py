"""Image parity against the reference binary's own 1080p frames.

The fixtures under tests/goldens/reference/ were written by the unmodified
reference CPU renderer (default config: 1920x1080, 4 bounces, seed 1). Its
writer quantizes float->byte by truncation (x255), and -ffast-math
reassociation differs from XLA's, so identical shading can land one byte
apart; a handful of silhouette/tie-break pixels (another triangle wins a
near-equal depth race) can differ arbitrarily. The bounds sit ~10x above
the full-frame measurements (frac_any <= 3.6e-4, frac_big <= 1.4e-4, mean
<= 0.009) and far below any systematic shading or camera bias, which would
push frac_any toward 1 and the mean past 0.5.
"""

from __future__ import annotations

import gzip
import os
from typing import Dict

import numpy as np

from .bmp import parse_bmp

FIXTURE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "tests", "goldens", "reference",
)
BOUNDS = {"frac_any": 5e-3, "frac_big": 2e-3, "mean": 0.1}


def reference_frame(scene: str) -> np.ndarray:
    """(1080, 1920, 3) uint8 RGB as the reference binary wrote it."""
    path = os.path.join(FIXTURE_DIR, f"{scene}_1080p.bmp.gz")
    with gzip.open(path, "rb") as f:
        return parse_bmp(f.read())


def quantize(img) -> np.ndarray:
    """Float image -> bytes exactly like the reference writer (clamp then
    truncate, cpu/src/bmp_writer.c:88-95)."""
    return (np.clip(np.asarray(img), 0.0, 1.0) * 255.0).astype(np.uint8)


def parity(ours_u8: np.ndarray, ref_u8: np.ndarray) -> Dict[str, float]:
    """Fraction of pixels off at all, off by more than 2/255, mean error."""
    d = np.abs(ours_u8.astype(np.int32) - ref_u8.astype(np.int32)).max(axis=-1)
    return {
        "frac_any": float((d > 0).mean()),
        "frac_big": float((d > 2).mean()),
        "mean": float(d.mean()),
    }


def within_bounds(stats: Dict[str, float]) -> bool:
    return all(stats[k] < b for k, b in BOUNDS.items())
