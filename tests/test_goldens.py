"""Committed golden renders (SURVEY.md §4(c)): regressions in any layer —
parsing, camera, intersection, BVH, shading, bounce loop — show up as image
drift against these fixtures. Goldens were produced by the brute-force
oracle path at 96x54, 4 bounces, default camera, and are stored as float16
(quantization ~1e-3 bounds the comparison tolerance). The scenes load from
the repo's bundled snapshots (assets/*.npz); the GPU kernels run in the
Pallas interpreter here."""

import os

import numpy as np
import pytest

from parallel_ray_tracer_tpu.config import RenderConfig
from parallel_ray_tracer_tpu import pipeline

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")


def _golden(name):
    return np.load(os.path.join(GOLDEN_DIR, name))["image"].astype(np.float32)


@pytest.mark.parametrize("scene", ["car_only", "car_boxed"])
@pytest.mark.parametrize("variant", ["jax", "bruteforce", "gpu"])
def test_render_matches_golden(scene, variant):
    golden = _golden(f"{scene}_96x54_b4.npz")
    cfg = RenderConfig(
        width=96, height=54, scene=scene, bounces=4, bvh_heuristic=6,
        tile_rows=32, tile_cols=32,
    )
    pipe = pipeline.prepare(cfg)
    img = np.asarray(pipe.render(variant=variant, interpret=True))
    # fp16 storage + cross-path reassociation: tolerance dominated by the
    # golden's quantization step.
    np.testing.assert_allclose(img, golden, atol=2e-3)
