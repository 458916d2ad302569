"""Variant resolution + band rendering on the served path.

The per-ray GPU kernel must be (a) the default ("auto" -> "gpu") whatever
the prepared state, (b) reachable from the checkpoint/resume band renderer,
bit-identical to the same rows of a full-frame render.
"""

import dataclasses

import numpy as np
import pytest

from parallel_ray_tracer_tpu.config import RenderConfig
from parallel_ray_tracer_tpu import pipeline


CFG = dict(width=64, height=64, bounces=2, tile_rows=32, tile_cols=32,
           bvh_heuristic=6)


@pytest.fixture
def on_gpu(monkeypatch):
    """Resolution as it happens on a GPU backend (no kernel runs)."""
    monkeypatch.setattr(pipeline.jax, "default_backend", lambda: "gpu")


class TestResolvedVariant:
    def test_auto_picks_gpu_kernel(self, tiny_scene, on_gpu):
        pipe = pipeline.prepare(RenderConfig(**CFG), scene=tiny_scene)
        assert pipe.cfg.variant == "auto"
        assert pipe.resolved_variant() == "gpu"

    def test_auto_keeps_gpu_with_spheres(self, tiny_scene, on_gpu):
        """Spheres ride a dense post-pass after the kernel (ops/spheres.py),
        so auto stays on the kernel."""
        scene = dataclasses.replace(
            tiny_scene,
            spheres_center=np.array([[0.0, 0.0, 1.5]], np.float32),
            spheres_radius=np.array([0.5], np.float32),
            spheres_mat=np.array([1], np.int32),
        )
        pipe = pipeline.prepare(RenderConfig(**CFG), scene=scene)
        assert pipe.resolved_variant() == "gpu"

    def test_auto_keeps_gpu_without_fast_light(self, tiny_scene, on_gpu):
        pipe = pipeline.prepare(
            RenderConfig(fast_light=False, **CFG), scene=tiny_scene
        )
        assert pipe.resolved_variant() == "gpu"

    def test_no_bvh_means_bruteforce(self, tiny_scene):
        pipe = pipeline.prepare(
            RenderConfig(use_bvh=False, **CFG), scene=tiny_scene
        )
        assert pipe.resolved_variant() == "bruteforce"

    def test_explicit_variant_wins(self, tiny_scene):
        pipe = pipeline.prepare(RenderConfig(**CFG), scene=tiny_scene)
        assert pipe.resolved_variant("jax") == "jax"


class TestGpuBand:
    def test_band_bit_identical_to_full_frame_rows(self, tiny_scene):
        """--checkpoint with the gpu kernel: bands must equal the same rows
        of a whole-frame render exactly."""
        pipe = pipeline.prepare(RenderConfig(**CFG), scene=tiny_scene)
        full = np.asarray(pipe.render(variant="gpu", interpret=True))
        for y0 in (0, 32):
            band = np.asarray(
                pipe.render_band(y0, 32, variant="gpu", interpret=True)
            )
            np.testing.assert_array_equal(band, full[y0 : y0 + 32])

    def test_band_default_variant_resolves(self, tiny_scene):
        """render_band with no variant follows the auto resolution."""
        pipe = pipeline.prepare(RenderConfig(**CFG), scene=tiny_scene)
        band = np.asarray(pipe.render_band(0, 32, interpret=True))
        gpu = np.asarray(
            pipe.render_band(0, 32, variant="gpu", interpret=True)
        )
        np.testing.assert_array_equal(band, gpu)
