"""Edge cases: tiny scenes (root-leaf BVH), CLI end-to-end, BVH toggles."""

import json
import subprocess
import sys

import numpy as np
import pytest
import jax.numpy as jnp

from parallel_ray_tracer_tpu.config import RenderConfig
from parallel_ray_tracer_tpu.models.scene import Scene
from parallel_ray_tracer_tpu import pipeline


@pytest.fixture()
def one_triangle_scene():
    return Scene(
        verts=np.array([[-2, 0, 0], [2, 0, 0], [0, 0, 3]], np.float32),
        faces=np.array([[0, 1, 2]], np.int32),
        mat_idx=np.zeros(1, np.int32),
        mats_kd=np.array([[0.6, 0.3, 0.2]], np.float32),
        mats_ks=np.zeros((1, 3), np.float32),
        mats_kr=np.zeros((1, 3), np.float32),
        lights_pos=np.array([[0.0, -5.0, 5.0]], np.float32),
        lights_kl=np.array([[20.0, 20.0, 20.0]], np.float32),
    )


class TestRootLeaf:
    """T <= leaf_size collapses the whole tree into a single leaf; every
    tracer must handle a root that is a leaf."""

    @pytest.mark.parametrize("width", [2, 4])
    def test_one_triangle_all_variants(self, one_triangle_scene, width):
        cfg = RenderConfig(
            width=32, height=32, bounces=2, tile_rows=32, tile_cols=32,
            bvh_heuristic=6, leaf_size=width,
        )
        pipe = pipeline.prepare(cfg, scene=one_triangle_scene)
        assert pipe.flat.n_nodes == 1
        ref = np.asarray(pipe.render(variant="bruteforce"))
        img_j = np.asarray(pipe.render(variant="jax"))
        img_g = np.asarray(pipe.render(variant="gpu", interpret=True))
        np.testing.assert_allclose(img_j, ref, atol=3e-5)
        np.testing.assert_allclose(img_g, ref, atol=3e-5)
        # The triangle must actually be visible.
        assert ref.std() > 0.01

    def test_no_lights_scene(self, one_triangle_scene):
        sc = one_triangle_scene
        sc = Scene(
            verts=sc.verts, faces=sc.faces, mat_idx=sc.mat_idx,
            mats_kd=sc.mats_kd, mats_ks=sc.mats_ks, mats_kr=sc.mats_kr,
            lights_pos=np.zeros((0, 3), np.float32),
            lights_kl=np.zeros((0, 3), np.float32),
        )
        cfg = RenderConfig(
            width=32, height=32, bounces=1, tile_rows=32, tile_cols=32,
            bvh_heuristic=1,
        )
        pipe = pipeline.prepare(cfg, scene=sc)
        img = np.asarray(pipe.render(variant="jax"))
        assert np.isfinite(img).all()


class TestUseBvhToggle:
    def test_no_bvh_pipeline(self, tiny_scene):
        cfg = RenderConfig(
            width=32, height=32, bounces=2, use_bvh=False,
            tile_rows=32, tile_cols=32,
        )
        pipe = pipeline.prepare(cfg, scene=tiny_scene)
        assert pipe.dbvh is None
        img = np.asarray(pipe.render())
        assert img.shape == (32, 32, 3)


class TestCliEndToEnd:
    def test_cli_subprocess(self, tmp_path):
        out_bmp = tmp_path / "o.bmp"
        out_json = tmp_path / "m.json"
        code = (
            "import jax; jax.config.update('jax_platforms','cpu');"
            "from parallel_ray_tracer_tpu.cli import main;"
            f"raise SystemExit(main(['--synthetic','100','--width','32',"
            f"'--height','32','--bounces','1','--variant','jax',"
            f"'--iterations','1','--warmup','0','--heuristic','1',"
            f"'--output',r'{out_bmp}','--metrics-json',r'{out_json}',"
            "'--quiet']))"
        )
        r = subprocess.run(
            [sys.executable, "-c", code], capture_output=True, timeout=300
        )
        assert r.returncode == 0, r.stderr.decode()[-500:]
        assert out_bmp.exists()
        rec = json.loads(out_json.read_text())
        assert rec["config"]["synthetic_triangles"] == 100
        assert len(rec["times_ms"]) == 1
