"""Test harness: CPU backend with 8 virtual devices, one card-test marker.

Mesh/sharding logic is validated on a virtual device mesh
(XLA_FLAGS=--xla_force_host_platform_device_count) per SURVEY.md §4(e).
Tests that need the GPU carry the `gpu` marker and skip elsewhere; the
GPU kernels run here through the Pallas interpreter. On the card:
`python -m pytest tests/ -m gpu` (and `python chip_smoke.py`).
"""

import os

# Virtual host devices must be requested before the backend starts.
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "gpu: needs a GPU backend; skipped without one "
        "(run on the card with `pytest -m gpu`)",
    )


@pytest.fixture(autouse=True)
def _skip_card_tests_without_gpu(request):
    """Decided per test at run time, so every xdist worker collects the
    same set whatever backend it would see."""
    if request.node.get_closest_marker("gpu") is not None:
        if jax.default_backend() != "gpu":
            pytest.skip(f"needs a GPU (JAX backend: {jax.default_backend()})")


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module():
    """Bound XLA compile-state growth across the suite.

    A whole-suite run has SIGABRTed inside backend_compile_and_load under
    accumulated compile load (round-3 verdict); dropping jit caches at
    module boundaries keeps per-process live compilations to one module's
    worth. Disable with RT_TEST_NO_CLEARCACHE=1 when iterating on a
    single module (caches then persist across its parametrizations)."""
    yield
    if not os.environ.get("RT_TEST_NO_CLEARCACHE"):
        jax.clear_caches()

REPO_ASSETS = os.path.join(os.path.dirname(os.path.dirname(__file__)), "assets")


@pytest.fixture(scope="session")
def car_only_scene():
    from parallel_ray_tracer_tpu.models.scene import load_scene_npz

    return load_scene_npz(os.path.join(REPO_ASSETS, "car_only.npz"))


def blocker_cloud_scene(with_spheres: bool = False):
    """Floor quad (z=0 plane) + a cloud of small blockers above it.

    Built in the camera's native convention (z up, camera looks along
    +y; cpu/src/cam.c): the DEFAULT camera at (0, -9, 3) frames the
    whole scene, so parity assertions on its renders are non-vacuous."""
    from parallel_ray_tracer_tpu.models.scene import Scene

    rng = np.random.RandomState(7)
    verts = [[-6, -6, 0], [6, -6, 0], [6, 6, 0], [-6, 6, 0]]
    faces = [[0, 1, 2], [0, 2, 3]]
    mat_idx = [0, 0]
    for k in range(30):
        c = rng.uniform(-3, 3, 3).astype(np.float32)
        c[2] = rng.uniform(0.5, 3.0)
        base = len(verts)
        for off in rng.normal(0, 0.35, (3, 3)):
            verts.append((c + off).tolist())
        faces.append([base, base + 1, base + 2])
        mat_idx.append(1 + (k % 2))
    spheres = {}
    if with_spheres:
        spheres = dict(
            spheres_center=np.asarray(
                [[0.0, 0.0, 1.0], [2.0, 1.5, 0.8], [-2.5, -1.0, 1.4]],
                np.float32,
            ),
            spheres_radius=np.asarray([0.8, 0.6, 1.0], np.float32),
            spheres_mat=np.asarray([1, 2, 0], np.int32),
        )
    return Scene(
        verts=np.asarray(verts, np.float32),
        faces=np.asarray(faces, np.int32),
        mat_idx=np.asarray(mat_idx, np.int32),
        mats_kd=np.asarray(
            [[0.6, 0.6, 0.6], [0.8, 0.2, 0.2], [0.2, 0.3, 0.8]], np.float32
        ),
        mats_ks=np.asarray(
            [[0.1, 0.1, 0.1], [0.3, 0.3, 0.3], [0.0, 0.0, 0.0]], np.float32
        ),
        mats_kr=np.asarray(
            [[0.3, 0.3, 0.3], [0.0, 0.0, 0.0], [0.5, 0.5, 0.5]], np.float32
        ),
        lights_pos=np.asarray([[4, 2, 6], [-5, -3, 4]], np.float32),
        lights_kl=np.asarray([[30, 28, 25], [10, 12, 16]], np.float32),
        **spheres,
    )


@pytest.fixture(scope="session")
def tiny_scene():
    """A handful of triangles + 1 light, deterministic, fully visible."""
    from parallel_ray_tracer_tpu.models.scene import Scene

    verts = np.array(
        [
            # floor quad (z=0)
            [-5, -5, 0], [5, -5, 0], [5, 5, 0], [-5, 5, 0],
            # a raised triangle
            [-1, 0, 1], [1, 0, 1], [0, 0, 2.5],
            # an occluder above
            [-0.8, -0.5, 3.0], [0.8, -0.5, 3.0], [0.0, 0.7, 3.2],
        ],
        dtype=np.float32,
    )
    faces = np.array(
        [[0, 1, 2], [0, 2, 3], [4, 5, 6], [7, 8, 9]], dtype=np.int32
    )
    mat_idx = np.array([0, 0, 1, 2], dtype=np.int32)
    return Scene(
        verts=verts,
        faces=faces,
        mat_idx=mat_idx,
        mats_kd=np.array(
            [[0.8, 0.8, 0.8], [0.7, 0.1, 0.1], [0.1, 0.2, 0.7]], np.float32
        ),
        mats_ks=np.array(
            [[0.0, 0.0, 0.0], [0.5, 0.5, 0.5], [0.3, 0.3, 0.3]], np.float32
        ),
        mats_kr=np.array(
            [[0.2, 0.2, 0.2], [0.0, 0.0, 0.0], [0.4, 0.4, 0.4]], np.float32
        ),
        lights_pos=np.array([[0.0, -6.0, 6.0]], np.float32),
        lights_kl=np.array([[30.0, 30.0, 30.0]], np.float32),
    )
