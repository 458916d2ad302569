"""Worker process for tests/test_multiprocess.py.

Joins a 2-process jax.distributed cluster on the CPU backend (4 virtual
devices per process -> 8 global devices), renders the shared tiny scene
with image tiles sharded over the GLOBAL mesh, and writes the fully
assembled frame to disk. This executes parallel.distributed.initialize()
and the global-mesh render path for real across OS process boundaries —
the multi-host story the single-process virtual-mesh dryruns cannot cover
(SURVEY.md §4(e), round-3 verdict #6).

Usage (spawned by the test, never run standalone):
    python mp_render_worker.py <coordinator> <process_id> <scene.npz> <out.npy>
"""

import os
import sys

# Must be set before jax initializes a backend.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=4"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402


def main():
    coordinator, pid, scene_path, out_path = sys.argv[1:5]
    pid = int(pid)

    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    sys.path.insert(0, repo)

    # distributed.initialize must run before ANY backend-initializing
    # import (ops.intersect holds module-level jnp constants), so the
    # package imports come after it.
    from parallel_ray_tracer_tpu.parallel import distributed

    distributed.initialize(
        coordinator_address=coordinator, num_processes=2, process_id=pid
    )

    from parallel_ray_tracer_tpu.parallel import sharded
    from parallel_ray_tracer_tpu.models.camera import default_camera
    from parallel_ray_tracer_tpu.models.device_scene import build_device_scene
    from parallel_ray_tracer_tpu.models.scene import Scene
    from parallel_ray_tracer_tpu.ops.bvh import build_bvh
    from parallel_ray_tracer_tpu.ops.bvh_flat import flatten_bvh
    from parallel_ray_tracer_tpu.ops.trace_bvh import device_bvh_from_flat
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    assert jax.process_count() == 2, jax.process_count()
    assert len(jax.devices()) == 8, len(jax.devices())
    assert len(jax.local_devices()) == 4

    z = np.load(scene_path)
    scene = Scene(
        verts=z["verts"], faces=z["faces"], mat_idx=z["mat_idx"],
        mats_kd=z["mats_kd"], mats_ks=z["mats_ks"], mats_kr=z["mats_kr"],
        lights_pos=z["lights_pos"], lights_kl=z["lights_kl"],
    )
    tv = scene.triangle_vertices()
    bvh = build_bvh(tv, heuristic=6, leaf_threshold=8)
    flat = flatten_bvh(bvh, tv, leaf_size=8)
    dbvh, _, depth = device_bvh_from_flat(flat)
    ds = build_device_scene(
        jnp.asarray(scene.verts), scene.faces, scene.mat_idx,
        scene.mats_kd, scene.mats_ks, scene.mats_kr,
        scene.lights_pos, scene.lights_kl, slot_map=flat.slot_map,
    )
    mesh = sharded.make_mesh()          # all 8 GLOBAL devices
    assert mesh.devices.size == 8
    img = sharded.render_sharded(
        ds, dbvh, default_camera(), 64, 32, mesh,
        bounces=1, leaf_size=8, depth=depth, variant="jax",
    )
    # Replicate so every process holds the full frame, then fetch.
    img = jax.jit(
        lambda x: x, out_shardings=NamedSharding(mesh, P())
    )(img)
    np.save(out_path, np.asarray(img))
    print(f"worker {pid}: wrote {out_path}", flush=True)


if __name__ == "__main__":
    main()
