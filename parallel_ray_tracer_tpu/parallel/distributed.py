"""Multi-host initialization (SURVEY.md §5: distributed communication).

The reference has no distributed story (single process, single GPU; its only
transfers are cudaMemcpy H2D/D2H, gpu/src/gpu.cu:142-196). Across hosts the
runtime is jax.distributed: one process per host, all devices visible as one
global mesh, collectives handed to NCCL by XLA — no communication plumbing to
write.

Usage on each host (pass the coordinator explicitly, or set
JAX_COORDINATOR_ADDRESS):

    from parallel_ray_tracer_tpu.parallel import distributed, sharded
    distributed.initialize("host0:1234", num_processes=2, process_id=rank)
    mesh = sharded.make_mesh()        # all global devices
    img = sharded.render_sharded(..., mesh=mesh)

Rendering needs no cross-host communication in the forward pass (tiles are
disjoint); assembling the full frame on host 0 happens implicitly when the
sharded output is fetched, and the differentiable
path's gradient all-reduce is inserted by XLA from the sharding specs.
"""

from __future__ import annotations

import os
from typing import Optional

import jax


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Initialize jax.distributed when running multi-process.

    Multi-process runs are recognised from the explicit arguments or from
    JAX_COORDINATOR_ADDRESS; a single-process run (or an already-initialized
    runtime) is a no-op.

    The multiprocess decision must NOT touch the backend: querying
    jax.process_count() would initialize it, after which
    jax.distributed.initialize() can no longer join a coordinator — the
    guard would always see process_count() == 1 and this function could
    never fire.
    """
    multiprocess_env = (
        coordinator_address is not None
        or (num_processes or 0) > 1
        or os.environ.get("JAX_COORDINATOR_ADDRESS")
    )
    if not multiprocess_env:
        return
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except RuntimeError as e:
        # Idempotent entry points call this freely: tolerate only the
        # already-initialized case. Anything else (e.g. "must be called
        # before the XLA backend initializes") is a real bug at the call
        # site and swallowing it silently degrades a pod run to
        # process_count() == 1 (exactly what hid the ordering bug in
        # tests/helpers/mp_render_worker.py).
        msg = str(e).lower()
        if ("already initialized" not in msg
                and "only be called once" not in msg):
            raise


def is_primary() -> bool:
    """True on the host that should write BMPs / metrics."""
    return jax.process_index() == 0
