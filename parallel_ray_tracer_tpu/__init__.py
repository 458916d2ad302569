"""parallel_ray_tracer_tpu — a differentiable ray tracing framework in JAX.

A JAX/XLA/Pallas rebuild of the capabilities of deluf/parallel-ray-tracer
(see SURVEY.md): pinhole-camera primary rays, Möller–Trumbore triangle +
sphere intersection, 7-heuristic BVH, per-ray GPU traversal kernels,
Blinn-Phong shading with shadow rays and mirror bounces — extended with
end-to-end differentiability and multi-device scaling.
"""

__version__ = "0.1.0"

from .config import RenderConfig  # noqa: F401


def prepare(cfg=None, scene=None, **kwargs):
    """Convenience: build a render pipeline (see pipeline.prepare).

    `prepare()` with no args uses the default RenderConfig; keyword args
    construct one: `prepare(scene="car_boxed", width=1920, height=1080)`.
    """
    from . import pipeline as _pipeline

    if cfg is None:
        cfg = RenderConfig(**kwargs)
    elif kwargs:
        raise TypeError("pass either a RenderConfig or keyword fields")
    return _pipeline.prepare(cfg, scene=scene)
