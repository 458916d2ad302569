"""Persistent XLA compilation cache for the entry points.

JAX reads JAX_COMPILATION_CACHE_DIR itself; when it is set, this module sets
no directory of its own. Otherwise compiled programs go to `.jax_cache` in
the checkout (git-ignored), a fixed path, so a later process on the same
checkout finds them again.
"""

from __future__ import annotations

import os

import jax

_REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
DEFAULT_DIR = os.path.join(_REPO_ROOT, ".jax_cache")


def enable_compile_cache() -> str:
    """Turn the persistent cache on; returns the directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
