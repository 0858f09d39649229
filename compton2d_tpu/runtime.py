"""Process set-up shared by the GPU entry points (``chip_smoke.py``,
``bench.py``, ``tools/run_mrk421.py``).

- :func:`enable_compile_cache` turns on JAX's persistent compilation
  cache, so a second process of the same run (or a second Simulation
  of the same shape) loads the compiled step instead of compiling it
  again;
- :func:`require_gpu` makes a measurement path fail, not fall back to
  the CPU, when JAX finds no GPU;
- :func:`gpu_name_and_power_limit` reads the card's name and power limit,
  which belong beside every number measured on it.
"""
from __future__ import annotations

import os
import subprocess

import jax

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# fixed, gitignored: the cache key includes nothing of the path, but a
# directory that moves between runs is never found again
DEFAULT_CACHE_DIR = os.path.join(REPO_ROOT, ".jax_cache")


def enable_compile_cache() -> str:
    """Keep compiled programs in ``$JAX_COMPILATION_CACHE_DIR`` where it
    is set, else in ``<repo>/.jax_cache``. Returns the directory."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_CACHE_DIR
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def require_gpu() -> None:
    """Exit with an error unless JAX's default backend is a GPU."""
    backend = jax.default_backend()
    if backend != "gpu":
        raise SystemExit(
            f"error: JAX found no GPU (default backend {backend!r}); "
            "this entry point measures the card and does not fall back"
        )


def gpu_name_and_power_limit() -> str:
    """``nvidia-smi``'s name and power limit of every visible card, one
    CSV line per card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
