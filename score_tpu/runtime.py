"""Process set-up shared by the entry points (train CLI, bench.py,
chip_smoke.py): the persistent compile cache and the accelerator check.

Nothing here runs at import time; the tests call neither function.
"""

from __future__ import annotations

import os
import subprocess

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Fixed, so a second process on the same checkout finds what the first
# compiled (the path is part of the cache key); listed in .gitignore.
DEFAULT_CACHE_DIR = os.path.join(REPO_ROOT, ".jax_cache")


def setup_compile_cache() -> str:
    """Enable JAX's persistent compilation cache and return its directory.

    With JAX_COMPILATION_CACHE_DIR set, JAX reads it itself and nothing is
    set here. Otherwise the cache goes to `<checkout>/.jax_cache`.
    """
    import jax

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR


def require_gpu(allow_cpu_dry_run: bool = False):
    """The first JAX device, which must be a GPU.

    Raises SystemExit (non-zero, with the reason) when JAX found no GPU: a
    measurement must never fall back to the CPU silently. With
    `allow_cpu_dry_run`, an explicit JAX_PLATFORMS=cpu is let through: a
    dry run of the code path, whose numbers are not device numbers.
    """
    import jax

    try:
        dev = jax.devices()[0]
    except RuntimeError as e:           # a requested backend failed to start
        raise SystemExit(f"no usable JAX backend: {e}") from e
    if dev.platform == "gpu":
        return dev
    pinned_cpu = os.environ.get("JAX_PLATFORMS", "").strip().lower() == "cpu"
    if allow_cpu_dry_run and pinned_cpu:
        return dev
    raise SystemExit(
        f"needs a GPU, but JAX's default backend is '{dev.platform}' "
        f"({dev.device_kind}); refusing to run on it")


def gpu_name_and_power_limit() -> str:
    """`name, power.limit` of the cards as nvidia-smi reports them (one line
    per card), or the reason nvidia-smi could not be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"
