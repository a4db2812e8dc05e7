"""Tracing / profiling utilities (SURVEY.md §5 'Tracing / profiling').

The reference has none (wall-clock prints at most). Here:
  * `maybe_profile(dir)` — context manager around `jax.profiler.trace`
    (xprof/perfetto dump) gated on a --profile_dir flag;
  * `cost_summary(fn, *args)` — XLA cost analysis (FLOPs / bytes) of a
    jitted callable, for roofline sanity of kernels;
  * `timed(fn, *args)` — wall timing that ends in a host readback of a
    data-dependent scalar, so it waits for the device work it times.
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np


@contextlib.contextmanager
def maybe_profile(profile_dir: Optional[str]):
    if not profile_dir:
        yield
        return
    with jax.profiler.trace(profile_dir):
        yield


def cost_summary(fn, *args) -> dict:
    """FLOPs / memory-traffic estimate of one call, from XLA's analysis."""
    lowered = jax.jit(fn).lower(*args)
    ca = lowered.compile().cost_analysis()
    if isinstance(ca, (list, tuple)):
        ca = ca[0] if ca else {}
    ca = dict(ca or {})
    return {
        "flops": ca.get("flops", float("nan")),
        "bytes_accessed": ca.get("bytes accessed", float("nan")),
        "raw": ca,
    }


def _force(x) -> float:
    """Reduce any output pytree to a host scalar (forces real completion)."""
    leaves = [l for l in jax.tree_util.tree_leaves(x)
              if hasattr(l, "dtype") and jnp.issubdtype(l.dtype, jnp.number)]
    acc = 0.0
    for l in leaves:
        acc += float(jnp.sum(l).astype(jnp.float32))
    return acc


def timed(fn, *args, reps: int = 3) -> float:
    """Median wall seconds per call, readback-forced. `fn` should already be
    jitted; the first (compile) call is excluded."""
    _force(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.time()
        _force(fn(*args))
        times.append(time.time() - t0)
    return float(np.median(times))
