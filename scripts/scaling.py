"""Scaling harness: examples/s at 1 device vs an N-device mesh
(BASELINE.md row 'Scaling').

With --cpu it runs on the fake-CPU 8-device mesh — that validates the
*harness and sharded program* (collectives compile + execute; efficiency
numbers on fake CPU devices are not hardware-meaningful). On a machine with
several GPUs the same script reports real parallel efficiency.

Usage:
  XLA_FLAGS=--xla_force_host_platform_device_count=8 \
      python scripts/scaling.py --cpu [batch_per_device] [steps]
  python scripts/scaling.py [batch_per_device] [steps]    # real GPUs
"""

import sys
import time

sys.path.insert(0, ".")

import jax

# --cpu must be applied before any backend initialization
if "--cpu" in sys.argv:
    sys.argv.remove("--cpu")
    jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp

import numpy as np

from score_tpu.config import configs3, ShardingConfig
from score_tpu.data import synth
from score_tpu.data.prep_common import build_dataset
from score_tpu.data.pipeline import TargetIterator
from score_tpu.graph import device_graph
from score_tpu.sharding import (batch_sharding, factor_mesh, make_mesh,
                                shard_graph, shard_state)
from score_tpu.train import (build_model, init_state, make_train_step,
                             _stack_batches)


def measure(n_devices: int, batch_per_device: int, steps: int, ds) -> float:
    cfg = configs3()
    graph = device_graph(ds.graph)
    model = build_model(cfg, ds.num_users, ds.num_items)
    state = init_state(cfg, model, graph, jax.random.PRNGKey(0))
    B = batch_per_device * n_devices
    put = jnp.asarray
    if n_devices > 1:
        mesh = make_mesh(jax.devices()[:n_devices])
        state = shard_state(mesh, state)
        graph = shard_graph(mesh, graph)
        bs = batch_sharding(mesh)
        put = lambda v: jax.device_put(jnp.asarray(v), bs)
    step_fn = make_train_step(model, cfg)
    it = TargetIterator(ds.train, B, seed=0)
    rng = jax.random.PRNGKey(0)

    def run_one():
        b = {k2: put(v) for k2, v in next(it).items()}
        return step_fn(state, graph, b, rng)

    s2, m = run_one()
    float(m["loss"])                      # compile + readback
    t0 = time.time()
    for _ in range(steps):
        s2, m = step_fn(s2, graph,
                        {k2: put(v) for k2, v in next(it).items()}, rng)
    float(m["loss"])
    dt = time.time() - t0
    return B * steps / dt


def main():
    batch_per_device = int(sys.argv[1]) if len(sys.argv) > 1 else 256
    steps = int(sys.argv[2]) if len(sys.argv) > 2 else 20
    user, item, ts = synth.synth_events(2000, 4000, 150_000, num_slots=8,
                                        seed=0)
    ds = build_dataset(user, item, ts, num_slots=8, user_fanout=8,
                       item_fanout=8, num_eval_neg=10, min_user=3,
                       min_item=3, seed=0)
    n_avail = len(jax.devices())
    points = sorted({1, min(2, n_avail), min(4, n_avail), n_avail})
    results = {}
    for n in points:
        eps = measure(n, batch_per_device, steps, ds)
        results[n] = eps
        base = results[points[0]]
        eff = eps / (base * n / points[0])
        print(f"devices={n:2d}  examples/s={eps:10,.0f}  "
              f"parallel-efficiency={eff:.2f}", flush=True)
    print(f"backend={jax.default_backend()} "
          f"(fake-CPU numbers validate the harness, not hardware)")


if __name__ == "__main__":
    main()
