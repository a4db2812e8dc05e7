"""Host batch-staging share of the train loop.

`train()` stages each 50-step chunk with `_stack_batches` (iterator pulls +
np.stack + host->device put) BETWEEN dispatch chunks, serialized with
device work whenever the driver reads back the previous chunk's metrics
(the log-boundary `float(m['loss'])`). bench.py pre-stages its chunks
outside the timed window, so the driver metric never saw this cost — this
script pins it on the bench shape:

  t_stage   wall to stage one 50-step chunk (host work + put dispatch)
  t_chunk   wall of one staged chunk: dispatch + data-dependent readback
  share     t_stage / (t_stage + t_chunk)  — the serialized-path loss

If share is more than a few percent, the fix is to stage chunk k+1 before
reading chunk k's metrics (reorder, no thread needed — dispatch is async).

Usage: python scripts/host_staging.py [out_json]
"""

from __future__ import annotations

import json
import sys
import time

sys.path.insert(0, ".")

import numpy as np

BATCH = 4096
K = 50
REPS = 8


def main():
    out_path = sys.argv[1] if len(sys.argv) > 1 else "/tmp/host_staging.json"
    import jax
    import jax.numpy as jnp

    from score_tpu.config import configs3
    from score_tpu.data import synth
    from score_tpu.data.pipeline import TargetIterator
    from score_tpu.data.prep_common import build_dataset
    from score_tpu.graph import device_graph
    from score_tpu.train import (_stack_batches, build_model, init_state,
                                 item_importance_weights, make_train_loop)
    import dataclasses

    user, item, ts = synth.synth_events(50_000, 100_000, 2_000_000,
                                        num_slots=9, seed=0)
    ds = build_dataset(user, item, ts, num_slots=9, user_fanout=10,
                      item_fanout=10, num_eval_neg=10, min_user=3,
                      min_item=3, seed=0, dataset_name="staging")
    cfg = configs3()
    cfg = cfg.replace(
        model=dataclasses.replace(cfg.model, embed_dim=32, hidden_dim=64,
                                  mlp_dims=(128, 64),
                                  compute_dtype="bfloat16"),
        data=dataclasses.replace(cfg.data, train_neg_mode="inbatch_iw"),
        train=dataclasses.replace(cfg.train, batch_size=BATCH,
                                  table_update_every=2, table_lr_boost=2.0))
    graph = device_graph(ds.graph)
    model = build_model(cfg, ds.num_users, ds.num_items)
    rng = jax.random.PRNGKey(0)
    state = init_state(cfg, model, graph, rng)
    neg_iw = jnp.asarray(item_importance_weights(ds.train, ds.num_items))
    loop = make_train_loop(model, cfg, neg_iw=neg_iw)
    it = TargetIterator(ds.train, BATCH, seed=0)

    state, ms = loop(state, graph, _stack_batches(it, K), rng)
    float(ms["loss"][-1])                     # compile + warmup

    stage_s, chunk_s = [], []
    for _ in range(REPS):
        t0 = time.time()
        stacked = _stack_batches(it, K)
        stage_s.append(time.time() - t0)
        t0 = time.time()
        state, ms = loop(state, graph, stacked, rng)
        float(ms["loss"][-1])                 # data-dependent readback
        chunk_s.append(time.time() - t0)
    stage = float(np.median(stage_s))
    chunk = float(np.median(chunk_s))
    res = dict(batch=BATCH, steps_per_chunk=K,
               stage_ms=round(stage * 1e3, 2),
               chunk_ms=round(chunk * 1e3, 2),
               serialized_share=round(stage / (stage + chunk), 4),
               stage_ms_all=[round(s * 1e3, 2) for s in stage_s],
               chunk_ms_all=[round(s * 1e3, 2) for s in chunk_s],
               backend=jax.default_backend())
    print(json.dumps(res))
    with open(out_path, "w") as f:
        json.dump(res, f, indent=2)
    print(f"wrote {out_path}")


if __name__ == "__main__":
    main()
