"""Op-level profile of the flagship train step on the real chip.

Traces K fused train steps with jax.profiler.trace, converts the xplane dump
with xprof's hlo_stats tool, and prints (a) self-time grouped by HLO op
category and (b) the top individual ops — the measurement that drives kernel
work.

Usage: python scripts/profile_step.py [batch] [dtype] [trace_dir] [neg_mode]
           [stride]

neg_mode defaults to 'inbatch_iw' — the shipped bench configuration
(the profile must cover the step that bench.py times).
"""

from __future__ import annotations

import glob
import json
import sys
import time

import numpy as np

sys.path.insert(0, ".")

NUM_USERS = 50_000
NUM_ITEMS = 100_000
NUM_EVENTS = 2_000_000
NUM_SLOTS = 9
FANOUT = 10
EMBED_DIM = 32
K = 50


def main():
    batch = int(sys.argv[1]) if len(sys.argv) > 1 else 4096
    dtype = sys.argv[2] if len(sys.argv) > 2 else "bfloat16"
    trace_dir = sys.argv[3] if len(sys.argv) > 3 else "/tmp/xprof_step"
    neg_mode = sys.argv[4] if len(sys.argv) > 4 else "inbatch_iw"
    stride = int(sys.argv[5]) if len(sys.argv) > 5 else 1

    import jax
    import jax.numpy as jnp

    from score_tpu.config import configs3
    from score_tpu.data import synth
    from score_tpu.data.prep_common import build_dataset
    from score_tpu.data.pipeline import TargetIterator
    from score_tpu.graph import device_graph
    from score_tpu.train import (_stack_batches, build_model, init_state,
                                 item_importance_weights, make_train_loop)

    user, item, ts = synth.synth_events(
        NUM_USERS, NUM_ITEMS, NUM_EVENTS, num_slots=NUM_SLOTS, seed=0)
    ds = build_dataset(user, item, ts, num_slots=NUM_SLOTS,
                       user_fanout=FANOUT, item_fanout=FANOUT,
                       num_eval_neg=100, min_user=3, min_item=3, seed=0,
                       dataset_name="profile")
    graph = device_graph(ds.graph)

    cfg = configs3()
    cfg = cfg.replace(
        model=cfg.model.__class__(
            embed_dim=EMBED_DIM, hidden_dim=64, mlp_dims=(128, 64),
            sides="dual", slot_agg="coattn", seq_pool="attn",
            target_aware=True, compute_dtype=dtype),
        data=cfg.data.__class__(train_neg_mode=neg_mode),
        train=cfg.train.__class__(batch_size=batch,
                                  table_update_every=stride,
                                  table_lr_boost=float(stride)))
    model = build_model(cfg, ds.num_users, ds.num_items)
    rng = jax.random.PRNGKey(0)
    state = init_state(cfg, model, graph, rng)
    neg_iw = (jnp.asarray(item_importance_weights(ds.train, ds.num_items))
              if neg_mode == "inbatch_iw" else None)
    train_loop = make_train_loop(model, cfg, neg_iw=neg_iw)
    it = TargetIterator(ds.train, batch, seed=0)

    state, ms = train_loop(state, graph, _stack_batches(it, K), rng)
    float(ms["loss"][-1])                       # compile + warmup
    t0 = time.time()
    with jax.profiler.trace(trace_dir):
        state, ms = train_loop(state, graph, _stack_batches(it, K), rng)
        float(ms["loss"][-1])                   # honest readback inside trace
    wall = time.time() - t0
    print(json.dumps(dict(batch=batch, dtype=dtype, neg_mode=neg_mode,
                          stride=stride,
                          steps=K, wall_s=round(wall, 2),
                          examples_per_s=round(K * batch / wall))), flush=True)

    paths = sorted(glob.glob(f"{trace_dir}/**/*.xplane.pb", recursive=True))
    if not paths:
        print("no xplane dump found", file=sys.stderr)
        return
    from xprof.convert import raw_to_tool_data as r
    out = r.xspace_to_tool_data([paths[-1]], "hlo_stats", {})
    data = json.loads(out[0] if isinstance(out, tuple) else out)
    cols = [c["id"] for c in data["cols"]]
    rows = [[cell["v"] if cell else None for cell in row["c"]]
            for row in data["rows"]]
    i_cat = cols.index("category")
    i_name = cols.index("hlo_op_name")
    i_self = cols.index("total_self_time")
    i_bound = cols.index("bound_by")
    by_cat = {}
    total = 0.0
    for row in rows:
        t = float(row[i_self] or 0.0)
        by_cat[row[i_cat]] = by_cat.get(row[i_cat], 0.0) + t
        total += t
    print("\n-- self time by HLO category --")
    for cat, t in sorted(by_cat.items(), key=lambda kv: -kv[1])[:12]:
        print(f"{cat:40s} {t:10.1f} us  {100*t/max(total,1e-9):5.1f}%")
    print("\n-- top ops --")
    rows.sort(key=lambda row: -float(row[i_self] or 0.0))
    i_expr = cols.index("hlo_op_expression")
    i_src = cols.index("source_info")
    for row in rows[:15]:
        t = float(row[i_self] or 0.0)
        print(f"{str(row[i_name])[:56]:56s} {str(row[i_cat])[:20]:20s} "
              f"{t:9.1f} us {100*t/max(total,1e-9):5.1f}% "
              f"bound_by={row[i_bound]}")
        print(f"    src={str(row[i_src])[:100]}")
        print(f"    expr={str(row[i_expr])[:240]}")


if __name__ == "__main__":
    main()
