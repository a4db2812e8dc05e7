"""Op-level profile of the SERVING dispatch at two catalog scales.

Full-catalog topk can cost more per candidate at a multi-million-item
catalog than over the bench dataset. This script profiles the IDENTICAL
[rows, chunk] score_batch dispatch on both datasets, so the per-op diff
isolates what actually scales with catalog size (gathers over GB-scale
adjacency and tables vs tens of MB — or something else entirely).

Usage: python scripts/profile_serve.py [small|catalog] [trace_dir]
"""

from __future__ import annotations

import glob
import json
import sys
import time

import numpy as np

sys.path.insert(0, ".")

NUM_SLOTS = 9
FANOUT = 10
EMBED_DIM = 32
ROWS, CHUNK = 16, 8192
REPS = 4


def main():
    which = sys.argv[1] if len(sys.argv) > 1 else "small"
    trace_dir = (sys.argv[2] if len(sys.argv) > 2
                 else f"/tmp/xprof_serve_{which}")

    import dataclasses

    import jax

    from score_tpu.config import configs3
    from score_tpu.data import synth
    from score_tpu.data.prep_common import build_dataset
    from score_tpu.graph import device_graph
    from score_tpu.serve import ScoringService
    from score_tpu.train import build_model, init_state

    t0 = time.time()
    if which == "catalog":
        user, item, ts = synth.synth_events(
            1_000_000, 3_700_000, 14_000_000, num_slots=NUM_SLOTS, seed=0)
        ds = build_dataset(user, item, ts, num_slots=NUM_SLOTS,
                           user_fanout=FANOUT, item_fanout=FANOUT,
                           num_eval_neg=1, min_user=1, min_item=1, seed=0,
                           dataset_name="serve-profile-catalog")
    else:
        user, item, ts = synth.synth_events(
            50_000, 100_000, 2_000_000, num_slots=NUM_SLOTS, seed=0)
        ds = build_dataset(user, item, ts, num_slots=NUM_SLOTS,
                           user_fanout=FANOUT, item_fanout=FANOUT,
                           num_eval_neg=1, min_user=3, min_item=3, seed=0,
                           dataset_name="serve-profile-small")
    print(json.dumps(dict(which=which, prep_s=round(time.time() - t0, 1),
                          users=ds.num_users, items=ds.num_items)),
          flush=True)

    cfg = configs3()
    cfg = cfg.replace(model=dataclasses.replace(
        cfg.model, embed_dim=EMBED_DIM, hidden_dim=64, mlp_dims=(128, 64),
        compute_dtype="bfloat16"))
    model = build_model(cfg, ds.num_users, ds.num_items)
    graph = device_graph(ds.graph)
    state = init_state(cfg, model, graph, jax.random.PRNGKey(0))
    svc = ScoringService(cfg, ds, state.params, candidate_chunk=CHUNK,
                         topk_grid_rows=ROWS)

    users = np.full(ROWS, 7, np.int32)
    # consecutive ids, exactly the catalog-scan access pattern
    grid = (1 + np.arange(ROWS * CHUNK, dtype=np.int32)
            % ds.num_items).reshape(ROWS, CHUNK)
    svc.score_batch(users, grid)                # compile warmup
    t0 = time.time()
    with jax.profiler.trace(trace_dir):
        for _ in range(REPS):
            out = svc.score_batch(users, grid)  # readback inside (np return)
    wall = time.time() - t0
    n_cand = REPS * ROWS * CHUNK
    print(json.dumps(dict(which=which, reps=REPS, wall_s=round(wall, 2),
                          us_per_candidate=round(1e6 * wall / n_cand, 2))),
          flush=True)

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
    for row in rows[:10]:
        t = float(row[i_self] or 0.0)
        print(f"{str(row[i_name])[:56]:56s} {str(row[i_cat])[:20]:20s} "
              f"{t:9.1f} us {100*t/max(total,1e-9):5.1f}% "
              f"bound_by={row[i_bound]}")
        print(f"    src={str(row[i_src])[:100]}")
        print(f"    expr={str(row[i_expr])[:200]}")


if __name__ == "__main__":
    main()
