"""Serving-path benchmark: single-request p50 latency vs batched throughput.

Single-request p50 latency is bounded below by per-dispatch overhead, not
model work. The serving lever is therefore request batching: ScoringService
.score_batch stacks R independent (user, candidate-list) requests into one
dispatch in candidates form (user tower computed once per user). This script
pins how requests/s scales with R, single-request p50 for parity with
bench.py, and full-catalog topk latency.

Usage: python scripts/serve_bench.py [out_json]
       python scripts/serve_bench.py [out_json] --catalog

--catalog runs the REFERENCE-SCALE serving capacity probe instead: a
~2.7M-item catalog graph (the post-filter item count of the 1e8-event prep,
scripts/prep_bench.py) resident in HBM, full-catalog
topk streamed through ScoringService's fixed-size chunk pipeline — the
single-dispatch form would need ~15 GB for the item-side neighbor
embeddings alone.
"""

from __future__ import annotations

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
C = 101          # 1 pos + 100 negs, the eval/serving protocol
REPS = 30


def main():
    import jax

    from score_tpu.config import configs3
    from score_tpu.data import synth
    from score_tpu.data.prep_common import build_dataset
    from score_tpu.graph import device_graph
    from score_tpu.serve import ScoringService
    from score_tpu.train import build_model, init_state

    user, item, ts = synth.synth_events(
        NUM_USERS, NUM_ITEMS, NUM_EVENTS, num_slots=NUM_SLOTS, seed=0)
    ds = build_dataset(user, item, ts, num_slots=NUM_SLOTS,
                       user_fanout=FANOUT, item_fanout=FANOUT,
                       num_eval_neg=100, min_user=3, min_item=3, seed=0,
                       dataset_name="servebench")
    import dataclasses
    cfg = configs3()
    # replace() overrides ONLY the bench knobs; every other ModelConfig field
    # keeps its configs3 value (rebuilding from scratch would
    # silently reset unlisted fields to dataclass defaults)
    cfg = cfg.replace(model=dataclasses.replace(
        cfg.model, embed_dim=EMBED_DIM, hidden_dim=64, mlp_dims=(128, 64),
        compute_dtype="bfloat16"))
    model = build_model(cfg, ds.num_users, ds.num_items)
    graph = device_graph(ds.graph)
    state = init_state(cfg, model, graph, jax.random.PRNGKey(0))
    svc = ScoringService(cfg, ds, state.params)

    rng = np.random.default_rng(0)
    results = {}

    # --- single-request p50 (parity with bench.py's metric) ---
    items1 = rng.integers(1, ds.num_items + 1, size=C).astype(np.int32)
    svc.score(7, items1)                      # compile warmup
    lat = []
    for _ in range(3 * REPS):
        t0 = time.time()
        svc.score(7, items1)
        lat.append(time.time() - t0)
    results["single_p50_ms"] = round(float(np.median(lat)) * 1e3, 2)
    results["single_req_per_s"] = round(1e3 / results["single_p50_ms"], 1)
    print(json.dumps({"single_request": results.copy()}), flush=True)

    # --- batched requests: R users x C candidates in one dispatch ---
    for R in (16, 64, 256, 1024):
        users = rng.integers(1, ds.num_users + 1, size=R).astype(np.int32)
        cand = rng.integers(1, ds.num_items + 1,
                            size=(R, C)).astype(np.int32)
        svc.score_batch(users, cand)          # compile warmup (per bucket)
        best = float("inf")
        for _ in range(2):                    # best-of-2 contention windows
            t0 = time.time()
            for _ in range(max(REPS // 4, 4)):
                svc.score_batch(users, cand)
            best = min(best, (time.time() - t0) / max(REPS // 4, 4))
        row = dict(R=R, C=C, ms=round(best * 1e3, 2),
                   req_per_s=round(R / best, 1),
                   cand_per_s=round(R * C / best))
        results[f"batch_R{R}"] = row
        print(json.dumps(row), flush=True)

    # --- full-catalog topk for one user ---
    svc.topk(7, k=10)                         # compile warmup
    lat = []
    for _ in range(8):
        t0 = time.time()
        svc.topk(7, k=10)
        lat.append(time.time() - t0)
    results["topk_full_catalog_ms"] = round(float(np.median(lat)) * 1e3, 1)
    results["catalog_items"] = int(ds.num_items)
    print(json.dumps({"topk_full_catalog_ms":
                      results["topk_full_catalog_ms"],
                      "catalog_items": results["catalog_items"]}),
          flush=True)

    out = sys.argv[1] if len(sys.argv) > 1 else "/tmp/serve_bench.json"
    with open(out, "w") as f:
        json.dump(results, f, indent=2)


def catalog_main():
    """Reference-catalog-scale topk: ~2.7M items HBM-resident, chunked."""
    import dataclasses

    import jax

    from score_tpu.config import configs3
    from score_tpu.data import synth
    from score_tpu.data.prep_common import build_dataset
    from score_tpu.graph import device_graph
    from score_tpu.serve import ScoringService
    from score_tpu.train import build_model, init_state

    t0 = time.time()
    # sized so the post-filter item count lands at/above the pinned 1e8-prep
    # catalog (2.68M items, scripts/prep_bench.py); min counts 1 keep the
    # synthetic catalog wide — serving capacity depends on SIZES, not
    # content. eval negatives are irrelevant here (num_eval_neg=1).
    user, item, ts = synth.synth_events(
        1_000_000, 3_700_000, 14_000_000, num_slots=NUM_SLOTS, seed=0)
    ds = build_dataset(user, item, ts, num_slots=NUM_SLOTS,
                       user_fanout=FANOUT, item_fanout=FANOUT,
                       num_eval_neg=1, min_user=1, min_item=1, seed=0,
                       dataset_name="catalog-scale")
    prep_s = time.time() - t0
    print(json.dumps(dict(prep_s=round(prep_s, 1), users=ds.num_users,
                          items=ds.num_items)), flush=True)
    assert ds.num_items >= 2_680_000, ds.num_items

    cfg = configs3()
    cfg = cfg.replace(model=dataclasses.replace(
        cfg.model, embed_dim=EMBED_DIM, hidden_dim=64, mlp_dims=(128, 64),
        compute_dtype="bfloat16"))
    model = build_model(cfg, ds.num_users, ds.num_items)
    graph = device_graph(ds.graph)
    state = init_state(cfg, model, graph, jax.random.PRNGKey(0))
    kv = dict(a.split("=", 1) for a in sys.argv[1:] if "=" in a)
    svc = ScoringService(cfg, ds, state.params,
                         candidate_chunk=int(kv.get("chunk", 8192)),
                         topk_grid_rows=int(kv.get("rows", 16)))

    results = dict(catalog_items=int(ds.num_items),
                   catalog_users=int(ds.num_users),
                   candidate_chunk=svc.candidate_chunk,
                   topk_grid_rows=svc.topk_grid_rows,
                   prep_s=round(prep_s, 1))
    t0 = time.time()
    items1, scores1 = svc.topk(7, k=10)       # compile warmup included
    results["topk_first_call_s"] = round(time.time() - t0, 2)
    assert items1.shape == (10,) and np.isfinite(scores1).all()
    lat = []
    for _ in range(3):
        t0 = time.time()
        svc.topk(7, k=10)
        lat.append(time.time() - t0)
    results["topk_warm_s"] = round(float(np.median(lat)), 2)
    results["items_per_s"] = round(ds.num_items /
                                   float(np.median(lat)))

    # --- multi-user catalog topk (topk_batch) ---
    # R users share every [R, chunk] block dispatch, so the batch axis is
    # full (the single-user path pads grid rows with the same user); the
    # per-user cost should drop accordingly.
    for R in (4, 16):
        users = np.arange(3, 3 + R, dtype=np.int32)
        svc.topk_batch(users, k=10)           # block-shape compile warmup
        lat = []
        for _ in range(3):
            t0 = time.time()
            bi, bs = svc.topk_batch(users, k=10)
            lat.append(time.time() - t0)
        assert bi.shape == (R, 10) and np.isfinite(bs).all()
        med = float(np.median(lat))
        results[f"topk_batch_R{R}_s"] = round(med, 2)
        results[f"topk_batch_R{R}_per_user_s"] = round(med / R, 3)
        results[f"topk_batch_R{R}_user_items_per_s"] = round(
            R * ds.num_items / med)
        print(json.dumps({k: results[k] for k in results
                          if k.startswith(f"topk_batch_R{R}")}), flush=True)
    print(json.dumps(results), flush=True)
    out = sys.argv[1] if len(sys.argv) > 1 else "/tmp/serve_catalog.json"
    with open(out, "w") as f:
        json.dump(results, f, indent=2)


if __name__ == "__main__":
    if "--catalog" in sys.argv:
        sys.argv.remove("--catalog")
        catalog_main()
    else:
        main()
