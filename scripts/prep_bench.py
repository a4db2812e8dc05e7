"""Reference-scale preprocessing benchmark.

Taobao UserBehavior is ~1e8 events (SURVEY.md §3.1); the prep pipeline must
survive that scale. This pins wall-time for the two halves separately:

  1. `build_dataset` on N in-memory events (the hot loop: k-core filter ->
     remap -> dedup -> native O(E) adjacency build x2 -> split -> vectorized
     eval negatives). Events are zipf-like in items (duplicate-heavy, like a
     real click log) and uniform in users at Taobao-like cardinalities.
  2. The chunked CSV reader (`_read_csv_cols`) on an M-row file, reported as
     rows/s (the 1e8 read cost is M-run rate x 1e8, linear by construction).

Usage: python scripts/prep_bench.py [events=100000000] [csv_rows=20000000]
           [users=1000000] [items=4000000] [out=/tmp/prep_bench.json]
"""

import json
import sys
import time

sys.path.insert(0, ".")

import numpy as np

from score_tpu.data.prep_common import build_dataset
from score_tpu.data.prep_datasets import _read_csv_cols


def synth_uniform_zipf(n, num_users, num_items, num_slots, seed=0):
    """Schema-valid events at scale, vectorized: uniform users, zipf-ish
    items (alias-free: inverse-CDF on a power-law rank weight), uniform ts.
    No learnable signal needed — this benchmarks prep, not models."""
    rng = np.random.default_rng(seed)
    user = rng.integers(0, num_users, size=n, dtype=np.int64)
    # item rank r with P(r) ~ (r+1)^-0.9: inverse CDF via cumsum lookup.
    w = (np.arange(1, num_items + 1, dtype=np.float64)) ** -0.9
    cdf = np.cumsum(w)
    cdf /= cdf[-1]
    item = np.searchsorted(cdf, rng.random(n)).astype(np.int64)
    ts = rng.integers(0, num_slots * 86400, size=n, dtype=np.int64)
    return user, item, ts


def main():
    kw = dict(events=100_000_000, csv_rows=20_000_000, users=1_000_000,
              items=4_000_000, slots=9, native=1,
              out="/tmp/prep_bench.json")
    for a in sys.argv[1:]:
        k, v = a.split("=", 1)
        kw[k] = type(kw[k])(v)

    res = {"events": kw["events"], "csv_rows": kw["csv_rows"],
           "users": kw["users"], "items": kw["items"]}

    t0 = time.time()
    user, item, ts = synth_uniform_zipf(
        kw["events"], kw["users"], kw["items"], kw["slots"])
    res["synth_s"] = round(time.time() - t0, 1)
    print(f"synth {kw['events']:,} events: {res['synth_s']}s", flush=True)

    t0 = time.time()
    ds = build_dataset(user, item, ts, num_slots=kw["slots"],
                       user_fanout=10, item_fanout=10, num_eval_neg=100,
                       min_user=5, min_item=5, use_native=bool(kw["native"]))
    res["native"] = bool(kw["native"])
    res["build_dataset_s"] = round(time.time() - t0, 1)
    res["phase_s"] = ds.meta.get("prep_phase_s", {})
    res["events_kept"] = ds.meta["num_events_kept"]
    res["num_users"] = ds.graph.num_users
    res["num_items"] = ds.graph.num_items
    res["val_targets"] = len(ds.val)
    res["events_per_s"] = round(kw["events"] / res["build_dataset_s"])
    print(f"build_dataset: {res['build_dataset_s']}s "
          f"({res['events_per_s']:,} ev/s; kept {res['events_kept']:,}; "
          f"{res['num_users']:,} users, {res['num_items']:,} items, "
          f"{res['val_targets']:,} val targets w/ 100 negs)", flush=True)
    del ds

    # CSV read rate on a csv_rows-row taobao-schema file.
    m = kw["csv_rows"]
    path = "/tmp/score_tpu_raw/prep_bench.csv"
    import os
    os.makedirs(os.path.dirname(path), exist_ok=True)
    t0 = time.time()
    np.savetxt(path, np.stack([user[:m], item[:m], item[:m] % 97,
                               np.zeros(m, np.int64), ts[:m]], axis=1),
               fmt="%d", delimiter=",", comments="",
               header="user_id,item_id,category_id,behavior_type,timestamp")
    res["csv_write_s"] = round(time.time() - t0, 1)
    t0 = time.time()
    cols = _read_csv_cols(path, usecols=(0, 1, 4))
    res["csv_read_s"] = round(time.time() - t0, 1)
    res["csv_rows_per_s"] = round(m / res["csv_read_s"])
    res["csv_read_1e8_extrapolated_s"] = round(1e8 / res["csv_rows_per_s"], 1)
    assert cols[0].size == m
    print(f"csv: write {res['csv_write_s']}s, read {res['csv_read_s']}s "
          f"({res['csv_rows_per_s']:,} rows/s -> "
          f"{res['csv_read_1e8_extrapolated_s']}s per 1e8)", flush=True)
    os.remove(path)

    with open(kw["out"], "w") as f:
        json.dump(res, f, indent=2)
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
