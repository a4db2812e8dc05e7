"""Per-dataset preprocessing entry points: CCMR / Taobao / Tmall.

Mirrors the reference's per-dataset preprocess scripts (SURVEY.md §2.3 #1-3;
reference mount is empty, so schemas follow the public dataset releases):

  * CCMR (Douban-derived movie ratings): user_id,item_id,rating,timestamp.
    Slots: equal-width buckets over the log's time range.
  * Taobao UserBehavior (Nov 25 - Dec 3 2017 click log): slots ~ days.
  * Tmall IJCAI-15: slots ~ half-months.

Each `prep_*` reads the raw CSV if present, else synthesizes the same
columns a schema-identical log would hold (no network — SURVEY.md §7.0),
then runs the shared `build_dataset` pipeline.

CLI:  python -m score_tpu.data.prep_datasets <ccmr|taobao|tmall> <out_dir>
          [raw_path] [key=value ...]
"""

from __future__ import annotations

import csv
import itertools
import os
import sys

import numpy as np

from . import synth
from .prep_common import build_dataset
from .schema import Dataset, save_dataset

_DEFAULTS = {
    # dataset: (num_slots, user_fanout, item_fanout, min_user, min_item)
    "ccmr": dict(num_slots=12, user_fanout=10, item_fanout=10,
                 min_user=5, min_item=5),
    "taobao": dict(num_slots=9, user_fanout=10, item_fanout=10,
                   min_user=5, min_item=5),
    "tmall": dict(num_slots=12, user_fanout=10, item_fanout=10,
                  min_user=5, min_item=5),
}


def _read_csv_cols(path: str, usecols, dtype=np.int64,
                   chunk_rows: int = 1_000_000) -> list[np.ndarray]:
    """Chunked columnar CSV reader: returns the integer columns `usecols`
    (0-based, in the order asked) as arrays. Rows stream through the stdlib
    csv module `chunk_rows` at a time, so peak memory is the packed output
    plus one chunk, at Taobao-scale (~1e8-event) logs. A first row whose
    requested fields are not integers is a header and is skipped."""
    cols = list(usecols)
    parts: list[list[np.ndarray]] = [[] for _ in cols]
    with open(path, newline="") as f:
        reader = csv.reader(f)
        first = next(reader, None)
        if first is None:
            raise ValueError(f"{path}: empty CSV")
        try:
            head = [np.array([first[c] for c in cols], dtype=dtype)]
        except ValueError:              # a header row
            head = []
        pending = [first] if head else []
        while True:
            rows = pending + list(itertools.islice(reader, chunk_rows))
            pending = []
            if not rows:
                break
            for j, c in enumerate(cols):
                parts[j].append(np.array([r[c] for r in rows], dtype=dtype))
    return [np.concatenate(p) if p else np.zeros(0, dtype) for p in parts]


def _load_or_synth(raw_path: str | None, usecols,
                   synth_kw) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The raw CSV's (user, item, ts) columns when `raw_path` exists, else
    the synthetic log `synth.write_raw` would store, made in memory."""
    if raw_path is not None and os.path.exists(raw_path):
        return tuple(_read_csv_cols(raw_path, usecols))
    return synth.synth_raw_events(**synth_kw)


def prep_ccmr(out_dir: str, raw_path: str | None = None, seed: int = 0,
              synth_kw: dict | None = None, **overrides) -> Dataset:
    kw = dict(_DEFAULTS["ccmr"], **overrides)
    user, item, ts = _load_or_synth(
        raw_path, usecols=(0, 1, 3),
        synth_kw=dict(synth_kw or {}, num_slots=kw["num_slots"], seed=seed))
    ds = build_dataset(user, item, ts, dataset_name="ccmr", seed=seed, **kw)
    save_dataset(ds, out_dir)
    return ds


def prep_taobao(out_dir: str, raw_path: str | None = None, seed: int = 0,
                synth_kw: dict | None = None, **overrides) -> Dataset:
    kw = dict(_DEFAULTS["taobao"], **overrides)
    user, item, ts = _load_or_synth(
        raw_path, usecols=(0, 1, 4),
        synth_kw=dict(synth_kw or {}, num_slots=kw["num_slots"], seed=seed))
    ds = build_dataset(user, item, ts, dataset_name="taobao", seed=seed, **kw)
    save_dataset(ds, out_dir)
    return ds


def prep_tmall(out_dir: str, raw_path: str | None = None, seed: int = 0,
               synth_kw: dict | None = None, **overrides) -> Dataset:
    kw = dict(_DEFAULTS["tmall"], **overrides)
    user, item, ts = _load_or_synth(
        raw_path, usecols=(0, 1, 5),
        synth_kw=dict(synth_kw or {}, num_slots=kw["num_slots"], seed=seed))
    ds = build_dataset(user, item, ts, dataset_name="tmall", seed=seed, **kw)
    save_dataset(ds, out_dir)
    return ds


PREP = {"ccmr": prep_ccmr, "taobao": prep_taobao, "tmall": prep_tmall}


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) < 2 or argv[0] not in PREP:
        print(__doc__)
        raise SystemExit(2)
    dataset, out_dir = argv[0], argv[1]
    raw_path = None
    overrides = {}
    for a in argv[2:]:
        if "=" in a:
            k, v = a.split("=", 1)
            overrides[k] = int(v)
        else:
            raw_path = a
    ds = PREP[dataset](out_dir, raw_path=raw_path, **overrides)
    print(f"{dataset}: users={ds.num_users} items={ds.num_items} "
          f"slots={ds.graph.num_slots} train={len(ds.train)} "
          f"val={len(ds.val)} test={len(ds.test)} -> {out_dir}")


if __name__ == "__main__":
    main()
