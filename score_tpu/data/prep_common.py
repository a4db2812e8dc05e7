"""Shared preprocessing: raw event log -> packed Dataset (SURVEY.md §3.1).

The reference does this pass in pure Python per dataset (SURVEY.md §2.3 #1-3);
here it is one vectorized numpy pipeline shared by all datasets:

    events (user, item, ts) -> min-count filter -> id remap (0 = pad)
        -> time-slot bucketing -> per-slot adjacency (dense padded + CSR)
        -> labeled targets (u, i, t*, y=1) split by time -> eval negatives

Invariants (unit-tested):
  * every history event of a target strictly precedes t* (no slot leakage)
  * dense adjacency row 0 (pad node) is all-zero
  * dense truncation is a seeded uniform sample of the CSR row
  * eval negatives never contain the positive item (and optionally no item the
    user ever touched)
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from .schema import Dataset, GraphStore, Targets


def filter_min_count(user: np.ndarray, item: np.ndarray, ts: np.ndarray,
                     min_user: int = 5, min_item: int = 5,
                     max_rounds: int = 5) -> Tuple[np.ndarray, ...]:
    """Iteratively drop users/items with too few events (k-core style)."""
    for _ in range(max_rounds):
        n0 = user.size
        uc = np.bincount(user)
        keep = uc[user] >= min_user
        user, item, ts = user[keep], item[keep], ts[keep]
        ic = np.bincount(item) if item.size else np.zeros(1, np.int64)
        keep = ic[item] >= min_item
        user, item, ts = user[keep], item[keep], ts[keep]
        if user.size == n0:
            break
    return user, item, ts


def remap_ids(values: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Map raw ids to contiguous 1..K (0 reserved for padding).

    Returns (remapped, uniques) where uniques[k-1] is the raw id of new id k.
    """
    uniques, inverse = np.unique(values, return_inverse=True)
    return (inverse + 1).astype(np.int32), uniques


def bucket_slots(ts: np.ndarray, num_slots: int) -> np.ndarray:
    """Equal-width time-slot assignment over [ts.min(), ts.max()].

    Integer timestamps route through the native O(E) kernel
    (native/prep_kernels.cc:bucket_slots — same double-precision formula,
    bit-identical output, equivalence-tested in tests/test_native.py); the
    numpy path is the reference and the fallback."""
    if np.issubdtype(np.asarray(ts).dtype, np.integer):
        from .. import native
        out = native.bucket_slots_native(ts, num_slots)
        if out is not None:
            return out
    lo, hi = ts.min(), ts.max()
    width = max((hi - lo) / num_slots, 1e-9)
    slot = np.minimum(((ts - lo) / width).astype(np.int64), num_slots - 1)
    return slot.astype(np.int32)


def _build_side(node: np.ndarray, nbr: np.ndarray, slot: np.ndarray,
                num_nodes: int, num_slots: int, fanout: int,
                rng: np.random.Generator, use_native: bool = True):
    """One adjacency side: (node -> neighbors) per slot, dense + CSR.

    Inputs are deduplicated (slot, node, nbr) triples. Dense rows longer than
    `fanout` keep a seeded uniform sample (SURVEY.md §7.3 item 2: fan-out is
    pre-truncated at prep time so the device gather is static-shape).

    When available, the O(E) native builder (score_tpu/native) replaces this
    O(E log E) lexsort path; CSR outputs are identical, the dense sample
    differs only in which uniform sample was drawn.
    """
    if use_native:
        from .. import native
        out = native.build_side_native(
            node, nbr, slot, num_nodes, num_slots, fanout,
            seed=int(rng.integers(0, 2 ** 63)))
        if out is not None:
            return out
    # Sort events by (slot, node) with a random tiebreak => within-group order
    # is a uniform permutation, so "first fanout of each group" is a uniform
    # sample without replacement.
    rand = rng.random(node.size)
    order = np.lexsort((rand, node, slot))
    slot_s, node_s, nbr_s = slot[order], node[order], nbr[order]

    # Group = (slot, node). Compute position-within-group.
    group_key = slot_s.astype(np.int64) * (num_nodes + 1) + node_s
    new_group = np.empty(node.size, dtype=bool)
    if node.size:
        new_group[0] = True
        new_group[1:] = group_key[1:] != group_key[:-1]
    group_start = np.maximum.accumulate(
        np.where(new_group, np.arange(node.size), 0))
    pos = np.arange(node.size) - group_start

    # Dense padded adjacency + counts.
    dense = np.zeros((num_slots, num_nodes + 1, fanout), np.int32)
    cnt = np.zeros((num_slots, num_nodes + 1), np.int32)
    keep = pos < fanout
    dense[slot_s[keep], node_s[keep], pos[keep]] = nbr_s[keep]
    np.add.at(cnt, (slot_s, node_s), 1)
    cnt = np.minimum(cnt, fanout)
    dense[:, 0, :] = 0
    cnt[:, 0] = 0

    # CSR (untruncated). indices is one concatenated array sorted by
    # (slot, node); indptr[t, v] is an absolute offset into it, so the row of
    # (t, v) is indices[indptr[t, v] : indptr[t, v + 1]].
    counts_full = np.zeros((num_slots, num_nodes + 1), np.int64)
    np.add.at(counts_full, (slot, node), 1)
    order2 = np.lexsort((nbr, node, slot))
    indices = nbr[order2].astype(np.int32)
    flat_indptr = np.zeros(num_slots * (num_nodes + 1) + 1, np.int64)
    np.cumsum(counts_full.reshape(-1), out=flat_indptr[1:])
    # indptr[t] needs num_nodes + 2 entries (row v spans [v, v+1] for
    # v = 0..num_nodes); entry num_nodes+1 of slot t == entry 0 of slot t+1.
    indptr = flat_indptr[
        np.arange(num_slots)[:, None] * (num_nodes + 1)
        + np.arange(num_nodes + 2)[None, :]]
    return dense, cnt, indptr, indices


def _sample_eval_negatives(pos_user: np.ndarray, pos_item: np.ndarray,
                           num_items: int, num_neg: int,
                           seen_keys: np.ndarray | None,
                           rng: np.random.Generator) -> np.ndarray:
    """N fixed negatives per eval positive; never the positive, optionally
    nothing the user ever touched (SURVEY.md §2.4 step 7).

    Fully vectorized (the per-row Python retry loop would
    not survive millions of eval targets): membership in the user's seen set
    is one searchsorted into `seen_keys`, a globally sorted array of
    user*(num_items+1)+item keys; resampling redraws the whole bad mask at
    once. Expected redraw rounds ~ O(log n / log(1/p_bad)), p_bad = seen
    fraction per user — tiny for real recsys sparsity.
    """
    n = pos_user.size
    neg = rng.integers(1, num_items + 1, size=(n, num_neg), dtype=np.int64)
    base = pos_user.astype(np.int64) * (num_items + 1)

    def bad_of(rows: np.ndarray, cand: np.ndarray) -> np.ndarray:
        """Per-element bad flags for candidates `cand` of target rows
        `rows` (both 1-D, same length)."""
        bad = cand == pos_item[rows]
        if seen_keys is not None and seen_keys.size:
            keys = base[rows] + cand
            idx = np.searchsorted(seen_keys, keys)
            idx_c = np.minimum(idx, seen_keys.size - 1)
            bad |= seen_keys[idx_c] == keys
        return bad

    # Full first pass, then redraw-and-recheck ONLY the bad positions:
    # unchanged entries can never turn bad, so this is bit-identical to
    # re-masking the whole matrix each round (the r2 implementation) while
    # dropping the per-round cost from O(n*num_neg*log) to O(k*log) — the
    # whole-matrix version was 92% of build_dataset wall at 1e7 events
    # (BASELINE.md r3 prep phase row).
    rows_all = np.repeat(np.arange(n, dtype=np.int64), num_neg)
    flat = neg.reshape(-1)
    bad = bad_of(rows_all, flat)
    pos = np.nonzero(bad)[0]
    for _ in range(100):
        if pos.size == 0:
            break
        redraw = rng.integers(1, num_items + 1, size=pos.size)
        flat[pos] = redraw
        still = bad_of(rows_all[pos], redraw)
        pos = pos[still]
    return flat.reshape(n, num_neg).astype(np.int32)


def build_dataset(user_raw: np.ndarray, item_raw: np.ndarray, ts: np.ndarray,
                  num_slots: int, user_fanout: int, item_fanout: int,
                  num_eval_neg: int = 100, min_user: int = 5, min_item: int = 5,
                  val_slots: int = 1, test_slots: int = 1,
                  exclude_seen_negatives: bool = True,
                  seed: int = 0, dataset_name: str = "unknown",
                  use_native: bool = True) -> Dataset:
    """Full pipeline raw events -> packed Dataset. See module docstring.

    Per-phase wall times land in meta['prep_phase_s'] (filter/remap, dedup,
    adjacency, eval negatives) so scale benchmarks can attribute cost
    (scripts/prep_bench.py)."""
    import time
    rng = np.random.default_rng(seed)
    user_raw = np.asarray(user_raw)
    item_raw = np.asarray(item_raw)
    ts = np.asarray(ts)
    phases = {}
    t0 = time.time()

    u_f, i_f, ts_f = filter_min_count(user_raw, item_raw, ts, min_user, min_item)
    if u_f.size == 0:
        raise ValueError("all events filtered out; lower min_user/min_item")
    user, _ = remap_ids(u_f)
    item, _ = remap_ids(i_f)
    num_users = int(user.max())
    num_items = int(item.max())
    slot = bucket_slots(ts_f, num_slots)
    phases["filter_remap"] = round(time.time() - t0, 1)
    t0 = time.time()

    # Deduplicate (u, i, t) triples — one edge per slot, one target per triple.
    triple = (slot.astype(np.int64) * (num_users + 1) + user) * (
        num_items + 1) + item
    _, first_idx = np.unique(triple, return_index=True)
    user_d, item_d, slot_d = user[first_idx], item[first_idx], slot[first_idx]
    phases["dedup"] = round(time.time() - t0, 1)
    t0 = time.time()

    u2i, u2i_cnt, u2i_indptr, u2i_indices = _build_side(
        user_d, item_d, slot_d, num_users, num_slots, user_fanout, rng,
        use_native=use_native)
    i2u, i2u_cnt, i2u_indptr, i2u_indices = _build_side(
        item_d, user_d, slot_d, num_items, num_slots, item_fanout, rng,
        use_native=use_native)
    phases["adjacency"] = round(time.time() - t0, 1)
    t0 = time.time()

    graph = GraphStore(
        num_users=num_users, num_items=num_items, num_slots=num_slots,
        u2i=u2i, u2i_cnt=u2i_cnt, i2u=i2u, i2u_cnt=i2u_cnt,
        u2i_indptr=u2i_indptr, u2i_indices=u2i_indices,
        i2u_indptr=i2u_indptr, i2u_indices=i2u_indices)

    # Time-based split (SURVEY.md §2.4 step 1): last slots -> test/val.
    test_lo = num_slots - test_slots
    val_lo = test_lo - val_slots
    usable = slot_d >= 1                      # t*=0 has no history
    tr = usable & (slot_d < val_lo)
    va = usable & (slot_d >= val_lo) & (slot_d < test_lo)
    te = usable & (slot_d >= test_lo)

    seen = None
    if exclude_seen_negatives:
        # Sorted (user, item) key array: one vectorized membership structure
        # for the whole eval-negative draw (no per-user Python sets).
        seen = np.sort(user_d.astype(np.int64) * (num_items + 1) + item_d)

    def _targets(mask, with_neg):
        t = Targets(user=user_d[mask].astype(np.int32),
                    item=item_d[mask].astype(np.int32),
                    slot=slot_d[mask].astype(np.int32))
        if with_neg:
            t.neg = _sample_eval_negatives(
                t.user, t.item, num_items, num_eval_neg, seen, rng)
        return t

    train_t = _targets(tr, with_neg=False)
    val_t = _targets(va, with_neg=True)
    test_t = _targets(te, with_neg=True)
    phases["targets_evalneg"] = round(time.time() - t0, 1)
    ds = Dataset(
        graph=graph,
        train=train_t,
        val=val_t,
        test=test_t,
        meta=dict(dataset=dataset_name, seed=seed,
                  user_fanout=user_fanout, item_fanout=item_fanout,
                  num_eval_neg=num_eval_neg,
                  num_events_raw=int(user_raw.size),
                  num_events_kept=int(user_d.size),
                  prep_phase_s=phases))
    return ds
