"""Preprocessing invariants (SURVEY.md §4.2 unit tier)."""

import numpy as np
import pytest

from score_tpu.data import synth
from score_tpu.data.prep_common import (bucket_slots, build_dataset,
                                        filter_min_count, remap_ids)


def test_remap_contiguous():
    vals = np.array([100, 7, 100, 42, 7, 7])
    mapped, uniq = remap_ids(vals)
    assert mapped.min() == 1
    assert mapped.max() == len(uniq) == 3
    # same raw id -> same new id
    assert mapped[0] == mapped[2]
    assert mapped[1] == mapped[4] == mapped[5]


def test_bucket_slots_range():
    ts = np.array([0, 100, 500, 999, 1000])
    s = bucket_slots(ts, 10)
    assert s.min() == 0 and s.max() == 9
    assert (np.diff(s[np.argsort(ts, kind="stable")]) >= 0).all()


def test_filter_min_count_drops():
    user = np.array([1, 1, 1, 2])
    item = np.array([5, 5, 5, 6])
    ts = np.arange(4)
    u, i, t = filter_min_count(user, item, ts, min_user=2, min_item=2)
    assert (u == 1).all() and (i == 5).all()


def test_dense_is_seeded_sample_of_csr(tiny_dataset):
    g = tiny_dataset.graph
    r = np.random.default_rng(1)
    for _ in range(100):
        t = int(r.integers(0, g.num_slots))
        v = int(r.integers(1, g.num_users + 1))
        csr = set(g.get_neighbors("user", v, t).tolist())
        c = int(g.u2i_cnt[t, v])
        dense = g.u2i[t, v, :c].tolist()
        assert len(set(dense)) == c            # no dup in sample
        assert set(dense) <= csr               # subset of full row
        assert c == min(len(csr), g.user_fanout)
        assert (g.u2i[t, v, c:] == 0).all()    # zero-padded tail


def test_pad_rows_zero(tiny_dataset):
    g = tiny_dataset.graph
    assert (g.u2i[:, 0] == 0).all() and (g.u2i_cnt[:, 0] == 0).all()
    assert (g.i2u[:, 0] == 0).all() and (g.i2u_cnt[:, 0] == 0).all()


def test_adjacency_symmetry(tiny_dataset):
    """u in i2u[t, i] iff i in u2i[t, u] (CSR, untruncated)."""
    g = tiny_dataset.graph
    r = np.random.default_rng(2)
    for _ in range(50):
        t = int(r.integers(0, g.num_slots))
        u = int(r.integers(1, g.num_users + 1))
        for i in g.get_neighbors("user", u, t).tolist():
            assert u in set(g.get_neighbors("item", int(i), t).tolist())


def test_split_no_leakage(tiny_dataset):
    """Targets: t* >= 1 everywhere; splits are time-ordered (train < val <
    test slots); history slots strictly precede t* by construction of the
    slot_valid mask (tested in test_graph)."""
    ds = tiny_dataset
    assert ds.train.slot.min() >= 1
    assert ds.train.slot.max() < ds.val.slot.min()
    assert ds.val.slot.max() < ds.test.slot.min()


def test_eval_negatives_exclude_seen(tiny_dataset):
    ds = tiny_dataset
    seen = {}
    g = ds.graph
    for t in range(g.num_slots):
        for u in range(1, g.num_users + 1):
            s, e = g.u2i_indptr[t, u], g.u2i_indptr[t, u + 1]
            if e > s:
                seen.setdefault(u, set()).update(
                    g.u2i_indices[s:e].tolist())
    for row in range(min(len(ds.val), 200)):
        u = int(ds.val.user[row])
        negs = set(ds.val.neg[row].tolist())
        assert int(ds.val.item[row]) not in negs
        assert not (negs & seen.get(u, set()))


def test_prep_deterministic():
    user, item, ts = synth.synth_events(100, 200, 5000, num_slots=6, seed=3)
    a = build_dataset(user, item, ts, num_slots=6, user_fanout=4,
                      item_fanout=4, num_eval_neg=5, min_user=2, min_item=2,
                      seed=7)
    b = build_dataset(user, item, ts, num_slots=6, user_fanout=4,
                      item_fanout=4, num_eval_neg=5, min_user=2, min_item=2,
                      seed=7)
    np.testing.assert_array_equal(a.graph.u2i, b.graph.u2i)
    np.testing.assert_array_equal(a.val.neg, b.val.neg)
    np.testing.assert_array_equal(a.train.user, b.train.user)


def test_save_load_roundtrip(tiny_dataset, tmp_path):
    from score_tpu.data.schema import load_dataset, save_dataset
    save_dataset(tiny_dataset, str(tmp_path))
    ds2 = load_dataset(str(tmp_path))
    np.testing.assert_array_equal(tiny_dataset.graph.u2i, ds2.graph.u2i)
    np.testing.assert_array_equal(tiny_dataset.graph.i2u_indptr,
                                  ds2.graph.i2u_indptr)
    np.testing.assert_array_equal(tiny_dataset.test.neg, ds2.test.neg)
    assert ds2.num_users == tiny_dataset.num_users


def test_crossattr_drift_active_skew():
    """drift_active=k makes drifting users (the back stable_frac-split half)
    ~k times more active — the knob that skews eval targets toward the
    quadrant where only cross co-attention has signal."""
    import numpy as np

    n_users, k = 400, 3.0
    user, item, ts = synth.synth_events(
        n_users, 2000, 60_000, num_slots=6, seed=3, mode="crossattr",
        stable_frac=0.5, drift_active=k)
    n_stable = int(0.5 * n_users)
    cnt_stable = np.sum(user < n_stable)
    cnt_drift = np.sum(user >= n_stable)
    ratio = cnt_drift / cnt_stable
    assert 0.8 * k < ratio < 1.2 * k, ratio
    # ts still spans the slot grid and sorts ascending
    assert (np.diff(ts) >= 0).all()


def test_synth_schemas(tmp_path):
    from score_tpu.data.prep_datasets import PREP
    for name in ("ccmr", "taobao", "tmall"):
        raw = str(tmp_path / f"{name}.csv")
        synth.write_raw(name, raw, num_users=80, num_items=150,
                        num_events=4000, num_slots=6, seed=1)
        ds = PREP[name](str(tmp_path / name), raw_path=raw,
                        min_user=2, min_item=2, num_slots=6,
                        user_fanout=4, item_fanout=4)
        assert len(ds.train) > 0 and len(ds.test) > 0


@pytest.mark.parametrize("chunk_rows", [1, 3, 7, 1000])
def test_csv_reader_across_chunk_boundaries(tmp_path, chunk_rows):
    """The chunked reader returns the asked columns, in the asked order,
    whatever the chunk size (header skipped, no row lost or repeated)."""
    from score_tpu.data.prep_datasets import _read_csv_cols
    path = synth.write_raw("taobao", str(tmp_path / "t.csv"), num_users=30,
                           num_items=40, num_events=500, num_slots=4)
    want = np.loadtxt(path, delimiter=",", skiprows=1, dtype=np.int64)
    got = _read_csv_cols(path, (4, 0, 1), chunk_rows=chunk_rows)
    for col, arr in zip((4, 0, 1), got):
        assert arr.dtype == np.int64
        np.testing.assert_array_equal(arr, want[:, col])


def test_csv_reader_headerless_and_string_columns(tmp_path):
    """A real UserBehavior log has no header and a string behavior column;
    only the integer columns asked for are parsed."""
    from score_tpu.data.prep_datasets import _read_csv_cols
    path = tmp_path / "ub.csv"
    path.write_text("1,10,5,pv,1511544070\n2,11,5,buy,1511544071\n"
                    "3,12,6,pv,1511544072\n")
    user, item, ts = _read_csv_cols(str(path), (0, 1, 4), chunk_rows=2)
    np.testing.assert_array_equal(user, [1, 2, 3])
    np.testing.assert_array_equal(item, [10, 11, 12])
    np.testing.assert_array_equal(ts, [1511544070, 1511544071, 1511544072])


def test_synthetic_prep_skips_the_csv(tmp_path):
    """Without a raw file, prep builds from the synthetic columns directly
    (writing no CSV) and equals the dataset built from the CSV."""
    import os

    from score_tpu.data.prep_datasets import PREP
    kw = dict(num_users=80, num_items=150, num_events=4000, num_slots=6)
    direct = PREP["ccmr"](str(tmp_path / "direct"), synth_kw=kw,
                          min_user=2, min_item=2, num_slots=6,
                          user_fanout=4, item_fanout=4)
    raw = synth.write_raw("ccmr", str(tmp_path / "ccmr.csv"), **kw)
    via_csv = PREP["ccmr"](str(tmp_path / "csv"), raw_path=raw,
                           min_user=2, min_item=2, num_slots=6,
                           user_fanout=4, item_fanout=4)
    assert not any(n.endswith(".csv") for n in os.listdir(tmp_path / "direct"))
    np.testing.assert_array_equal(direct.train.user, via_csv.train.user)
    np.testing.assert_array_equal(direct.val.neg, via_csv.val.neg)
    np.testing.assert_array_equal(direct.graph.u2i, via_csv.graph.u2i)
