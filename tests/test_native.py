"""Native C++ prep kernels vs the numpy reference path (SURVEY.md §2.1)."""

import numpy as np
import pytest

from score_tpu import native
from score_tpu.data.prep_common import _build_side, bucket_slots


@pytest.fixture(scope="module")
def lib():
    lib = native.load()
    if lib is None:
        pytest.skip("no C++ toolchain available")
    return lib


def _triples(rng, n_events=20000, num_nodes=300, num_nbr=500, num_slots=7):
    node = rng.integers(1, num_nodes + 1, size=n_events).astype(np.int32)
    nbr = rng.integers(1, num_nbr + 1, size=n_events).astype(np.int32)
    slot = rng.integers(0, num_slots, size=n_events).astype(np.int32)
    # deduplicate like build_dataset does
    key = (slot.astype(np.int64) * (num_nodes + 1) + node) * (num_nbr + 1) + nbr
    _, idx = np.unique(key, return_index=True)
    return node[idx], nbr[idx], slot[idx], num_nodes, num_slots


def test_native_csr_matches_numpy(lib, rng):
    node, nbr, slot, num_nodes, num_slots = _triples(rng)
    fanout = 6
    d_np, c_np, p_np, i_np = _build_side(
        node, nbr, slot, num_nodes, num_slots, fanout,
        np.random.default_rng(0), use_native=False)
    d_na, c_na, p_na, i_na = native.build_side_native(
        node, nbr, slot, num_nodes, num_slots, fanout, seed=0)
    # CSR must be identical (both sort within rows)
    np.testing.assert_array_equal(p_np, p_na)
    np.testing.assert_array_equal(np.sort(i_np), np.sort(i_na))
    for t in range(num_slots):
        for v in range(0, num_nodes + 2, 37):
            s, e = p_np[t, min(v, num_nodes)], p_np[t, min(v, num_nodes) + 1]
            np.testing.assert_array_equal(
                np.sort(i_np[s:e]), np.sort(i_na[s:e]))
    # counts identical; dense differs only in which sample was drawn
    np.testing.assert_array_equal(c_np, c_na)


def test_native_dense_contract(lib, rng):
    node, nbr, slot, num_nodes, num_slots = _triples(rng)
    fanout = 4
    dense, cnt, indptr, indices = native.build_side_native(
        node, nbr, slot, num_nodes, num_slots, fanout, seed=123)
    for t in range(num_slots):
        for v in range(1, num_nodes + 1, 23):
            s, e = indptr[t, v], indptr[t, v + 1]
            row = set(indices[s:e].tolist())
            c = cnt[t, v]
            assert c == min(len(row), fanout)
            picked = dense[t, v, :c].tolist()
            assert len(set(picked)) == c          # sample w/o replacement
            assert set(picked) <= row
            assert (dense[t, v, c:] == 0).all()
    assert (dense[:, 0] == 0).all() and (cnt[:, 0] == 0).all()


def test_native_deterministic(lib, rng):
    node, nbr, slot, num_nodes, num_slots = _triples(rng)
    a = native.build_side_native(node, nbr, slot, num_nodes, num_slots, 5,
                                 seed=7)
    b = native.build_side_native(node, nbr, slot, num_nodes, num_slots, 5,
                                 seed=7)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    c = native.build_side_native(node, nbr, slot, num_nodes, num_slots, 5,
                                 seed=8)
    assert any(not np.array_equal(x, y) for x, y in zip(a, c))


def test_native_bucket_slots(lib, rng):
    """Native path ≡ the numpy formula. bucket_slots itself now routes
    integer ts through the native kernel, so the numpy
    side is computed on float64 ts to force the reference path — the formula
    is dtype-agnostic, so the expected slots are identical."""
    ts = rng.integers(0, 10 ** 9, size=5000).astype(np.int64)
    got = native.bucket_slots_native(ts, 12)
    want = bucket_slots(ts.astype(np.float64), 12)
    np.testing.assert_array_equal(got, want)
    # and the production entry point picks the native path for int64 ts
    np.testing.assert_array_equal(bucket_slots(ts, 12), want)


def test_out_of_range_id_rejected(lib):
    node = np.array([1, 999999], np.int32)
    nbr = np.array([1, 2], np.int32)
    slot = np.array([0, 0], np.int32)
    with pytest.raises(ValueError):
        native.build_side_native(node, nbr, slot, num_nodes=10, num_slots=2,
                                 fanout=3, seed=0)
