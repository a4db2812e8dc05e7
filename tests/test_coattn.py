"""Co-attention vs an independent numpy reference (SURVEY.md §4.2), incl.
full-padding edge cases and zero-gradient-through-padding."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from score_tpu.nn.coattn import cross_coattn_ref, masked_softmax, slot_mean


def np_masked_softmax(scores, mask):
    out = np.zeros_like(scores, dtype=np.float64)
    it = np.ndindex(scores.shape[:-1])
    for idx in it:
        s = scores[idx].astype(np.float64)
        m = mask[idx]
        if not m.any():
            continue
        v = s[m]
        e = np.exp(v - v.max())
        p = e / e.sum()
        row = np.zeros_like(s)
        row[m] = p
        out[idx] = row
    return out


def np_cross_coattn(Eu, Ei, mu, mi, Wr, eu, ei, pool="sum",
                    target_aware=True):
    """Straight-from-the-spec numpy implementation (SURVEY.md §2.4 step 3)."""
    B, T, n, d = Eu.shape
    m = Ei.shape[2]
    scale = 1.0 / np.sqrt(d)
    cu = np.zeros((B, T, d))
    ci = np.zeros((B, T, d))
    for b in range(B):
        for t in range(T):
            M = Eu[b, t] @ Wr @ Ei[b, t].T * scale     # [n, m]
            pm = mu[b, t][:, None] & mi[b, t][None, :]
            if pool in ("sum", "mean"):
                Mm = np.where(pm, M, 0.0)
                su = Mm.sum(axis=1)
                si = Mm.sum(axis=0)
                if pool == "mean":
                    su = su / max(mi[b, t].sum(), 1)
                    si = si / max(mu[b, t].sum(), 1)
            else:
                Mm = np.where(pm, M, -1e9)
                su = Mm.max(axis=1)
                si = Mm.max(axis=0)
                if not mi[b, t].any():
                    su = np.zeros(n)
                if not mu[b, t].any():
                    si = np.zeros(m)
            if target_aware:
                su = su + Eu[b, t] @ ei[b] * scale
                si = si + Ei[b, t] @ eu[b] * scale
            a = np_masked_softmax(su[None], mu[b, t][None])[0]
            bb = np_masked_softmax(si[None], mi[b, t][None])[0]
            cu[b, t] = a @ Eu[b, t]
            ci[b, t] = bb @ Ei[b, t]
    return cu, ci


def _rand_inputs(rng, B=3, T=4, n=5, m=6, d=8, pad_frac=0.4):
    Eu = rng.normal(size=(B, T, n, d)).astype(np.float32)
    Ei = rng.normal(size=(B, T, m, d)).astype(np.float32)
    mu = rng.random((B, T, n)) > pad_frac
    mi = rng.random((B, T, m)) > pad_frac
    # force some fully-padded slots on each side
    mu[0, 0] = False
    mi[1, 2] = False
    mu[2, 3] = False
    mi[2, 3] = False
    Wr = rng.normal(size=(d, d)).astype(np.float32)
    eu = rng.normal(size=(B, d)).astype(np.float32)
    ei = rng.normal(size=(B, d)).astype(np.float32)
    return Eu, Ei, mu, mi, Wr, eu, ei


@pytest.mark.parametrize("pool", ["sum", "mean", "max"])
@pytest.mark.parametrize("target_aware", [True, False])
def test_cross_coattn_vs_numpy(rng, pool, target_aware):
    Eu, Ei, mu, mi, Wr, eu, ei = _rand_inputs(rng)
    cu_np, ci_np = np_cross_coattn(Eu, Ei, mu, mi, Wr, eu, ei, pool=pool,
                                   target_aware=target_aware)
    cu, ci = cross_coattn_ref(
        jnp.asarray(Eu), jnp.asarray(Ei), jnp.asarray(mu), jnp.asarray(mi),
        jnp.asarray(Wr), jnp.asarray(eu), jnp.asarray(ei), pool=pool,
        target_aware=target_aware)
    np.testing.assert_allclose(np.asarray(cu), cu_np, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(ci), ci_np, rtol=1e-4, atol=1e-5)


def test_fully_padded_slots_are_zero(rng):
    Eu, Ei, mu, mi, Wr, eu, ei = _rand_inputs(rng)
    cu, ci = cross_coattn_ref(
        jnp.asarray(Eu), jnp.asarray(Ei), jnp.asarray(mu), jnp.asarray(mi),
        jnp.asarray(Wr), jnp.asarray(eu), jnp.asarray(ei))
    assert np.all(np.asarray(cu)[0, 0] == 0.0)       # mu[0,0] all False
    assert np.all(np.asarray(ci)[1, 2] == 0.0)       # mi[1,2] all False
    assert np.all(np.asarray(cu)[2, 3] == 0.0)       # both sides empty
    assert np.all(np.asarray(ci)[2, 3] == 0.0)
    assert not np.any(np.isnan(np.asarray(cu)))
    assert not np.any(np.isnan(np.asarray(ci)))


def test_padded_neighbor_zero_gradient(rng):
    """A padded neighbor's embedding must get exactly zero gradient
    (SURVEY.md §4.2: 'padded neighbor must have exactly zero gradient')."""
    Eu, Ei, mu, mi, Wr, eu, ei = _rand_inputs(rng)

    def loss(Eu_, Ei_):
        cu, ci = cross_coattn_ref(
            Eu_, Ei_, jnp.asarray(mu), jnp.asarray(mi), jnp.asarray(Wr),
            jnp.asarray(eu), jnp.asarray(ei))
        return jnp.sum(cu ** 2) + jnp.sum(ci ** 2)

    gu, gi = jax.grad(loss, argnums=(0, 1))(jnp.asarray(Eu), jnp.asarray(Ei))
    gu, gi = np.asarray(gu), np.asarray(gi)
    assert np.all(gu[~mu] == 0.0)
    assert np.all(gi[~mi] == 0.0)
    # and some valid entry does receive gradient
    assert np.any(gu[mu] != 0.0)


def test_padded_value_invariance(rng):
    """Changing the *values* at padded positions must not change outputs."""
    Eu, Ei, mu, mi, Wr, eu, ei = _rand_inputs(rng)
    args = (jnp.asarray(mu), jnp.asarray(mi), jnp.asarray(Wr),
            jnp.asarray(eu), jnp.asarray(ei))
    cu1, ci1 = cross_coattn_ref(jnp.asarray(Eu), jnp.asarray(Ei), *args)
    Eu2 = Eu.copy()
    Ei2 = Ei.copy()
    Eu2[~mu] = 777.0
    Ei2[~mi] = -55.0
    cu2, ci2 = cross_coattn_ref(jnp.asarray(Eu2), jnp.asarray(Ei2), *args)
    np.testing.assert_allclose(np.asarray(cu1), np.asarray(cu2), atol=1e-5)
    np.testing.assert_allclose(np.asarray(ci1), np.asarray(ci2), atol=1e-5)


def test_slot_mean_masked(rng):
    E = rng.normal(size=(2, 3, 4, 5)).astype(np.float32)
    m = rng.random((2, 3, 4)) > 0.5
    m[0, 0] = False
    out = np.asarray(slot_mean(jnp.asarray(E), jnp.asarray(m)))
    for b in range(2):
        for t in range(3):
            if m[b, t].any():
                np.testing.assert_allclose(out[b, t], E[b, t][m[b, t]].mean(0),
                                           rtol=1e-5, atol=1e-6)
            else:
                assert np.all(out[b, t] == 0.0)


def test_masked_softmax_sums(rng):
    s = rng.normal(size=(4, 7)).astype(np.float32)
    m = rng.random((4, 7)) > 0.3
    m[2] = False
    a = np.asarray(masked_softmax(jnp.asarray(s), jnp.asarray(m)))
    np.testing.assert_allclose(a.sum(-1)[[0, 1, 3]], 1.0, rtol=1e-5)
    assert np.all(a[2] == 0.0)
    assert np.all(a[~m] == 0.0)


def test_dot_free_candidates_path_matches_einsum(rng):
    """The DOT_FREE lowering (mul+f32-reduce instead of dot_general — the r3
    layout-copy fix) must be numerically equivalent, values and grads."""
    from score_tpu.nn import coattn as ca

    B, C, T, n, m, d = 3, 2, 4, 5, 6, 8
    Eu = jnp.asarray(rng.normal(size=(B, T, n, d)).astype(np.float32))
    Ei = jnp.asarray(rng.normal(size=(B, C, T, m, d)).astype(np.float32))
    mu = jnp.asarray(rng.random((B, T, n)) > 0.3)
    mi = jnp.asarray(rng.random((B, C, T, m)) > 0.3)
    eu = jnp.asarray(rng.normal(size=(B, d)).astype(np.float32))
    ei = jnp.asarray(rng.normal(size=(B, C, d)).astype(np.float32))
    mod = ca.CrossCoAttention(dim=d, pool="sum", target_aware=True)
    params = mod.init(jax.random.PRNGKey(0))
    params = jax.tree.map(
        lambda x: jnp.asarray(
            rng.normal(size=x.shape).astype(np.float32)) * 0.1, params)

    def run(flag):
        old = ca.DOT_FREE
        ca.DOT_FREE = flag
        try:
            def loss(p, Eu_):
                cu, ci = mod(p, Eu_, Ei, mu, mi, eu, ei)
                return jnp.sum(cu ** 2) + 0.5 * jnp.sum(ci ** 2), (cu, ci)
            (val, (cu, ci)), grads = jax.value_and_grad(
                loss, argnums=(0, 1), has_aux=True)(params, Eu)
            return val, cu, ci, grads
        finally:
            ca.DOT_FREE = old

    v0, cu0, ci0, g0 = run(False)
    v1, cu1, ci1, g1 = run(True)
    np.testing.assert_allclose(np.asarray(cu0), np.asarray(cu1),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(ci0), np.asarray(ci1),
                               rtol=1e-5, atol=1e-6)
    for a, b in zip(jax.tree.leaves(g0), jax.tree.leaves(g1)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("pool,target_aware,C",
                         [("sum", True, 2), ("sum", False, 2),
                          ("mean", True, 2), ("sum", True, 12)])
def test_wr_on_summary_matches_ref(rng, pool, target_aware, C):
    """The WR_ON_SUMMARY reassociation ((Eu Wr)·x == Eu·(Wr x); target term
    folded into the same dot) must be tolerance-equivalent to the
    materialized-EuW path — values and grads — on both the unrolled C<=8
    path and the generic C>8 path."""
    from score_tpu.nn import coattn as ca

    B, T, n, m, d = 4, 3, 5, 6, 8
    Eu = jnp.asarray(rng.normal(size=(B, T, n, d)).astype(np.float32))
    Ei = jnp.asarray(rng.normal(size=(B, C, T, m, d)).astype(np.float32))
    mu = jnp.asarray(rng.random((B, T, n)) > 0.3)
    mi = jnp.asarray(rng.random((B, C, T, m)) > 0.3)
    eu = jnp.asarray(rng.normal(size=(B, d)).astype(np.float32))
    ei = jnp.asarray(rng.normal(size=(B, C, d)).astype(np.float32))
    mod = ca.CrossCoAttention(dim=d, pool=pool, target_aware=target_aware)
    params = mod.init(jax.random.PRNGKey(0))
    params = jax.tree.map(
        lambda x: jnp.asarray(
            rng.normal(size=x.shape).astype(np.float32)) * 0.1, params)

    def run(flag):
        old = ca.WR_ON_SUMMARY
        ca.WR_ON_SUMMARY = flag
        try:
            def loss(p, Eu_, Ei_):
                cu, ci = mod(p, Eu_, Ei_, mu, mi, eu, ei)
                return jnp.sum(cu ** 2) + 0.5 * jnp.sum(ci ** 2), (cu, ci)
            (val, (cu, ci)), grads = jax.value_and_grad(
                loss, argnums=(0, 1, 2), has_aux=True)(params, Eu, Ei)
            return val, cu, ci, grads
        finally:
            ca.WR_ON_SUMMARY = old

    v0, cu0, ci0, g0 = run(False)
    v1, cu1, ci1, g1 = run(True)
    np.testing.assert_allclose(np.asarray(cu0), np.asarray(cu1),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(ci0), np.asarray(ci1),
                               rtol=1e-5, atol=1e-6)
    for a, b in zip(jax.tree.leaves(g0), jax.tree.leaves(g1)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-4, atol=1e-5)


def test_shift_pushdown_matches_materialized_rolls(rng):
    """The i_shifts shift-pushdown path (coattn.PUSH_ROLLS=True) must equal
    the materialized-roll path bit-for-bit in f32, values and grads —
    including the subtlety that mi[:, c] mixes the rolled item count with
    the UN-rolled target slot_valid."""
    from score_tpu.nn import coattn as ca

    B, T, n, m, d = 5, 4, 3, 6, 8
    k = 2                      # negatives -> C = 1 + k
    Eu = jnp.asarray(rng.normal(size=(B, T, n, d)).astype(np.float32))
    Ei0 = jnp.asarray(rng.normal(size=(B, 1, T, m, d)).astype(np.float32))
    mu = jnp.asarray(rng.random((B, T, n)) > 0.3)
    eu = jnp.asarray(rng.normal(size=(B, d)).astype(np.float32))
    shifts = jnp.asarray([1, 3], dtype=jnp.int32)
    # per-candidate ei and mi as ScoreModel builds them: batch-rolls of the
    # positive's tensors, mask = rolled count AND un-rolled slot_valid
    ei1 = jnp.asarray(rng.normal(size=(B, 1, d)).astype(np.float32))
    ei = jnp.concatenate(
        [ei1] + [jnp.roll(ei1, -s, axis=0) for s in shifts], axis=1)
    sv = jnp.asarray(rng.random((B, T)) > 0.25)
    i_cnt1 = jnp.asarray(rng.integers(0, m + 1, size=(B, 1, T)))
    i_cnt = jnp.concatenate(
        [i_cnt1] + [jnp.roll(i_cnt1, -s, axis=0) for s in shifts], axis=1)
    j = jnp.arange(m)[None, None, None, :]
    mi = (j < i_cnt[..., None]) & sv[:, None, :, None]      # [B,C,T,m]

    mod = ca.CrossCoAttention(dim=d, pool="sum", target_aware=True)
    params = mod.init(jax.random.PRNGKey(0))
    params = jax.tree.map(
        lambda x: jnp.asarray(
            rng.normal(size=x.shape).astype(np.float32)) * 0.1, params)

    def run(flag):
        old = ca.PUSH_ROLLS
        ca.PUSH_ROLLS = flag
        try:
            def loss(p, Eu_, Ei_):
                cu, ci = mod(p, Eu_, Ei_, mu, mi, eu, ei,
                                   i_shifts=shifts)
                return jnp.sum(cu ** 2) + 0.5 * jnp.sum(ci ** 2), (cu, ci)
            (val, outs), grads = jax.value_and_grad(
                loss, argnums=(0, 1, 2), has_aux=True)(params, Eu, Ei0)
            return outs, grads
        finally:
            ca.PUSH_ROLLS = old

    (cu0, ci0), g0 = run(False)
    (cu1, ci1), g1 = run(True)
    np.testing.assert_allclose(np.asarray(cu0), np.asarray(cu1),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(ci0), np.asarray(ci1),
                               rtol=1e-5, atol=1e-6)
    for a, b in zip(jax.tree.leaves(g0), jax.tree.leaves(g1)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-4, atol=1e-5)
