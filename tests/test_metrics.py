"""Metric functions vs a numpy rank-sum oracle / brute force (SURVEY.md
§4.2)."""

import jax.numpy as jnp
import numpy as np

from score_tpu.metrics import (F16_BINS, auc, f16_bucket, hist_auc,
                               rank_sum_keys, ranking_metrics, ranking_sums,
                               score_hists)


def roc_auc_score(labels, scores):
    """Tie-aware rank-sum (Mann-Whitney) AUC in float64: the test oracle
    (same semantics as sklearn's roc_auc_score for binary labels)."""
    s = np.asarray(scores, np.float64)
    y = np.asarray(labels) > 0
    order = np.argsort(s, kind="mergesort")
    ranks = np.empty(s.size)
    ranks[order] = np.arange(1, s.size + 1)
    _, inv, counts = np.unique(s, return_inverse=True, return_counts=True)
    ranks = (np.bincount(inv, weights=ranks) / counts)[inv]   # tie average
    n_pos = int(y.sum())
    n_neg = s.size - n_pos
    return (ranks[y].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg)


def test_rank_sum_oracle_vs_pair_count(rng):
    """The oracle equals the pairwise definition: P(pos > neg) + P(tie)/2."""
    scores = rng.integers(0, 7, size=120).astype(np.float64)
    labels = rng.random(120) > 0.4
    pos, neg = scores[labels], scores[~labels]
    diff = pos[:, None] - neg[None, :]
    want = ((diff > 0).sum() + 0.5 * (diff == 0).sum()) / diff.size
    np.testing.assert_allclose(roc_auc_score(labels, scores), want,
                               rtol=1e-12)


def test_auc_vs_sklearn(rng):
    scores = rng.normal(size=500).astype(np.float32)
    labels = (rng.random(500) > 0.7).astype(np.float32)
    got = float(auc(jnp.asarray(scores), jnp.asarray(labels)))
    want = roc_auc_score(labels, scores)
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_auc_with_ties(rng):
    scores = rng.integers(0, 5, size=300).astype(np.float32)  # heavy ties
    labels = (rng.random(300) > 0.5).astype(np.float32)
    got = float(auc(jnp.asarray(scores), jnp.asarray(labels)))
    want = roc_auc_score(labels, scores)
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_auc_weights_mask_rows(rng):
    scores = rng.normal(size=400).astype(np.float32)
    labels = (rng.random(400) > 0.6).astype(np.float32)
    w = (rng.random(400) > 0.25).astype(np.float32)
    got = float(auc(jnp.asarray(scores), jnp.asarray(labels), jnp.asarray(w)))
    keep = w > 0
    want = roc_auc_score(labels[keep], scores[keep])
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_auc_large_scale_no_overflow(rng):
    """Regression: n_pos * n_neg > 2^31 overflowed int32 and produced
    AUC = 630 at real eval scale (caught in verification, round 1)."""
    n_pos, n_neg = 30_000, 110_000
    scores = np.concatenate([
        rng.normal(loc=0.3, size=n_pos),
        rng.normal(loc=0.0, size=n_neg)]).astype(np.float32)
    labels = np.concatenate([
        np.ones(n_pos), np.zeros(n_neg)]).astype(np.float32)
    got = float(auc(jnp.asarray(scores), jnp.asarray(labels)))
    want = roc_auc_score(labels, scores)
    assert 0.0 <= got <= 1.0
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_auc_degenerate():
    assert float(auc(jnp.asarray([1.0, 2.0]), jnp.asarray([1.0, 1.0]))) == 0.5


def brute_rank_metrics(pos, neg, ks):
    B, N = neg.shape
    out = {f"hr@{k}": 0.0 for k in ks}
    out.update({f"ndcg@{k}": 0.0 for k in ks})
    out["mrr"] = 0.0
    for b in range(B):
        r = 1 + (neg[b] > pos[b]).sum() + 0.5 * (neg[b] == pos[b]).sum()
        for k in ks:
            if r <= k:
                out[f"hr@{k}"] += 1.0
                out[f"ndcg@{k}"] += 1.0 / np.log2(1 + r)
        out["mrr"] += 1.0 / r
    return {k: v / B for k, v in out.items()}


def test_ranking_metrics_vs_brute(rng):
    B, N = 64, 30
    pos = rng.normal(size=B).astype(np.float32)
    neg = rng.normal(size=(B, N)).astype(np.float32)
    # inject exact ties
    neg[0, 0] = pos[0]
    got = {k: float(v) for k, v in ranking_metrics(
        jnp.asarray(pos), jnp.asarray(neg), ks=(1, 5, 10)).items()}
    want = brute_rank_metrics(pos, neg, (1, 5, 10))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)


def test_f16_bucket_order_preserving(rng):
    """Bucket keys sort exactly like the scores they bucket (incl. sign
    boundary, ±0, and clipping saturation at the extremes)."""
    xs = np.concatenate([
        rng.normal(scale=5.0, size=2000).astype(np.float32),
        np.asarray([-0.0, 0.0, -1e-6, 1e-6, -7e4, 7e4, -60000., 60000.],
                   np.float32)])
    keys = np.asarray(f16_bucket(jnp.asarray(xs)))
    assert keys.min() >= 0 and keys.max() < F16_BINS
    order = np.argsort(xs, kind="stable")
    k_sorted = keys[order]
    assert (np.diff(k_sorted) >= 0).all()
    # strictly increasing where the (clipped) f16 values differ
    f16 = np.clip(xs, -6e4, 6e4).astype(np.float16)[order]
    strict = np.asarray(f16[1:]) > np.asarray(f16[:-1])
    assert (np.diff(k_sorted)[strict] > 0).all()
    # ±0 collide (one tie bucket, not two adjacent ones)
    kz = np.asarray(f16_bucket(jnp.asarray([-0.0, 0.0], np.float32)))
    assert kz[0] == kz[1]


def test_hist_auc_exact_on_f16_scores(rng):
    """On f16-representable scores the streamed histogram AUC equals the
    sort-based rank-sum AUC exactly (same tie semantics)."""
    B, N = 400, 20
    pos = rng.normal(size=B).astype(np.float16).astype(np.float32)
    neg = rng.normal(size=(B, N)).astype(np.float16).astype(np.float32)
    neg[0, :3] = pos[0]                    # exact ties
    w = np.ones(B, np.float32)
    w[-25:] = 0.0
    hp = jnp.zeros(F16_BINS, jnp.int32)
    hn = jnp.zeros(F16_BINS, jnp.int32)
    # two blocks: merging across blocks must be exact
    for sl in (slice(0, 150), slice(150, B)):
        hp, hn = score_hists(jnp.asarray(pos[sl]), jnp.asarray(neg[sl]),
                             jnp.asarray(w[sl]), hp, hn)
    got = hist_auc(np.asarray(hp), np.asarray(hn))
    pooled = np.concatenate([pos, neg.reshape(-1)])
    labels = np.concatenate([np.ones(B), np.zeros(B * N)]).astype(np.float32)
    pooled_w = np.concatenate([w, np.repeat(w, N)])
    want = float(auc(jnp.asarray(pooled), jnp.asarray(labels),
                     jnp.asarray(pooled_w)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)


def test_hist_auc_close_on_f32_scores(rng):
    """On raw f32 scores the only deviation is f16-resolution tie
    granularity — pinned small (the evaluate docstring's |Δ| claim)."""
    B, N = 2000, 50
    pos = rng.normal(loc=0.4, size=B).astype(np.float32)
    neg = rng.normal(size=(B, N)).astype(np.float32)
    hp, hn = score_hists(jnp.asarray(pos), jnp.asarray(neg), None,
                         jnp.zeros(F16_BINS, jnp.int32),
                         jnp.zeros(F16_BINS, jnp.int32))
    got = hist_auc(np.asarray(hp), np.asarray(hn))
    pooled = np.concatenate([pos, neg.reshape(-1)])
    labels = np.concatenate([np.ones(B), np.zeros(B * N)]).astype(np.float32)
    want = float(auc(jnp.asarray(pooled), jnp.asarray(labels)))
    assert abs(got - want) < 2e-4, (got, want)


def test_ranking_sums_merge_matches_metrics(rng):
    """ranking_sums over disjoint blocks, merged by addition, reproduces
    ranking_metrics over the concatenation (the streaming contract)."""
    B, N = 90, 12
    pos = rng.normal(size=B).astype(np.float32)
    neg = rng.normal(size=(B, N)).astype(np.float32)
    w = (rng.random(B) > 0.2).astype(np.float32)
    ks = (1, 5, 10)
    names = rank_sum_keys(ks)
    total = np.zeros(len(names), np.float64)
    for sl in (slice(0, 40), slice(40, B)):
        s = ranking_sums(jnp.asarray(pos[sl]), jnp.asarray(neg[sl]), ks=ks,
                         weights=jnp.asarray(w[sl]))
        total += np.asarray([float(s[k]) for k in names])
    merged = dict(zip(names, total))
    denom = max(merged.pop("wsum"), 1.0)
    want = ranking_metrics(jnp.asarray(pos), jnp.asarray(neg), ks=ks,
                           weights=jnp.asarray(w))
    for k, v in merged.items():
        np.testing.assert_allclose(v / denom, float(want[k]), rtol=1e-5,
                                   err_msg=k)


def test_ranking_metrics_weights(rng):
    B, N = 16, 10
    pos = rng.normal(size=B).astype(np.float32)
    neg = rng.normal(size=(B, N)).astype(np.float32)
    w = np.ones(B, np.float32)
    w[10:] = 0.0
    got = {k: float(v) for k, v in ranking_metrics(
        jnp.asarray(pos), jnp.asarray(neg), ks=(5,),
        weights=jnp.asarray(w)).items()}
    want = brute_rank_metrics(pos[:10], neg[:10], (5,))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
