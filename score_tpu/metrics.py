"""Device-side evaluation metrics: AUC, HR@K, NDCG@K, MRR
(SURVEY.md §2.3 #12; paper §4.2 protocol).

Two AUC formulations, both tie-aware:

* `auc` — in-memory rank-sum (Mann-Whitney U) with average-tie ranks
  (cross-checked against a float64 numpy oracle in tests), pure jnp via
  two `searchsorted` calls over the pooled score vector. O(n log n)
  device memory in the pooled size — fine for batch monitoring, impossible
  at reference eval scale (the 1e8-prep val split pools ~2.1e9 scores).
* `score_hists` + `hist_auc` — the STREAMING formulation `train.evaluate`
  uses: scores are bucketed at float16
  resolution into order-preserving int32 keys (`f16_bucket`), and two
  65536-bin int32 histograms (positives / negatives) accumulate across
  blocks on device. Pooled AUC then falls out of the histograms in one
  O(bins) pass: U = Σ_b pos[b]·(neg_below[b] + ½·neg[b]). Histogram counts
  are exact (int32; adds are 0/1), blocks merge by addition (and would
  psum across hosts — the sufficient statistic is the histogram pair), and
  the only deviation from the in-memory form is that scores equal at
  float16 resolution count as ties (measured |Δ| vs the sort-based AUC on
  f32 scores ~1e-5, tests/test_metrics.py; EXACTLY equal when scores are
  f16-representable).

Ranking metrics follow the sampled-candidate protocol (SURVEY.md §2.4 step
7): each positive is ranked against its N fixed negatives; ties count half.
`ranking_sums` is the streaming-mergeable form (weighted sums + the weight
total); `ranking_metrics` is the in-memory convenience wrapper over it.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

F16_BINS = 1 << 16


def auc(scores: jnp.ndarray, labels: jnp.ndarray,
        weights: jnp.ndarray | None = None) -> jnp.ndarray:
    """Pooled pointwise AUC with average-tie ranks. scores/labels: [N]."""
    if weights is None:
        weights = jnp.ones_like(scores)
    # Average ranks via searchsorted against the sorted score vector.
    # With weights in {0,1} we drop masked entries by pushing them to -inf
    # and subtracting their contribution from the counts.
    valid = weights > 0
    s = jnp.where(valid, scores, jnp.inf)          # masked sort high
    sorted_s = jnp.sort(s)
    lo = jnp.searchsorted(sorted_s, scores, side="left")
    hi = jnp.searchsorted(sorted_s, scores, side="right")
    # entries == inf (masked) all sit at the top; valid ranks are unaffected.
    rank = (lo + hi + 1).astype(jnp.float32) / 2.0  # 1-based average rank
    pos = (labels > 0) & valid
    neg = (labels <= 0) & valid
    # float32 throughout: n_pos * n_neg overflows int32 beyond ~46k x 46k
    # (seen at real eval scale: 24.5k positives x 2.45M pooled entries).
    # Mean-rank form keeps magnitudes ~n instead of ~n^2.
    n_pos = jnp.sum(pos).astype(jnp.float32)
    n_neg = jnp.sum(neg).astype(jnp.float32)
    mean_rank_pos = (jnp.sum(jnp.where(pos, rank, 0.0))
                     / jnp.maximum(n_pos, 1.0))
    a = (mean_rank_pos - (n_pos + 1.0) / 2.0) / jnp.maximum(n_neg, 1.0)
    return jnp.where((n_pos > 0) & (n_neg > 0), a, 0.5)


def rank_sum_keys(ks: Sequence[int] = (1, 5, 10)) -> Tuple[str, ...]:
    """Fixed metric-name order for the stacked sums vector."""
    names = []
    for k in ks:
        names += [f"hr@{k}", f"ndcg@{k}"]
    return tuple(names + ["mrr", "gauc", "wsum"])


def ranking_sums(pos_scores: jnp.ndarray, neg_scores: jnp.ndarray,
                 ks: Sequence[int] = (1, 5, 10),
                 weights: jnp.ndarray | None = None
                 ) -> Dict[str, jnp.ndarray]:
    """Weighted SUMS of the per-target ranking metrics, plus 'wsum'.

    The streaming-mergeable form: sums over disjoint target blocks add
    exactly (train.evaluate stacks one row per block and reduces in f64 on
    the host, so no f32 accumulator ever exceeds one block's magnitude).
    """
    if weights is None:
        weights = jnp.ones_like(pos_scores)
    w = weights.astype(jnp.float32)
    gt = jnp.sum(neg_scores > pos_scores[:, None], axis=1)
    eq = jnp.sum(neg_scores == pos_scores[:, None], axis=1)
    rank = 1.0 + gt + 0.5 * eq                      # [B]
    out: Dict[str, jnp.ndarray] = {}
    for k in ks:
        hit = (rank <= k).astype(jnp.float32)
        out[f"hr@{k}"] = jnp.sum(hit * w)
        ndcg = jnp.where(rank <= k, 1.0 / jnp.log2(1.0 + rank), 0.0)
        out[f"ndcg@{k}"] = jnp.sum(ndcg * w)
    out["mrr"] = jnp.sum(w / rank)
    # per-target (grouped) AUC, a.k.a. GAUC: with one positive vs N sampled
    # negatives, the group's AUC is the fraction of negatives ranked below
    # it (ties count half). The reference's AUC may be pooled or per-user
    # (SURVEY.md Appendix B item 5) — we report both.
    N = neg_scores.shape[1]
    out["gauc"] = jnp.sum((1.0 - (rank - 1.0) / N) * w)
    out["wsum"] = jnp.sum(w)
    return out


def ranking_metrics(pos_scores: jnp.ndarray, neg_scores: jnp.ndarray,
                    ks: Sequence[int] = (1, 5, 10),
                    weights: jnp.ndarray | None = None
                    ) -> Dict[str, jnp.ndarray]:
    """HR@K / NDCG@K / MRR / GAUC of each positive among its sampled
    negatives (means over weighted targets — ranking_sums / wsum).

    pos_scores: [B], neg_scores: [B, N], weights: [B] (0/1 for padded rows).
    Rank r = 1 + #(neg > pos) + 0.5 * #(neg == pos). With one relevant item,
    NDCG@K = 1/log2(1+r) if r <= K else 0; HR@K = [r <= K]; MRR = 1/r.
    """
    sums = ranking_sums(pos_scores, neg_scores, ks=ks, weights=weights)
    denom = jnp.maximum(sums.pop("wsum"), 1.0)
    return {k: v / denom for k, v in sums.items()}


def f16_bucket(x: jnp.ndarray) -> jnp.ndarray:
    """Order-preserving int32 bucket of a score at float16 resolution.

    Scores are clipped to ±6e4 (inside f16 range; clipping preserves order
    except among saturated values, which become ties), -0 is normalized to
    +0, and the f16 bit pattern is mapped to a total order on [0, 65536):
    negatives reverse (0xFFFF - bits), non-negatives shift up (bits +
    0x8000). Two scores land in the same bucket iff they round to the same
    float16 — the tie-granularity statement of the streaming AUC.
    """
    x = jnp.clip(x.astype(jnp.float32), -6.0e4, 6.0e4) + 0.0   # -0 -> +0
    bits = jax.lax.bitcast_convert_type(
        x.astype(jnp.float16), jnp.uint16).astype(jnp.int32)
    return jnp.where(bits >= 0x8000, 0xFFFF - bits, bits + 0x8000)


def score_hists(pos_scores: jnp.ndarray, neg_scores: jnp.ndarray,
                weights: jnp.ndarray | None,
                hist_pos: jnp.ndarray, hist_neg: jnp.ndarray
                ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Accumulate one block of scores into the two AUC histograms.

    hist_pos/hist_neg: int32[F16_BINS] carried across blocks (counts are
    exact — the adds are 0/1 ints, and int32 holds the reference-scale
    ~1.1e9 negative count). weights: [B] 0/1 padding mask, broadcast over
    each target's negatives (matching `evaluate`'s pooled weighting).
    """
    if weights is None:
        wi = jnp.ones(pos_scores.shape[0], jnp.int32)
    else:
        wi = (weights > 0).astype(jnp.int32)
    hist_pos = hist_pos.at[f16_bucket(pos_scores)].add(wi)
    N = neg_scores.shape[1]
    hist_neg = hist_neg.at[f16_bucket(neg_scores).reshape(-1)].add(
        jnp.repeat(wi, N))
    return hist_pos, hist_neg


def hist_auc(hist_pos: np.ndarray, hist_neg: np.ndarray) -> float:
    """Pooled tie-aware AUC from the two score histograms (host, f64).

    U = Σ_b pos[b] · (neg_below[b] + ½·neg[b]); AUC = U / (P·N). Exactly
    the average-tie rank-sum AUC of the bucketed scores (P·N reaches ~1e16
    at reference scale — f64 only on this final host-side reduction).
    """
    hp = np.asarray(hist_pos, np.float64)
    hn = np.asarray(hist_neg, np.float64)
    p_total, n_total = hp.sum(), hn.sum()
    if p_total == 0 or n_total == 0:
        return 0.5
    neg_below = np.concatenate([[0.0], np.cumsum(hn)[:-1]])
    u = float(np.sum(hp * (neg_below + 0.5 * hn)))
    return u / (p_total * n_total)
