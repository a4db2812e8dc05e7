"""Per-slot neighbor-set aggregation, including SCoRe's core novelty:
cross-neighbor co-attention (SURVEY.md §2.3 #8, §2.4 step 3; paper §3.3).

Three aggregation modes, matching the config ladder:
  slot_mean    masked mean of the slot's neighbor embeddings   (configs0/1)
  SlotAttention   per-side target-aware attention              (configs2)
  CrossCoAttention   the full bilinear relation matrix
      M^t = Eu_t Wr Ei_t^T with dual masked softmax            (configs3+)

All functions are pure jnp, compiled by XLA; `cross_coattn_ref` is the
reference the candidates-form block is tested against.

Padding semantics (SURVEY.md §7.3 item 6): an all-padded slot must yield an
exactly-zero aggregated vector and exactly-zero attention mass — implemented
with the where-trick around softmax, unit-tested against numpy.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp

_NEG = -1e9

# Lowering probe: when True, the tiny neighbor-axis contractions in the
# unrolled candidates path ("btnd,btd->btn" / "btn,btnd->btd" at n,m~10)
# lower as broadcast-multiply + f32-accumulated reduce instead of
# dot_general. An earlier A/B measured it slower than letting XLA lower the
# tiny dots itself (its explicit f32 intermediates are bigger), so it stays
# off; the equivalence test keeps the probe honest
# (tests/test_coattn.py::test_dot_free_candidates_path_matches_einsum).
DOT_FREE = False

# Reassociation probe: the sum-pool identity's user-side scores reassociate
# — (Eu_i Wr)·x == Eu_i·(Wr x) — so the [B,T,n,d] EuW intermediate never
# needs to exist:
#   EuW_sum = (Σ_n mu·Eu) @ Wr          (a [B,T,d] matmul, 1/n the FLOPs)
#   su_c    = Eu · (Ei_sum_c @ Wr^T + ei_c)   (target term FOLDED into the
#   si_c    = Ei_c · (EuW_sum + eu)            same single dot per side)
# Float-associativity differs from cross_coattn_ref (sum-of-products vs
# product-of-sums), so the gate is tolerance-equivalence
# (tests/test_coattn.py::test_wr_on_summary_matches_ref). An earlier A/B
# measured it slower: removing the EuW intermediate also removed the n-axis
# batched-dot fusion XLA builds around it. Stays off.
WR_ON_SUMMARY = False

# Shift-pushdown probe: True routes the i_shifts path through rolls
# confined to [B,T,d]-sized tensors (the big item-side tensor is never
# concatenated); False materializes the rolled item side at entry. An
# earlier A/B measured the pushdown slower (the traced-shift rolls lower to
# gathers and the per-candidate masked re-sum of [B,T,m,d] costs more than
# the concat it saves). Default stays False; the pushdown is kept as an
# equivalence-tested probe.
PUSH_ROLLS = False


def _vdot(x: jnp.ndarray, y: jnp.ndarray) -> jnp.ndarray:
    """einsum('...d,...d->...') as mul + f32-accumulated reduce.

    f32 accumulation matches dot_general's f32 accumulator so bf16 callers
    lose nothing vs the einsum lowering.
    """
    return jnp.sum(x * y, axis=-1, dtype=jnp.float32).astype(x.dtype)


def _wsum(a: jnp.ndarray, E: jnp.ndarray) -> jnp.ndarray:
    """einsum('...k,...kd->...d') as broadcast-mul + f32-accumulated reduce."""
    return jnp.sum(a[..., None] * E, axis=-2,
                   dtype=jnp.float32).astype(E.dtype)


def masked_softmax(scores: jnp.ndarray, mask: jnp.ndarray) -> jnp.ndarray:
    """Softmax over the last axis; rows with no valid entry give all-zeros.

    Internals run in f32 regardless of input dtype (bf16 exp/normalize loses
    attention mass precision); the result is cast back so mixed-precision
    callers keep a bf16 activation chain.
    """
    dt = scores.dtype
    scores = jnp.where(mask, scores.astype(jnp.float32), _NEG)
    scores = scores - jnp.max(scores, axis=-1, keepdims=True)
    e = jnp.exp(scores) * mask
    denom = jnp.sum(e, axis=-1, keepdims=True)
    return (e / jnp.maximum(denom, 1e-20)).astype(dt)


def slot_mean(E: jnp.ndarray, mask: jnp.ndarray) -> jnp.ndarray:
    """Masked mean over the neighbor axis. E: [..., n, d], mask: [..., n]."""
    m = mask[..., None].astype(E.dtype)
    s = jnp.sum(E * m, axis=-2)
    c = jnp.maximum(jnp.sum(m, axis=-2), 1.0)
    return s / c


@dataclasses.dataclass(frozen=True)
class SlotAttention:
    """Per-side target-aware attention over each slot's neighbor set
    (configs2: one-hop aggregation with no cross terms).

    scores = (E W) . target / sqrt(d);  c_t = softmax(scores)^T E

    Candidates form: the neighbor tensor E may be shared across a target's C
    candidates (user side: [B, 1, T, k, d]) or per-candidate (item side:
    [B, C, T, k, d]); the target/query is always [B, C, d]. Keeping the
    shared side un-tiled is the hot-path optimization — only
    O(B C T k)-sized score/weight tensors carry the candidate axis.
    """

    dim: int

    def init(self, key):
        # zero init => uniform attention at t=0, i.e. this rung starts as
        # exact masked-mean (configs1 behavior) and learns to deviate —
        # random init made richer rungs start worse than simpler ones
        return {"w": jnp.zeros((self.dim, self.dim), jnp.float32)}

    def __call__(self, p, E: jnp.ndarray, mask: jnp.ndarray,
                 target: jnp.ndarray) -> jnp.ndarray:
        # E: [B, Ce, T, k, d] (Ce in {1, C}), mask: [B, Ce, T, k],
        # target: [B, C, d] -> [B, C, T, d]
        d = E.shape[-1]
        W = p["w"].astype(E.dtype)  # f32 master param, compute-dtype acts
        # project the target, not the neighbors: (E W) . t == E . (W t), and
        # W t is O(B C d^2) vs O(B C T k d^2) (XLA does not reassociate
        # this on its own)
        tq = jnp.einsum("de,bce->bcd", W, target)
        scale = 1.0 / jnp.sqrt(jnp.asarray(d, E.dtype))
        C = target.shape[1]
        if E.shape[1] == 1:          # shared across candidates
            Es, ms = E[:, 0], mask[:, 0]
            if C <= 8:               # tiny-c einsums lower badly; unroll
                outs = []
                for c in range(C):
                    s_c = jnp.einsum("btkd,bd->btk", Es, tq[:, c]) * scale
                    a_c = masked_softmax(s_c, ms)
                    outs.append(jnp.einsum("btk,btkd->btd", a_c, Es))
                return jnp.stack(outs, 1)
            scores = jnp.einsum("btkd,bcd->bctk", Es, tq) * scale
            a = masked_softmax(scores, ms[:, None])
            return jnp.einsum("bctk,btkd->bctd", a, Es)
        if C <= 8:
            outs = []
            for c in range(C):
                s_c = jnp.einsum("btkd,bd->btk", E[:, c], tq[:, c]) * scale
                a_c = masked_softmax(s_c, mask[:, c])
                outs.append(jnp.einsum("btk,btkd->btd", a_c, E[:, c]))
            return jnp.stack(outs, 1)
        scores = jnp.einsum("bctkd,bcd->bctk", E, tq) * scale
        a = masked_softmax(scores, mask)
        return jnp.einsum("bctk,bctkd->bctd", a, E)


def cross_coattn_ref(Eu, Ei, mu, mi, Wr, eu, ei, *, pool: str = "sum",
                     target_aware: bool = True):
    """Pure-function cross-neighbor co-attention (paper §3.3; SURVEY.md §2.4
    step 3): the per-pair form every pool reduces to.

    Args:
      Eu: [B, T, n, d] user-side neighbor (item) embeddings
      Ei: [B, T, m, d] item-side neighbor (user) embeddings
      mu: [B, T, n] bool validity, mi: [B, T, m]
      Wr: [d, d] bilinear relation weight
      eu: [B, d] target user emb, ei: [B, d] target item emb
      pool: 'sum' | 'max' pooling of the relation matrix over the opposite side
      target_aware: add Eu.ei / Ei.eu pre-softmax terms

    Returns:
      cu: [B, T, d], ci: [B, T, d] per-slot aggregated vectors.
    """
    d = Eu.shape[-1]
    scale = 1.0 / jnp.sqrt(jnp.asarray(d, Eu.dtype))

    if pool in ("sum", "mean"):
        # Sum-pooling never needs the relation matrix: pooled user-side
        # scores are su_i = sum_j mask_j (Eu_i Wr) . Ei_j
        #             = (Eu_i Wr) . (sum_j mask_j Ei_j),
        # which collapses the O(B T n m d) batched tiny matmuls (too small
        # for a matrix unit at n,m ~ 10) to O(B T (n+m) d). Exact same math
        # as materializing M = Eu Wr Ei^T and masked-summing it; rows with
        # mu_i = 0 differ pre-softmax but are zeroed by the masked softmax
        # either way.
        # 'mean' divides by the opposite side's valid count — sum-pooled
        # scores otherwise scale with neighbor count, distorting the softmax
        # temperature across slots.
        EuW = jnp.einsum("btnd,de->btne", Eu, Wr)
        Ei_sum = jnp.sum(Ei * mi[..., None].astype(Ei.dtype), axis=-2)
        EuW_sum = jnp.sum(EuW * mu[..., None].astype(Eu.dtype), axis=-2)
        if pool == "mean":
            mi_cnt = jnp.maximum(
                jnp.sum(mi.astype(Ei.dtype), axis=-1, keepdims=True), 1.0)
            mu_cnt = jnp.maximum(
                jnp.sum(mu.astype(Eu.dtype), axis=-1, keepdims=True), 1.0)
            Ei_sum = Ei_sum / mi_cnt
            EuW_sum = EuW_sum / mu_cnt
        su = jnp.einsum("btnd,btd->btn", EuW, Ei_sum) * scale
        si = jnp.einsum("btmd,btd->btm", Ei, EuW_sum) * scale
    else:  # max
        # Relation matrix M[b,t,n,m] = Eu Wr Ei^T
        M = jnp.einsum("btnd,de,btme->btnm", Eu, Wr, Ei) * scale
        pair_mask = mu[..., :, None] & mi[..., None, :]
        Mm = jnp.where(pair_mask, M, _NEG)
        su = jnp.max(Mm, axis=-1)
        si = jnp.max(Mm, axis=-2)
        # rows with no valid opposite entry: fall back to 0 pre-softmax
        su = jnp.where(mi.any(axis=-1, keepdims=True), su, 0.0)
        si = jnp.where(mu.any(axis=-1, keepdims=True), si, 0.0)

    if target_aware:
        su = su + jnp.einsum("btnd,bd->btn", Eu, ei) * scale
        si = si + jnp.einsum("btmd,bd->btm", Ei, eu) * scale

    a = masked_softmax(su, mu)              # [B,T,n]
    b = masked_softmax(si, mi)              # [B,T,m]
    cu = jnp.einsum("btn,btnd->btd", a, Eu)
    ci = jnp.einsum("btm,btmd->btd", b, Ei)
    return cu, ci


@dataclasses.dataclass(frozen=True)
class CrossCoAttention:
    """Co-attention block owning the Wr bilinear param (plus the target
    projections when target_aware); candidates-form forward.

    Inputs: Eu [B,T,n,d] (user side, SHARED across candidates),
    Ei [B,C,T,m,d], mu [B,T,n], mi [B,C,T,m], eu [B,d], ei [B,C,d].
    Returns cu, ci: [B,C,T,d].

    For pool='sum' the relation matrix never materializes (identity in
    `cross_coattn_ref`) and no [B,C,T,n,*]-sized tensor is formed from the
    shared side — the user tower's big tensors stay candidate-free, which
    is what makes negatives/eval-candidates cheap. pool='max' needs the
    per-pair form and falls back to tiling through `cross_coattn_ref`.
    """

    dim: int
    pool: str = "sum"
    target_aware: bool = True
    force_pairflat: bool = False   # benchmark switch: tile + per-pair path

    def init(self, key):
        # zero init: relation scores start at 0 => dual masked-mean
        # aggregation (see SlotAttention note). The target-query
        # projections are ZERO-init like every other attention weight here:
        # configs3 then starts as exact dual masked-mean (configs1 behavior)
        # and learns the same target query configs2 learns PLUS the cross
        # relation — strictly subsuming per-side attention with a matched
        # optimization prior. Identity init (raw-dot
        # queries) was tried first and lost: starting with non-uniform
        # attention is the same trap round 1 hit with random init.
        names = ("wr", "wtu", "wti") if self.target_aware else ("wr",)
        # one array per leaf: a donated state must not alias buffers
        return {k: jnp.zeros((self.dim, self.dim), jnp.float32)
                for k in names}

    def __call__(self, p, Eu, Ei, mu, mi, eu, ei, i_shifts=None):
        # i_shifts (in-batch negatives, ScoreModel neg_shift contract):
        # when given, Ei arrives UN-rolled as [B, 1, T, m, d] and candidate
        # c >= 1 is the item side of example b + i_shifts[c-1] (batch roll).
        # Every per-candidate op here is pointwise in the batch axis, so the
        # PUSH_ROLLS probe pushes the rolls onto the [B,T,d]/[B,d]-sized
        # tensors (roll the user-side summaries FORWARD, compute in the
        # item-aligned frame against the single stored Ei, roll the [B,T,d]
        # result back) instead of materializing a [B, C, T, m, d]
        # concatenated copy of the biggest item-side tensor. mi still
        # arrives per-candidate ([B, C, T, m], rolled via i_cnt):
        # mi[:, c] == roll(mi[:, 0], -s_c).
        B, C = Ei.shape[0], ei.shape[1]
        T, n, d = Eu.shape[1], Eu.shape[2], Eu.shape[3]
        m = Ei.shape[3]
        Wr = p["wr"].astype(Eu.dtype)  # f32 master param, compute-dtype acts
        if self.target_aware:
            # project once per target: O(B C d^2), not O(B C T k d^2)
            ei = jnp.einsum("de,bce->bcd", p["wtu"].astype(Eu.dtype), ei)
            eu = jnp.einsum("de,be->bd", p["wti"].astype(Eu.dtype), eu)

        # The flat per-pair path tiles the shared user side to [B*C, ...]
        # (materializes C copies of the biggest tensors): required for
        # pool='max', and a benchmark switch otherwise. A profiled bf16
        # step spent a large share in the broadcast/reshape data formatting
        # this tiling causes, so C == 2 training uses the unrolled
        # candidate-axis path below like every other C.
        if i_shifts is not None and (self.pool not in ("sum", "mean")
                                     or self.force_pairflat or C > 8
                                     or not PUSH_ROLLS):
            # non-hot paths: materialize the rolled item side and fall
            # through to the generic code below (old behavior)
            Ei = jnp.concatenate(
                [Ei] + [jnp.roll(Ei, -s, axis=0) for s in i_shifts], axis=1)
            i_shifts = None

        if self.pool not in ("sum", "mean") or self.force_pairflat:
            # per-pair fallback: tile the shared side to [B*C, ...]
            Eu_f = jnp.broadcast_to(Eu[:, None], (B, C, T, n, d)).reshape(
                B * C, T, n, d)
            mu_f = jnp.broadcast_to(mu[:, None], (B, C, T, n)).reshape(
                B * C, T, n)
            eu_f = jnp.broadcast_to(eu[:, None], (B, C, d)).reshape(B * C, d)
            cu, ci = cross_coattn_ref(
                Eu_f, Ei.reshape(B * C, T, m, d), mu_f,
                mi.reshape(B * C, T, m), Wr, eu_f, ei.reshape(B * C, d),
                pool=self.pool, target_aware=self.target_aware)
            return (cu.reshape(B, C, T, d), ci.reshape(B, C, T, d))

        scale = 1.0 / jnp.sqrt(jnp.asarray(d, Eu.dtype))
        muf = mu[..., None].astype(Eu.dtype)
        if WR_ON_SUMMARY:
            # reassociated form (see the WR_ON_SUMMARY note): Wr applies to
            # the [B,T,d] masked sum, never to the [B,T,n,d] neighbor tensor
            Eu_msum = jnp.sum(Eu * muf, axis=2)                 # [B,T,d]
            if self.pool == "mean":
                Eu_msum = Eu_msum / jnp.maximum(jnp.sum(muf, axis=2), 1.0)
            EuW_sum = jnp.einsum("btd,de->bte", Eu_msum, Wr)    # [B,T,d]
            EuW = None
        else:
            EuW = jnp.einsum("btnd,de->btne", Eu, Wr)           # [B,T,n,d]
            EuW_sum = jnp.sum(EuW * muf, axis=2)                # [B,T,d]
            if self.pool == "mean":
                EuW_sum = EuW_sum / jnp.maximum(jnp.sum(muf, axis=2), 1.0)

        def user_scores(Ei_sum_c, ei_c):
            """[B,T,d] opposite summary (+ optional [B,d] target) -> su_c
            [B,T,n]. Reassociated form dots Eu once against
            Ei_sum_c @ Wr^T (+ target, folded)."""
            if WR_ON_SUMMARY:
                v = jnp.einsum("de,bte->btd", Wr, Ei_sum_c)
                if ei_c is not None:
                    v = v + ei_c[:, None, :]
                return jnp.einsum("btnd,btd->btn", Eu, v) * scale
            s = jnp.einsum("btnd,btd->btn", EuW, Ei_sum_c) * scale
            if ei_c is not None:
                s = s + jnp.einsum("btnd,bd->btn", Eu, ei_c) * scale
            return s

        def item_scores(Ei_c, summary, eu_c):
            """[B,T,m,d] item side x [B,T,d] user summary (+ optional [B,d]
            target) -> si_c [B,T,m]; the target term folds into the dot."""
            if WR_ON_SUMMARY and eu_c is not None:
                return jnp.einsum("btmd,btd->btm", Ei_c,
                                  summary + eu_c[:, None, :]) * scale
            s = jnp.einsum("btmd,btd->btm", Ei_c, summary) * scale
            if eu_c is not None:
                s = s + jnp.einsum("btmd,bd->btm", Ei_c, eu_c) * scale
            return s
        if i_shifts is None:
            mif = mi[..., None].astype(Ei.dtype)
            Ei_sum = jnp.sum(Ei * mif, axis=3)                  # [B,C,T,d]
            if self.pool == "mean":
                Ei_sum = Ei_sum / jnp.maximum(jnp.sum(mif, axis=3), 1.0)

        if i_shifts is not None:
            # shift-pushdown hot path (see the i_shifts note above): the
            # einsum structure per candidate is identical to the
            # i_shifts-is-None branch below — only the batch frame differs,
            # with rolls confined to [B,T,d]/[B,d]/[B,T,m] tensors. The mask
            # mi[:, c] mixes the ROLLED item count with the UN-rolled user
            # slot_valid (the candidate's history is always windowed by the
            # TARGET's t*), so the item-frame mask is mi[:, c] rolled
            # forward, not mi[:, 0].
            Ei0 = Ei[:, 0]
            cus, cis = [], []
            for c in range(C):
                s = None if c == 0 else i_shifts[c - 1]
                mi_item = (mi[:, c] if s is None
                           else jnp.roll(mi[:, c], s, axis=0))   # [B,T,m]
                mif_c = mi_item[..., None].astype(Ei.dtype)
                Ei_sum_item = jnp.sum(Ei0 * mif_c, axis=2)       # [B,T,d]
                if self.pool == "mean":
                    Ei_sum_item = Ei_sum_item / jnp.maximum(
                        jnp.sum(mif_c, axis=2), 1.0)
                # user-aligned frame: user-side scores against the rolled
                # item summary (roll back: index b reads item b+s's summary)
                Ei_sum_c = (Ei_sum_item if s is None
                            else jnp.roll(Ei_sum_item, -s, axis=0))
                su_c = user_scores(
                    Ei_sum_c, ei[:, c] if self.target_aware else None)
                a_c = masked_softmax(su_c, mu)
                cus.append(jnp.einsum("btn,btnd->btd", a_c, Eu))
                # item-aligned frame: roll the user summaries FORWARD so
                # index b' pairs Ei0[b'] with user b'-s, then roll the
                # [B,T,d] result back
                EuW_sum_c = (EuW_sum if s is None
                             else jnp.roll(EuW_sum, s, axis=0))
                eu_s = None
                if self.target_aware:
                    eu_s = eu if s is None else jnp.roll(eu, s, axis=0)
                si_c = item_scores(Ei0, EuW_sum_c, eu_s)
                b_c = masked_softmax(si_c, mi_item)
                ci_c = jnp.einsum("btm,btmd->btd", b_c, Ei0)
                cis.append(ci_c if s is None
                           else jnp.roll(ci_c, -s, axis=0))
            return jnp.stack(cus, 1), jnp.stack(cis, 1)

        if C <= 8:
            # Unroll the candidate axis: einsums carrying a tiny c dim lower
            # to [n,d]@[d,C] batched matmuls far too small for a matrix
            # unit. Per-candidate 'btnd,btd->btn' contractions are the fast
            # pre-candidates shapes.
            sus, sis, cus, cis = [], [], [], []
            if DOT_FREE and EuW is None:       # retired probe needs EuW
                EuW = jnp.einsum("btnd,de->btne", Eu, Wr)
            for c in range(C):
                if DOT_FREE:
                    su_c = _vdot(EuW, Ei_sum[:, c, :, None, :]) * scale
                    si_c = _vdot(Ei[:, c], EuW_sum[:, :, None, :]) * scale
                    if self.target_aware:
                        su_c += _vdot(Eu, ei[:, c, None, None, :]) * scale
                        si_c += _vdot(Ei[:, c], eu[:, None, None, :]) * scale
                    a_c = masked_softmax(su_c, mu)
                    b_c = masked_softmax(si_c, mi[:, c])
                    cus.append(_wsum(a_c, Eu))
                    cis.append(_wsum(b_c, Ei[:, c]))
                    continue
                su_c = user_scores(
                    Ei_sum[:, c], ei[:, c] if self.target_aware else None)
                si_c = item_scores(Ei[:, c], EuW_sum,
                                   eu if self.target_aware else None)
                a_c = masked_softmax(su_c, mu)
                b_c = masked_softmax(si_c, mi[:, c])
                cus.append(jnp.einsum("btn,btnd->btd", a_c, Eu))
                cis.append(jnp.einsum("btm,btmd->btd", b_c, Ei[:, c]))
            return jnp.stack(cus, 1), jnp.stack(cis, 1)

        if WR_ON_SUMMARY:
            v = jnp.einsum("de,bcte->bctd", Wr, Ei_sum)         # [B,C,T,d]
            if self.target_aware:
                v = v + ei[:, :, None, :]
            su = jnp.einsum("btnd,bctd->bctn", Eu, v) * scale
            w = EuW_sum
            if self.target_aware:
                w = w[:, None] + eu[:, None, None, :]
                si = jnp.einsum("bctmd,bctd->bctm", Ei, w) * scale
            else:
                si = jnp.einsum("bctmd,btd->bctm", Ei, w) * scale
        else:
            su = jnp.einsum("btnd,bctd->bctn", EuW, Ei_sum) * scale
            si = jnp.einsum("bctmd,btd->bctm", Ei, EuW_sum) * scale
            if self.target_aware:
                su = su + jnp.einsum("btnd,bcd->bctn", Eu, ei) * scale
                si = si + jnp.einsum("bctmd,bd->bctm", Ei, eu) * scale
        a = masked_softmax(su, mu[:, None])                     # [B,C,T,n]
        b = masked_softmax(si, mi)                              # [B,C,T,m]
        cu = jnp.einsum("bctn,btnd->bctd", a, Eu)
        ci = jnp.einsum("bctm,bctmd->bctd", b, Ei)
        return cu, ci
