"""The SCoRe model family, assembled from shared blocks (SURVEY.md §2.3 #8-10,
§2.4). One model covers the whole config ladder via ModelConfig flags:

  configs0  sides='user',  slot_agg='mean',   seq_pool='last', shared_table
  configs1  sides='dual',  slot_agg='mean',   seq_pool='attn'
  configs2  sides='dual',  slot_agg='attn',   seq_pool='attn'
  configs3+ sides='dual',  slot_agg='coattn', seq_pool='attn', target_aware

Forward semantics per SURVEY.md §2.4 steps 2-5.

Plain JAX: `init(rng)` builds the param dict; the entry points below are
pure functions of (params, batch), sharing all parameters:

  apply(params, batch)       flat (u, i) pairs — batch from
                             `score_tpu.graph.gather_batch`:
                             user[B], item[B], slot[B], u_hist[B,T,n],
                             u_cnt[B,T], i_hist[B,T,m], i_cnt[B,T],
                             slot_valid[B,T]

  score_candidates(params, batch)
                             one user vs C candidate items — the hot path
                             for sampled-negative training and ranked eval
                             (batch from `graph.gather_candidate_batch`):
                             user[B], slot[B], u_hist[B,T,n], u_cnt[B,T],
                             slot_valid[B,T], cand[B,C], i_hist[B,C,T,m],
                             i_cnt[B,C,T] -> logits [B,C].
                             The user side's big tensors (history gather,
                             neighbor embeddings, and — when the slot
                             aggregation is candidate-independent — the GRU
                             states) are computed ONCE per user, not per
                             candidate: embedding gathers and their
                             scatter-add grads dominate a train step, and
                             negatives/candidates would duplicate them.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from ..config import ModelConfig
from .coattn import CrossCoAttention, SlotAttention, slot_mean
from .embed import EmbeddingTables, LookupFn
from .encoder import GRU, AttnPool, last_pool
from .layers import subkey
from .scorer import Scorer


class CandidateModel:
    """Entry points shared by ScoreModel and the baselines.

    Subclasses set `self.blocks` (name -> block with `init(key)`) and
    implement `_score(params, batch, diag, train, rng) -> [B, C] logits`,
    appending any lookup overflow counters to `diag`.
    """

    blocks: dict

    def init(self, rng: jax.Array) -> dict:
        """The param dict: one entry per named block."""
        return {name: blk.init(subkey(rng, name))
                for name, blk in self.blocks.items()}

    def score_candidates_aux(self, params, batch: dict, train: bool = False,
                             rng: Optional[jax.Array] = None):
        """(logits [B, C], a2a_overflow int32): the overflow counter sums
        what the sharded lookups reported (0 for local lookups)."""
        diag = []
        logits = self._score(params, batch, diag, train, rng)
        return logits, sum(diag, jnp.zeros((), jnp.int32))

    def score_candidates(self, params, batch: dict, train: bool = False,
                         rng: Optional[jax.Array] = None) -> jnp.ndarray:
        return self.score_candidates_aux(params, batch, train, rng)[0]

    def apply(self, params, batch: dict, train: bool = False,
              rng: Optional[jax.Array] = None) -> jnp.ndarray:
        """Flat (u, i) pairs: the candidates form with C == 1 -> [B]."""
        cb = dict(batch, cand=batch["item"][:, None])
        for k in ("i_hist", "i_cnt"):
            if k in batch:
                cb[k] = batch[k][:, None]
        return self.score_candidates(params, cb, train, rng)[:, 0]


def _nbr_mask(cnt: jnp.ndarray, fanout: int,
              slot_valid: jnp.ndarray) -> jnp.ndarray:
    """[..., T, k] bool: neighbor j of slot t valid iff j < cnt and t < t*."""
    j = jnp.arange(fanout, dtype=cnt.dtype)
    j = j.reshape((1,) * cnt.ndim + (-1,))
    return (j < cnt[..., None]) & slot_valid[..., None]


class ScoreModel(CandidateModel):
    """Dual-side neighbor-based sequential scorer (the SCoRe family)."""

    def __init__(self, cfg: ModelConfig, num_users: int, num_items: int,
                 lookup_fn: Optional[LookupFn] = None):
        self.cfg = cfg
        self.num_users = num_users
        self.num_items = num_items
        self.lookup_fn = lookup_fn
        d, f = cfg.embed_dim, cfg.hidden_dim
        dual = cfg.sides == "dual"
        b = {"tables": EmbeddingTables(
            num_users=num_users, num_items=num_items, dim=d,
            shared=cfg.shared_table, param_dtype=cfg.param_dtype,
            lookup_fn=lookup_fn)}
        if cfg.slot_agg == "coattn":
            b["coattn"] = CrossCoAttention(
                dim=d, pool=cfg.coattn_pool, target_aware=cfg.target_aware)
        elif cfg.slot_agg == "attn":
            b["slot_attn_u"] = SlotAttention(dim=d)
            if dual:
                b["slot_attn_i"] = SlotAttention(dim=d)

        def encoder():
            if cfg.seq_encoder == "selfattn":
                from .baselines import SelfAttnEncoder
                return SelfAttnEncoder(in_dim=d, features=f)
            if cfg.seq_encoder == "caser":
                from .baselines import CaserEncoder
                return CaserEncoder(in_dim=d, features=f)
            return GRU(in_dim=d, features=f)

        b["gru_u"] = encoder()
        if dual:
            b["gru_i"] = encoder()
        if cfg.seq_pool == "attn":
            b["pool_u"] = AttnPool(features=f, query_dim=d)
            if dual:
                b["pool_i"] = AttnPool(features=f, query_dim=d)
        # scorer features: [h_u, h_i, eu, ei, h_u*h_i, eu*ei] (dual) or
        # [h_u, eu, ei, eu*ei] (user side only)
        b["scorer"] = Scorer(in_dim=3 * f + 3 * d if dual else f + 3 * d,
                             mlp_dims=tuple(cfg.mlp_dims),
                             dropout=cfg.dropout, dtype=cfg.compute_dtype)
        self.blocks = b

    # --- the hot path: one user vs C candidates ---

    def _score(self, params, batch: dict, diag, train: bool,
               rng: Optional[jax.Array]) -> jnp.ndarray:
        cfg = self.cfg
        cdt = jnp.dtype(cfg.compute_dtype)
        dual = cfg.sides == "dual"
        blk = self.blocks
        tables, tp = blk["tables"], params["tables"]

        sv = batch["slot_valid"]                                 # [B, T]
        shifts = batch.get("neg_shift")
        if shifts is not None and self.lookup_fn is not None:
            # Sharded-lookup path (configs4): roll the item-side IDS before
            # the embedding exchange instead of the embedded tensors. Under
            # a batch sharded over the mesh, rolling [B,1,T,m,d] f32
            # activations lowers to an all-gather of the full embedded
            # tensor per step plus its transpose in the backward — the
            # dominant collective of the compiled configs4 step. Rolling the
            # int32 ids moves 1/d-th the bytes, has no backward, and the
            # duplicate ids the roll creates collapse in the a2a dedup, so
            # the lookup exchange grows only by the (tiny) per-device
            # unique-count delta. embedding(roll(ids)) == roll(embedding)
            # exactly, so this reuses the generic C>1 path below
            # (equivalence-tested vs the single-device roll path in
            # tests/test_sharding.py).
            assert batch["cand"].shape[1] == 1, (
                f"neg_shift requires C==1 candidates, got "
                f"C={batch['cand'].shape[1]}")
            rolls_ids = lambda x: jnp.concatenate(
                [x] + [jnp.roll(x, -s, axis=0) for s in shifts], axis=1)
            batch = dict(batch,
                         cand=rolls_ids(batch["cand"]),
                         i_hist=rolls_ids(batch["i_hist"]),
                         i_cnt=rolls_ids(batch["i_cnt"]))
            shifts = None

        eu = tables.user_emb(tp, batch["user"], diag).astype(cdt)   # [B,d]
        ei = tables.item_emb(tp, batch["cand"], diag).astype(cdt)   # [B,C,d]
        i_cnt = batch["i_cnt"]
        if shifts is not None:
            # contract: rolls only make sense against a single positive per
            # example — a C>1 candidate axis would interleave candidates and
            # rolled negatives in scrambled order
            assert ei.shape[1] == 1, (
                f"neg_shift requires C==1 candidates, got C={ei.shape[1]}")
            # In-batch negatives (DataConfig.train_neg_mode='inbatch'):
            # candidate c>0 of example b is example (b+shift_c)'s positive
            # item. The item side arrives as C=1 tensors, is embedded once
            # per example, and the per-negative copies are batch-axis rolls
            # of the *embedded* tensors — negatives add zero embedding-row
            # gathers and zero grad scatter-adds (the dominant step cost in
            # the profiles this repo has taken). Grads flow back through the
            # inverse roll, so each positive's history also trains from its
            # appearances as other examples' negative.
            rolls = lambda x: jnp.concatenate(
                [x] + [jnp.roll(x, -s, axis=0) for s in shifts], axis=1)
            ei = rolls(ei)
            i_cnt = rolls(i_cnt)
        B, C = ei.shape[0], ei.shape[1]
        T = sv.shape[1]

        # user side: shared across candidates
        Eu = tables.item_emb(tp, batch["u_hist"], diag).astype(cdt)  # B,T,n,d
        mu = _nbr_mask(batch["u_cnt"], Eu.shape[2], sv)          # [B,T,n]

        if dual:
            Ei = tables.user_emb(tp, batch["i_hist"], diag).astype(cdt)
            if shifts is not None and cfg.slot_agg != "coattn":
                # coattn takes the un-rolled [B,1,T,m,d] tensor plus the
                # shifts; by default (coattn.PUSH_ROLLS=False) it
                # materializes the same rolled concat internally — the
                # shift-pushdown alternative (rolls confined to [B,T,d]
                # summaries) measured slower and is kept only as an
                # equivalence-tested probe. The other
                # aggregations keep the materialized form here.
                Ei = rolls(Ei)
            mi = _nbr_mask(i_cnt, Ei.shape[3],
                           sv[:, None])                          # [B,C,T,m]
            eu_c = jnp.broadcast_to(eu[:, None], (B, C, eu.shape[-1]))

        # --- per-slot aggregation (SURVEY.md §2.4 step 3) ---
        cu_shared = None        # [B,T,d] when candidate-independent
        if cfg.slot_agg == "coattn":
            assert dual, "co-attention requires both sides"
            with jax.named_scope("coattn"):       # trace attribution
                cu, ci = blk["coattn"](params["coattn"], Eu, Ei, mu, mi, eu,
                                       ei, i_shifts=shifts)  # [B,C,T,d]
        elif cfg.slot_agg == "attn":
            cu = blk["slot_attn_u"](params["slot_attn_u"], Eu[:, None],
                                    mu[:, None], ei)  # [B,C,T,d]
            if dual:
                ci = blk["slot_attn_i"](params["slot_attn_i"], Ei, mi, eu_c)
        else:  # mean — candidate-independent on the user side
            cu_shared = slot_mean(Eu, mu)                        # [B,T,d]
            if dual:
                ci = slot_mean(Ei, mi)                           # [B,C,T,d]

        # --- sequence encoding (step 4) ---
        if cu_shared is not None:
            hu_seq = blk["gru_u"](params["gru_u"], cu_shared,
                                  sv)[:, None]                   # [B,1,T,f]
        else:
            hu_seq = blk["gru_u"](
                params["gru_u"], cu.reshape(B * C, T, -1),
                jnp.broadcast_to(sv[:, None], (B, C, T)).reshape(B * C, T)
            ).reshape(B, C, T, -1)
        if cfg.seq_pool == "attn":
            h_u = blk["pool_u"](params["pool_u"], hu_seq, ei, sv)   # [B,C,f]
        else:
            hl = last_pool(hu_seq.reshape(-1, T, hu_seq.shape[-1]),
                           jnp.broadcast_to(
                               sv[:, None], (B, hu_seq.shape[1], T)
                           ).reshape(-1, T))
            h_u = hl.reshape(B, hu_seq.shape[1], -1)
            if h_u.shape[1] == 1:
                h_u = jnp.broadcast_to(h_u, (B, C, h_u.shape[-1]))

        eu_b = jnp.broadcast_to(eu[:, None], ei.shape)
        feats = [h_u, eu_b, ei, eu_b * ei]
        if dual:
            hi_seq = blk["gru_i"](
                params["gru_i"], ci.reshape(B * C, T, -1),
                jnp.broadcast_to(sv[:, None], (B, C, T)).reshape(B * C, T)
            ).reshape(B, C, T, -1)
            if cfg.seq_pool == "attn":
                h_i = blk["pool_i"](params["pool_i"], hi_seq, eu_c, sv)
            else:
                h_i = last_pool(
                    hi_seq.reshape(B * C, T, -1),
                    jnp.broadcast_to(sv[:, None], (B, C, T)).reshape(B * C, T)
                ).reshape(B, C, -1)
            feats = [h_u, h_i, eu_b, ei, h_u * h_i, eu_b * ei]

        # --- interaction scorer (step 5) ---
        return blk["scorer"](params["scorer"], feats, train=train,
                             rng=rng)                            # [B, C]
