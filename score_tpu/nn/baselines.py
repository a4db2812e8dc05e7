"""Baseline models sharing the ScoreModel batch protocol
(SURVEY.md §2.3 #14: the reference ships same-protocol comparison models —
"classical MF (SVD++-family), single-side sequential (GRU4Rec-, Caser-,
SASRec-, RRN-style), dual-side (DELF-style)"; exact roster unverifiable,
reference mount empty — this is the paper's §4.2 baselines table).

Same input batch dict and entry points as ScoreModel
(`model.CandidateModel`), so the whole train/eval driver works unchanged:

  MFModel          classic matrix factorization with biases (SVD-family)
  SVDPPModel       SVD++: MF + implicit-feedback factor from the user's
                   interacted items (the classical-MF roster entry)
  PopModel         popularity-only sanity floor (item bias alone)
  DELFModel        dual-embedding deep latent factor model: id embeddings +
                   history-based embeddings on BOTH sides, fused by pairwise
                   interaction MLPs (DELF-style dual-side, no recurrence)
  SelfAttnEncoder  single-block self-attention sequence encoder — plugs into
                   ScoreModel as seq encoder variant 'selfattn'
                   (SASRec-style, vs. the GRU default)
  CaserEncoder     causal horizontal-CNN sequence encoder — seq encoder
                   variant 'caser' (Caser-style; convolutions are left-padded
                   so slot t never sees t' > t)

The sequential roster entries are flag combos of ScoreModel itself (named
presets in score_tpu.config.PRESETS): gru4rec = single-side GRU over slot
means, rrn = dual-side GRUs, sasrec/caser = encoder swaps.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from ..config import ModelConfig
from .embed import EmbeddingTables
from .layers import (CausalConv, Dense, LayerNorm, MultiHeadAttention,
                     subkey)
from .model import CandidateModel


class _Scalar:
    """A learned scalar (zero-init), as a block."""

    def init(self, key):
        return jnp.zeros((), jnp.float32)


class _BaselineModel(CandidateModel):
    def __init__(self, cfg: ModelConfig, num_users: int, num_items: int,
                 lookup_fn=None):
        self.cfg = cfg
        self.num_users = num_users
        self.num_items = num_items
        self.lookup_fn = lookup_fn
        self.blocks = self._blocks(cfg, num_users, num_items)

    def _tables(self, num_users, num_items, dim, shared=False):
        return EmbeddingTables(num_users=num_users, num_items=num_items,
                               dim=dim, shared=shared,
                               lookup_fn=self.lookup_fn)


class MFModel(_BaselineModel):
    """score = <eu, ei> + b_u + b_i + b  (ignores histories)."""

    def _blocks(self, cfg, nu, ni):
        return {"tables": self._tables(nu, ni, cfg.embed_dim,
                                       cfg.shared_table),
                "user_bias": self._tables(nu, 0, 1),
                "item_bias": self._tables(0, ni, 1),
                "bias": _Scalar()}

    def _score(self, p, batch, diag, train, rng):
        b = self.blocks
        user, items = batch["user"], batch["cand"]          # [B], [B, C]
        eu = b["tables"].user_emb(p["tables"], user, diag)[:, None]
        ei = b["tables"].item_emb(p["tables"], items, diag)
        bu = b["user_bias"].user_emb(p["user_bias"], user, diag)[:, None, 0]
        bi = b["item_bias"].item_emb(p["item_bias"], items, diag)[..., 0]
        return jnp.sum(eu * ei, axis=-1) + bu + bi + p["bias"]


class PopModel(_BaselineModel):
    """Popularity floor: score = b_i. Any sequential model must beat it."""

    def _blocks(self, cfg, nu, ni):
        return {"item_bias": self._tables(0, ni, 1)}

    def _score(self, p, batch, diag, train, rng):
        return self.blocks["item_bias"].item_emb(
            p["item_bias"], batch["cand"], diag)[..., 0]


def _hist_mask(cnt: jnp.ndarray, fanout: int,
               slot_valid: jnp.ndarray) -> jnp.ndarray:
    """[..., T, k] bool validity for a padded history (j < cnt and t < t*)."""
    j = jnp.arange(fanout, dtype=cnt.dtype)
    j = j.reshape((1,) * cnt.ndim + (-1,))
    return (j < cnt[..., None]) & slot_valid[..., None]


def _masked_mean_flat(E: jnp.ndarray, mask: jnp.ndarray) -> jnp.ndarray:
    """Mean of E[..., T, k, d] over all valid (t, j); zero if none valid."""
    m = mask[..., None].astype(E.dtype)
    s = jnp.sum(E * m, axis=(-3, -2))
    c = jnp.sum(m, axis=(-3, -2))
    return s / jnp.maximum(c, 1.0)


class SVDPPModel(_BaselineModel):
    """SVD++ (the classical-MF roster entry beyond plain MF):

        ŷ = b + b_u + b_i + < e_u + |N(u)|^{-1/2} Σ_{j∈N(u)} y_j , e_i >

    N(u) is the user's full valid history (all slots t < t*, the same
    no-leakage contract as ScoreModel); y is a separate implicit item table.
    Candidates form: the implicit factor is computed once per user.
    """

    def _blocks(self, cfg, nu, ni):
        return {"tables": self._tables(nu, ni, cfg.embed_dim,
                                       cfg.shared_table),
                "implicit_tables": self._tables(0, ni, cfg.embed_dim),
                "user_bias": self._tables(nu, 0, 1),
                "item_bias": self._tables(0, ni, 1),
                "bias": _Scalar()}

    def _user_vec(self, p, batch, diag=None):
        """e_u + |N(u)|^-1/2 sum of implicit item embeddings: [B, d]."""
        b = self.blocks
        eu = b["tables"].user_emb(p["tables"], batch["user"], diag)  # [B, d]
        mask = _hist_mask(batch["u_cnt"], batch["u_hist"].shape[-1],
                          batch["slot_valid"])                    # [B, T, n]
        Y = b["implicit_tables"].item_emb(p["implicit_tables"],
                                          batch["u_hist"], diag)  # [B,T,n,d]
        m = mask[..., None].astype(Y.dtype)
        s = jnp.sum(Y * m, axis=(1, 2))                           # [B, d]
        cnt = jnp.sum(m, axis=(1, 2))                             # [B, 1]
        return eu + s * jax.lax.rsqrt(jnp.maximum(cnt, 1.0))

    def _score(self, p, batch, diag, train, rng):
        b = self.blocks
        pu = self._user_vec(p, batch, diag)                       # [B, d]
        ei = b["tables"].item_emb(p["tables"], batch["cand"], diag)
        bu = b["user_bias"].user_emb(p["user_bias"], batch["user"],
                                     diag)[..., 0]                # [B]
        bi = b["item_bias"].item_emb(p["item_bias"], batch["cand"],
                                     diag)[..., 0]                # [B, C]
        return (jnp.sum(pu[:, None] * ei, axis=-1) + bu[:, None] + bi
                + p["bias"])


class DELFModel(_BaselineModel):
    """DELF-style dual-embedding deep latent factor model (the dual-side,
    non-recurrent roster entry): each side carries an id embedding AND a
    history-based embedding (user: mean of interacted-item embeddings; item:
    mean of interacting-user embeddings), fused by four pairwise interaction
    MLPs over the cross pairs, then a linear head.

    Uses both sides' histories but no time structure — exactly the capability
    gap SCoRe's slot sequence + co-attention closes (ablation anchor).
    """

    _PAIRS = ("ee", "eq", "pe", "pq")

    def _blocks(self, cfg, nu, ni):
        d, h = cfg.embed_dim, cfg.hidden_dim
        b = {"tables": self._tables(nu, ni, d, cfg.shared_table),
             # second embedding set, used via histories (the "dual" in DELF)
             "hist_tables": self._tables(nu, ni, d)}
        for k in self._PAIRS:
            b[f"pair_{k}"] = Dense(2 * d, h)
        b["head"] = Dense(4 * h, 1)
        return b

    def _score(self, p, batch, diag, train, rng):
        b = self.blocks
        eu = b["tables"].user_emb(p["tables"], batch["user"], diag)  # [B, d]
        ei = b["tables"].item_emb(p["tables"], batch["cand"], diag)
        mu = _hist_mask(batch["u_cnt"], batch["u_hist"].shape[-1],
                        batch["slot_valid"])                      # [B, T, n]
        pu = _masked_mean_flat(b["hist_tables"].item_emb(
            p["hist_tables"], batch["u_hist"], diag), mu)         # [B, d]
        mi = _hist_mask(batch["i_cnt"], batch["i_hist"].shape[-1],
                        batch["slot_valid"][:, None])             # [B,C,T,m]
        qi = _masked_mean_flat(b["hist_tables"].user_emb(
            p["hist_tables"], batch["i_hist"], diag), mi)         # [B, C, d]

        eu_b = jnp.broadcast_to(eu[:, None], ei.shape)
        pu_b = jnp.broadcast_to(pu[:, None], ei.shape)
        pairs = [(eu_b, ei), (eu_b, qi), (pu_b, ei), (pu_b, qi)]
        feats = [jax.nn.relu(b[f"pair_{k}"](p[f"pair_{k}"],
                                            jnp.concatenate([x, y], -1)))
                 for k, (x, y) in zip(self._PAIRS, pairs)]
        return b["head"](p["head"], jnp.concatenate(feats, axis=-1))[..., 0]


@dataclasses.dataclass(frozen=True)
class CaserEncoder:
    """Caser-style causal CNN sequence encoder (seq encoder variant 'caser').

    Horizontal convolutions of several window sizes, made CAUSAL (left-padded)
    so the output at slot t is a function of slots <= t only — Caser's
    union-level pattern capture adapted to the sequence-to-sequence interface
    the driver's pooling expects. The vertical branch (Caser collapses time
    with a full-length vertical filter) becomes a causal running mean.

    xs: [B, T, d], mask: [B, T] -> [B, T, features]
    """

    in_dim: int
    features: int
    widths: tuple = (2, 3, 4)

    def _layers(self):
        d, f = self.in_dim, self.features
        conv = {f"hconv_{w}": CausalConv(d, f, w) for w in self.widths}
        return conv, Dense(d, f), Dense(f * (len(self.widths) + 1), f)

    def init(self, key):
        conv, vproj, out = self._layers()
        p = {name: c.init(subkey(key, name)) for name, c in conv.items()}
        p["vproj"] = vproj.init(subkey(key, "vproj"))
        p["out"] = out.init(subkey(key, "out"))
        return p

    def __call__(self, p, xs: jnp.ndarray, mask: jnp.ndarray) -> jnp.ndarray:
        conv, vproj, out = self._layers()
        mf = mask[..., None].astype(xs.dtype)
        xs = xs * mf
        outs = [jax.nn.relu(c(p[name], xs)) for name, c in conv.items()]
        # causal running mean over valid slots (vertical-filter analog)
        cnt = jnp.cumsum(mf, axis=1)
        vert = jnp.cumsum(xs, axis=1) / jnp.maximum(cnt, 1.0)
        outs.append(vproj(p["vproj"], vert))
        h = out(p["out"], jnp.concatenate(outs, axis=-1))
        return jax.nn.relu(h) * mf


@dataclasses.dataclass(frozen=True)
class SelfAttnEncoder:
    """One pre-LN self-attention block over the slot sequence (SASRec-style
    alternative to the GRU; causal over time slots, length-masked).

    xs: [B, T, d], mask: [B, T] -> [B, T, features]
    """

    in_dim: int
    features: int
    num_heads: int = 2

    def _layers(self):
        f = self.features
        return {"in_proj": Dense(self.in_dim, f), "ln1": LayerNorm(f),
                "mha": MultiHeadAttention(f, self.num_heads),
                "ln2": LayerNorm(f), "ff1": Dense(f, 2 * f),
                "ff2": Dense(2 * f, f)}

    def init(self, key):
        return {name: layer.init(subkey(key, name))
                for name, layer in self._layers().items()}

    def __call__(self, p, xs: jnp.ndarray, mask: jnp.ndarray) -> jnp.ndarray:
        L = self._layers()
        T = xs.shape[1]
        h = L["in_proj"](p["in_proj"], xs)
        # causal + validity attention mask [B, 1, T, T]
        causal = jnp.tril(jnp.ones((T, T), bool))
        attn_mask = (mask[:, None, None, :] & causal[None, None, :, :])
        y = L["ln1"](p["ln1"], h)
        h = h + L["mha"](p["mha"], y, attn_mask)
        y = L["ln2"](p["ln2"], h)
        y = jax.nn.relu(L["ff1"](p["ff1"], y))
        h = h + L["ff2"](p["ff2"], y)
        # zero out invalid slots so downstream pooling sees clean states
        return h * mask[..., None].astype(h.dtype)
