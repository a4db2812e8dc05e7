"""Sequence encoders: GRU over time slots + pooling (SURVEY.md §2.3 #9).

The reference uses `tf.nn.rnn_cell.GRUCell` + `dynamic_rnn` (cuDNN path).
Here the GRU is a hand-rolled cell under `jax.lax.scan` — XLA fuses the
per-step elementwise ops around the two gate matmuls; at T ~ 10-50 the
serial scan is short (SURVEY.md §7.3 item 3) and the batch axis carries
the parallelism.

Cell convention (the "cudnn/linear-before-reset" variant, documented so the
numpy test reference is unambiguous):
    z = sigmoid(x Wxz + h Whz + bz)
    r = sigmoid(x Wxr + h Whr + br)
    c = tanh(x Wxc + r * (h Whc) + bc)
    h' = (1 - z) * h + z * c
Masked steps (padded slots) carry h through unchanged.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from .coattn import masked_softmax
from .layers import lecun_normal, subkey

# Probe knob (scripts/perf_sweep.py *_unroll variants): lax.scan unroll
# factor for the GRU recurrence. Semantics identical for any value. An
# earlier A/B measured full unroll at T=9 slower than 1 (the unrolled body
# defeated XLA's cross-step loop fusion). Default stays 1.
SCAN_UNROLL = 1


@dataclasses.dataclass(frozen=True)
class GRU:
    """Unidirectional GRU over axis 1. xs: [B,T,d], mask: [B,T] -> [B,T,f]."""

    in_dim: int
    features: int

    def init(self, key):
        d, f = self.in_dim, self.features
        return {"wx": lecun_normal(subkey(key, "wx"), (d, 3 * f)),
                "wh": lecun_normal(subkey(key, "wh"), (f, 3 * f)),
                "b": jnp.zeros((3 * f,), jnp.float32)}

    def __call__(self, p, xs: jnp.ndarray, mask: jnp.ndarray) -> jnp.ndarray:
        B, T, d = xs.shape
        f = self.features
        Wx = p["wx"].astype(xs.dtype)
        Wh = p["wh"].astype(xs.dtype)
        b = p["b"].astype(xs.dtype)

        # Hoist the input projection out of the scan: one big [B*T, d]x[d, 3f]
        # matmul instead of T small ones.
        gx_all = (xs.reshape(B * T, d) @ Wx + b).reshape(B, T, 3 * f)

        def step(h, inp):
            gx, m = inp                       # gx: [B, 3f], m: [B]
            gh = h @ Wh
            xz, xr, xc = jnp.split(gx, 3, axis=-1)
            hz, hr, hc = jnp.split(gh, 3, axis=-1)
            z = jax.nn.sigmoid(xz + hz)
            r = jax.nn.sigmoid(xr + hr)
            c = jnp.tanh(xc + r * hc)
            h_new = (1.0 - z) * h + z * c
            h_new = jnp.where(m[:, None], h_new, h)
            return h_new, h_new

        h0 = jnp.zeros((B, f), xs.dtype)
        _, hs = jax.lax.scan(step, h0,
                             (gx_all.transpose(1, 0, 2), mask.T),
                             unroll=SCAN_UNROLL)
        return hs.transpose(1, 0, 2)


@dataclasses.dataclass(frozen=True)
class AttnPool:
    """Attention pooling of GRU states with the opposite target embedding as
    query (paper §3.4).

    scores_t = (h_t W) . q / sqrt(dq);  out = sum_t softmax(scores)_t h_t
    All-masked rows pool to exact zero.

    Candidates form: hs may be shared across a target's C candidates
    ([B, 1, T, f]) or per-candidate ([B, C, T, f]); query is [B, C, dq].
    """

    features: int
    query_dim: int

    def init(self, key):
        # zero init: pooling starts uniform over valid slots (see the
        # SlotAttention zero-init note in coattn.py)
        return {"w": jnp.zeros((self.features, self.query_dim), jnp.float32)}

    def __call__(self, p, hs: jnp.ndarray, query: jnp.ndarray,
                 mask: jnp.ndarray) -> jnp.ndarray:
        # hs: [B,Ch,T,f], query: [B,C,dq], mask: [B,T] -> [B,C,f]
        dq = query.shape[-1]
        W = p["w"].astype(hs.dtype)  # f32 master param, compute-dtype acts
        # contract the query through W first: O(B C f dq) then O(B C T f),
        # not O(B C T f dq) (same reassociation fix as SlotAttention)
        q = jnp.einsum("fq,bcq->bcf", W, query)
        scale = 1.0 / jnp.sqrt(jnp.asarray(dq, hs.dtype))
        C = query.shape[1]
        if C <= 8:                   # tiny-c einsums lower badly; unroll
            outs = []
            for c in range(C):
                h_c = hs[:, 0] if hs.shape[1] == 1 else hs[:, c]
                s_c = jnp.einsum("btf,bf->bt", h_c, q[:, c]) * scale
                a_c = masked_softmax(s_c, mask)
                outs.append(jnp.einsum("bt,btf->bf", a_c, h_c))
            return jnp.stack(outs, 1)
        if hs.shape[1] == 1:         # shared states, per-candidate query
            scores = jnp.einsum("btf,bcf->bct", hs[:, 0], q) * scale
            a = masked_softmax(scores, mask[:, None])
            return jnp.einsum("bct,btf->bcf", a, hs[:, 0])
        scores = jnp.einsum("bctf,bcf->bct", hs, q) * scale
        a = masked_softmax(scores, mask[:, None])
        return jnp.einsum("bct,bctf->bcf", a, hs)


def last_pool(hs: jnp.ndarray, mask: jnp.ndarray) -> jnp.ndarray:
    """Last valid state (configs0 degenerate pooling); zero if none valid."""
    B, T, _ = hs.shape
    idx = jnp.maximum(jnp.sum(mask.astype(jnp.int32), axis=1) - 1, 0)
    out = hs[jnp.arange(B), idx]
    return out * mask.any(axis=1, keepdims=True).astype(hs.dtype)
