"""Interaction scorer + loss (SURVEY.md §2.3 #10-11; paper §3.5).

Score: z = MLP([h_u; h_i; eu; ei; h_u * h_i; eu * ei]) -> logit.
Loss: pointwise BCE over positives + sampled negatives, plus L2 on the
embedding tables (applied in the train step, where the table params are
visible).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import optax

from .layers import Dense, dropout, subkey


@dataclasses.dataclass(frozen=True)
class Scorer:
    """MLP interaction head over a list of feature vectors.

    Dropout (when rate > 0 and train=True) follows each hidden activation —
    the reference-era CTR regularization knob; needs an rng key in training.
    """

    in_dim: int
    mlp_dims: Sequence[int] = (64, 32)
    dropout: float = 0.0
    dtype: str = "float32"   # hidden-layer compute dtype; logits always f32

    def _layers(self):
        dims = (self.in_dim,) + tuple(self.mlp_dims)
        hidden = [(f"mlp_{i}", Dense(dims[i], w, dtype=self.dtype))
                  for i, w in enumerate(self.mlp_dims)]
        return hidden, Dense(dims[-1], 1, dtype="float32")

    def init(self, key):
        hidden, out = self._layers()
        p = {name: layer.init(subkey(key, name)) for name, layer in hidden}
        p["out"] = out.init(subkey(key, "out"))
        return p

    def __call__(self, p, feats: Sequence[jnp.ndarray], train: bool = False,
                 rng: Optional[jax.Array] = None) -> jnp.ndarray:
        cdt = jnp.dtype(self.dtype)
        x = jnp.concatenate([f.astype(cdt) for f in feats], axis=-1)
        hidden, out = self._layers()
        for i, (name, layer) in enumerate(hidden):
            x = jax.nn.relu(layer(p[name], x))
            x = dropout(x, self.dropout,
                        None if rng is None else jax.random.fold_in(rng, i),
                        train)
        return jnp.squeeze(out(p["out"], x), axis=-1)


def bce_loss(logits: jnp.ndarray, labels: jnp.ndarray,
             weights: jnp.ndarray | None = None) -> jnp.ndarray:
    """Mean sigmoid binary cross-entropy (the reference's pointwise loss).

    weights (optional, same shape as logits) drop degenerate elements from
    the mean — e.g. in-batch negatives that collide with their positive."""
    ell = optax.sigmoid_binary_cross_entropy(logits, labels)
    if weights is None:
        return jnp.mean(ell)
    return jnp.sum(ell * weights) / jnp.maximum(jnp.sum(weights), 1.0)
