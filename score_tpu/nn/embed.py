"""Embedding tables + lookup (SURVEY.md §2.3 #7).

The reference uses `tf.get_variable` + `tf.nn.embedding_lookup` on one GPU.
Here the tables are entries of the model's param dict whose lookup goes
through a pluggable `lookup_fn(table, ids) -> emb` so the same model runs
with:

  * local take (single device, configs0-3),
  * GSPMD row-sharded tables (jit + sharding constraint; XLA inserts the
    collectives),
  * the explicit shard_map psum / all-to-all exchange paths in
    `score_tpu.sharding` (configs4).

Row 0 of every table is the padding row; padding is handled by masks at the
use sites (attention / mean / GRU-step masking), never by zeroing the row.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import jax
import jax.numpy as jnp


def local_lookup(table: jnp.ndarray, ids: jnp.ndarray) -> jnp.ndarray:
    """Plain gather; under jit with a row-sharded table XLA partitions this."""
    return jnp.take(table, ids, axis=0)


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


LookupFn = Callable[[jnp.ndarray, jnp.ndarray], jnp.ndarray]


@dataclasses.dataclass(frozen=True)
class EmbeddingTables:
    """User/item tables; `shared=True` packs both into one table (configs0).

    Shared layout: index 0 = pad, 1..num_items = items, num_items+1.. = users.

    Lookups take an optional `diag` list: sharded lookups that also return
    an overflow counter (a2a_lookup with_overflow) append it there, so the
    caller can surface capacity overflow instead of silently reading
    aliased rows (SURVEY.md §7.3 item 1).
    """

    num_users: int
    num_items: int
    dim: int
    shared: bool = False
    param_dtype: str = "float32"
    lookup_fn: Optional[LookupFn] = None
    # Row counts are rounded up so row-sharding over any mesh 'rows' axis
    # that divides this multiple needs no repadding; the pad rows are never
    # addressed by valid ids.
    row_multiple: int = 64

    def init(self, key):
        init = jax.nn.initializers.normal(stddev=0.01)
        pdt = jnp.dtype(self.param_dtype)
        rows = lambda n: round_up(1 + n, self.row_multiple)
        if self.shared:
            return {"table": init(key, (rows(self.num_items + self.num_users),
                                        self.dim), pdt)}
        ku, ki = jax.random.split(key)
        return {"user_table": init(ku, (rows(self.num_users), self.dim), pdt),
                "item_table": init(ki, (rows(self.num_items), self.dim), pdt)}

    def _lookup(self, table, ids, diag: Optional[List]):
        with jax.named_scope("table_gather"):     # trace attribution
            out = (self.lookup_fn or local_lookup)(table, ids)
        if isinstance(out, tuple):
            emb, overflow = out
            if diag is not None:
                diag.append(overflow)
            return emb
        return out

    def user_emb(self, p, ids: jnp.ndarray, diag=None) -> jnp.ndarray:
        if self.shared:
            shifted = jnp.where(ids > 0, ids + self.num_items, 0)
            return self._lookup(p["table"], shifted, diag)
        return self._lookup(p["user_table"], ids, diag)

    def item_emb(self, p, ids: jnp.ndarray, diag=None) -> jnp.ndarray:
        if self.shared:
            return self._lookup(p["table"], ids, diag)
        return self._lookup(p["item_table"], ids, diag)
