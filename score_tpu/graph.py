"""Device-resident graph store + on-device history gather.

The reference samples neighbors in CPU multiprocessing workers and feeds
padded arrays through feed_dict (SURVEY.md §3.2 hot loop (a)). Here the dense
padded adjacency lives in HBM as jnp arrays and the per-batch history gather
is a static-shape `take` *inside* the jitted step (gather-heavy neighbor
sampling and sequence batching run on the device) — the host only ships
(u, i, t*, y) tuples.

Slot-leakage contract (SURVEY.md §2.4 step 1): the returned slot-validity
mask is `t < t*`, so downstream masking guarantees a target never sees its
own or future slots.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax.numpy as jnp

from .data.schema import GraphStore


class DeviceGraph(NamedTuple):
    """Dense padded per-slot adjacency as device arrays (a jax pytree).

    NODE-MAJOR layout: a node's full history [T, k] is one contiguous HBM
    block, so the per-batch gather is a contiguous-row fetch (the on-disk
    GraphStore is slot-major [T, N+1, k]; device_graph transposes once at
    load)."""

    u2i: jnp.ndarray      # int32 [U+1, T, n]
    u2i_cnt: jnp.ndarray  # int32 [U+1, T]
    i2u: jnp.ndarray      # int32 [I+1, T, m]
    i2u_cnt: jnp.ndarray  # int32 [I+1, T]

    @property
    def num_slots(self) -> int:
        return self.u2i.shape[1]


def _pad_nodes(a, mult: int):
    """Pad the node axis (axis 0) to a multiple; pad rows are all-zero and
    never addressed by valid node ids (mesh-divisibility, like table rows)."""
    import numpy as np
    pad = (-a.shape[0]) % mult
    if pad == 0:
        return a
    width = [(0, 0)] * a.ndim
    width[0] = (0, pad)
    return np.pad(a, width)


def device_graph(g: GraphStore, node_multiple: int = 64) -> DeviceGraph:
    import numpy as np
    return DeviceGraph(
        u2i=jnp.asarray(_pad_nodes(np.ascontiguousarray(
            g.u2i.transpose(1, 0, 2)), node_multiple)),
        u2i_cnt=jnp.asarray(_pad_nodes(
            np.ascontiguousarray(g.u2i_cnt.T), node_multiple)),
        i2u=jnp.asarray(_pad_nodes(np.ascontiguousarray(
            g.i2u.transpose(1, 0, 2)), node_multiple)),
        i2u_cnt=jnp.asarray(_pad_nodes(
            np.ascontiguousarray(g.i2u_cnt.T), node_multiple)))


def gather_side(adj: jnp.ndarray, cnt: jnp.ndarray,
                nodes: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Full-history gather for one side (contiguous node-major rows).

    adj: [N+1, T, n], cnt: [N+1, T], nodes: [B] ->
      hist: [B, T, n] neighbor ids, hcnt: [B, T] true counts.
    """
    hist = jnp.take(adj, nodes, axis=0)
    hcnt = jnp.take(cnt, nodes, axis=0)
    return hist, hcnt


def slot_valid_mask(slots: jnp.ndarray, num_slots: int) -> jnp.ndarray:
    """[B, T] bool: slot t is usable history for a target at t* iff t < t*."""
    t = jnp.arange(num_slots, dtype=slots.dtype)[None, :]
    return t < slots[:, None]


def subsample_neighbors(hist: jnp.ndarray, cnt: jnp.ndarray, k: int,
                        rng) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Seeded uniform k-subset (without replacement) of each row's valid
    neighbors, on device (the reference's sampler re-draws
    per occurrence; prep pre-truncation fixes the sample for the whole run).

    Store a wider fan-out at prep (e.g. 2k) and re-draw a k-subset per step:
    top-k of iid uniform keys over the valid prefix is an exact uniform
    sample without replacement, in static shapes. hist: [..., S] ids,
    cnt: [...] valid counts; returns ([..., k], min(cnt, k)).
    """
    import jax
    S = hist.shape[-1]
    if S <= k:
        return hist, cnt
    j = jnp.arange(S, dtype=cnt.dtype)
    valid = j.reshape((1,) * cnt.ndim + (-1,)) < cnt[..., None]
    keys = jax.random.uniform(rng, hist.shape)
    keys = jnp.where(valid, keys, -1.0)        # invalid sort last
    _, idx = jax.lax.top_k(keys, k)
    return (jnp.take_along_axis(hist, idx, axis=-1),
            jnp.minimum(cnt, jnp.asarray(k, cnt.dtype)))


def gather_batch(g: DeviceGraph, users: jnp.ndarray, items: jnp.ndarray,
                 slots: jnp.ndarray) -> dict:
    """Assemble the model's history inputs for a batch of targets."""
    T = g.num_slots
    u_hist, u_cnt = gather_side(g.u2i, g.u2i_cnt, users)
    i_hist, i_cnt = gather_side(g.i2u, g.i2u_cnt, items)
    sv = slot_valid_mask(slots, T)
    return dict(user=users, item=items, slot=slots,
                u_hist=u_hist, u_cnt=u_cnt, i_hist=i_hist, i_cnt=i_cnt,
                slot_valid=sv)


def gather_candidate_batch(g: DeviceGraph, users: jnp.ndarray,
                           cand: jnp.ndarray, slots: jnp.ndarray) -> dict:
    """History inputs for one user vs C candidate items
    (ScoreModel.score_candidates). users/slots: [B]; cand: [B, C].
    The user-side gather runs once per user — not per candidate."""
    T = g.num_slots
    B, C = cand.shape
    u_hist, u_cnt = gather_side(g.u2i, g.u2i_cnt, users)
    i_hist, i_cnt = gather_side(g.i2u, g.i2u_cnt, cand.reshape(-1))
    sv = slot_valid_mask(slots, T)
    return dict(user=users, slot=slots, u_hist=u_hist, u_cnt=u_cnt,
                cand=cand,
                i_hist=i_hist.reshape(B, C, T, -1),
                i_cnt=i_cnt.reshape(B, C, T),
                slot_valid=sv)
