"""Mesh + partition-spec layout (SURVEY.md §2.2, §5 'distributed backend').

The reference has no distributed anything (single-GPU TF1). This build's
central distributed component is row-sharded embedding tables served by
collective lookups:

  mesh axes: ('data', 'rows') — 'data' spans the batch, 'rows' spans
  embedding-table rows (the recsys model-parallel axis; PP/SP/EP are
  deliberately out of scope, SURVEY.md §2.2).

Two lookup paths:
  * GSPMD (default): tables annotated P('rows', None); XLA partitions the
    gather and inserts collectives itself. Used by shard_state/shard_graph.
  * explicit shard_map paths in this module — `psum_lookup` (masked partial
    gather + psum, exact and simple) and `a2a_lookup` (the north star's
    all-to-all request/response exchange) — equivalence-tested on the fake
    8-device CPU mesh (SURVEY.md §4.2).
"""

from __future__ import annotations

import re
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"
ROWS_AXIS = "rows"


def bringup(shard_cfg=None, coordinator_address: str | None = None,
            num_processes: int | None = None,
            process_id: int | None = None):
    """Distributed bring-up (SURVEY.md §3.5 init() stack).

    Multi-host: call once per host process before any jax op;
    `jax.distributed.initialize` wires the hosts (args optional when the
    cluster env provides them). Single-host: a no-op. Returns
    (mesh, lookup_fn) per the ShardingConfig.

    Transport below the collectives is XLA's (NCCL over NVLink within a
    host, the network across hosts) —
    nothing user-level to configure (SURVEY.md §2.2 'Communication
    backend').
    """
    if num_processes is not None and num_processes > 1:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes, process_id=process_id)
    devices = jax.devices()
    if shard_cfg is None or shard_cfg.num_data * shard_cfg.num_rows <= 1:
        mesh = make_mesh(devices[:1], data=1, rows=1)
        return mesh, None
    n = shard_cfg.num_data * shard_cfg.num_rows
    mesh = make_mesh(devices[:n], data=shard_cfg.num_data,
                     rows=shard_cfg.num_rows)
    return mesh, make_lookup_fn(mesh, shard_cfg.lookup_mode,
                                capacity=getattr(shard_cfg, "a2a_capacity", 0))


def factor_mesh(n: int) -> tuple[int, int]:
    """Factor n devices into (data, rows): rows gets the larger power so
    table capacity scales with the slice; data >= 2 when possible so
    data-parallel grads are exercised."""
    if n == 1:
        return (1, 1)
    data = 2
    while n % data != 0:
        data += 1
    return (data, n // data)


def make_mesh(devices: Sequence[jax.Device] | None = None,
              data: int | None = None, rows: int | None = None) -> Mesh:
    devices = list(devices if devices is not None else jax.devices())
    if data is None or rows is None:
        data, rows = factor_mesh(len(devices))
    assert data * rows == len(devices), (data, rows, len(devices))
    arr = np.array(devices).reshape(data, rows)
    return Mesh(arr, (DATA_AXIS, ROWS_AXIS))


# --- SpecLayout: rule-based path -> PartitionSpec (SNIPPETS.md pattern) ---

_TABLE_RE = re.compile(r"table")


def state_spec(path_str: str, leaf) -> P:
    """Partition rule for TrainState leaves (params AND optimizer moments —
    adam mu/nu mirror the param tree, so the same path rule row-shards
    them)."""
    if _TABLE_RE.search(path_str) and getattr(leaf, "ndim", 0) == 2:
        return P(ROWS_AXIS, None)
    return P()


def _path_str(path) -> str:
    return jax.tree_util.keystr(path)


def shard_tree(mesh: Mesh, tree, spec_fn=state_spec):
    """device_put every leaf with its rule's NamedSharding."""
    def put(path, leaf):
        spec = spec_fn(_path_str(path), leaf)
        return jax.device_put(leaf, NamedSharding(mesh, spec))
    return jax.tree_util.tree_map_with_path(put, tree)


def shard_state(mesh: Mesh, state):
    """Shard a TrainState: tables (and their adam moments) over 'rows',
    dense params replicated."""
    return shard_tree(mesh, state)


def graph_spec(path_str: str, leaf) -> P:
    """Adjacency arrays [N+1, T, k] / counts [N+1, T] (node-major): shard the
    node axis over 'rows' so the graph store scales with the slice like the
    tables."""
    if getattr(leaf, "ndim", 0) == 3:
        return P(ROWS_AXIS, None, None)
    if getattr(leaf, "ndim", 0) == 2:
        return P(ROWS_AXIS, None)
    return P()


def shard_graph(mesh: Mesh, graph):
    return shard_tree(mesh, graph, graph_spec)


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Batch axis sharded over ALL devices (both mesh axes): dense-tower
    compute is data-parallel everywhere; 'rows' is a storage axis for the
    tables, not a compute axis. This is what lets a2a_lookup return
    data-sharded responses with no replicating all_gather."""
    return NamedSharding(mesh, P((DATA_AXIS, ROWS_AXIS)))


def stacked_batch_sharding(mesh: Mesh) -> NamedSharding:
    """[K, B] stacked multi-step batches: steps replicated, batch sharded."""
    return NamedSharding(mesh, P(None, (DATA_AXIS, ROWS_AXIS)))


# --- explicit shard_map lookup paths (M5; equivalence-gated vs local take) ---


def psum_lookup(mesh: Mesh, table: jnp.ndarray,
                ids: jnp.ndarray) -> jnp.ndarray:
    """Row-sharded lookup as masked partial gather + psum over 'rows'.

    Each rows-shard holds a contiguous row block; it gathers what it owns
    (out-of-range ids clamp to row 0 and are masked to zero) and a psum
    assembles full embeddings. The autodiff transpose is a masked
    scatter-add into the local shard — table grads stay row-sharded.

    table: [V, d] global (sharded P('rows', None));
    ids:   [...] global (sharded P('data') on axis 0).
    """
    V = table.shape[0]
    n_rows = mesh.shape[ROWS_AXIS]
    per = -(-V // n_rows)  # rows per shard (last shard may be ragged)

    def body(tbl, ids_):
        r = jax.lax.axis_index(ROWS_AXIS)
        lo = r * per
        local = ids_ - lo
        ok = (local >= 0) & (local < tbl.shape[0])
        emb = jnp.take(tbl, jnp.where(ok, local, 0), axis=0)
        emb = emb * ok[..., None].astype(emb.dtype)
        return jax.lax.psum(emb, ROWS_AXIS)

    return jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(ROWS_AXIS, None), P(DATA_AXIS)),
        out_specs=P(DATA_AXIS))(table, ids)


def a2a_lookup(mesh: Mesh, table: jnp.ndarray, ids: jnp.ndarray,
               capacity: int = 0, with_overflow: bool = False):
    """The north-star lookup: all-to-all request/response
    exchange over the 'rows' axis — v2.

    The batch (ids axis 0) is sharded over BOTH mesh axes; each device:
      1. DEDUPS its local ids (sort + unique-rank) — duplicate-heavy id
         streams (B·T·n lookups, zipf items) exchange each id once, and the
         autodiff transpose pre-reduces duplicate grad rows BEFORE the
         return exchange, shrinking the owner-side scatter-add to unique
         rows;
      2. buckets the unique ids by owner shard into [n_rows, cap] buffers
         (bucket offsets via searchsorted on the owner-sorted array — no
         O(cap·n_rows) one_hot/cumsum);
      3. all_to_all routes requests to owners, owners gather from their
         local table block, a second all_to_all returns embeddings;
      4. un-buckets + un-dedups; the output stays sharded over both axes —
         NO replicating all_gather (responses are data-sharded).

    `capacity` (static) caps the per-device unique-id buffer; 0 means the
    exact per-call worst case (= local id count = ceil(call ids / mesh
    size), i.e. derived from the call's B·T·(n+m) volume — can never
    overflow). A smaller capacity shrinks every exchange buffer
    proportionally (SURVEY.md §7.3 item 1 static-capacity buckets); ids
    beyond it alias the last unique slot, so the result is wrong whenever
    capacity < n_unique. `with_overflow=True` returns
    (emb, total_overflowed_uniques) — the SURVEY's overflow counter,
    psum'd over the whole mesh; 0 iff the result is exact. The train loop
    surfaces it as the `a2a_overflow` metric (EmbeddingTables appends it
    to the caller's `diag` list, an auxiliary output of the forward). The embedding computation is identical either way.

    Overlap note (SURVEY.md §5): the model issues all four lookup exchanges
    (targets + both histories) before any consumer compute, so XLA's
    latency-hiding scheduler is free to overlap the collectives with the
    co-attention compute of previously-arrived operands — overlap is
    expressed by dataflow independence, not manual double-buffering.
    """
    V, d = table.shape
    n_rows = mesh.shape[ROWS_AXIS]
    n_all = n_rows * mesh.shape[DATA_AXIS]
    assert V % n_rows == 0, (
        f"pad the table: {V} rows not divisible by rows axis {n_rows}")
    per = V // n_rows

    # Pad the batch axis so it splits over all devices (sliced off at the
    # end); pad ids are 0 and cost one extra row-0 lookup each.
    n0 = ids.shape[0]
    n0_pad = -(-n0 // n_all) * n_all
    ids_p = jnp.pad(ids, [(0, n0_pad - n0)] + [(0, 0)] * (ids.ndim - 1))

    def body(tbl, ids_):
        flat = ids_.reshape(-1)                          # local ids [L]
        L = flat.shape[0]
        cap = min(capacity, L) if capacity else L
        r = jax.lax.axis_index(ROWS_AXIS)
        # 1. dedup: unique rank per position
        order = jnp.argsort(flat)
        sorted_ids = flat[order]
        newseg = jnp.concatenate(
            [jnp.ones((1,), bool), sorted_ids[1:] != sorted_ids[:-1]])
        urank_sorted = jnp.cumsum(newseg) - 1            # [L]
        urank = jnp.zeros((L,), urank_sorted.dtype).at[order].set(
            jnp.minimum(urank_sorted, cap - 1))
        n_uniq = urank_sorted[-1] + 1
        # overflow counter (SURVEY.md §7.3 item 1): uniques beyond the static
        # capacity alias slot cap-1 and corrupt the result — count them so
        # the caller can detect it (psum'd below when with_overflow).
        ovf = jnp.maximum(n_uniq - cap, 0).astype(jnp.int32)
        cap_p = -(-cap // n_rows) * n_rows
        uid = jnp.zeros((cap_p,), flat.dtype).at[
            jnp.minimum(urank_sorted, cap - 1)].set(sorted_ids)
        uid = jnp.where(jnp.arange(cap_p) < n_uniq, uid, 0)
        # 2. bucket unique ids by owner (sorted -> searchsorted offsets)
        owner = jnp.clip(uid // per, 0, n_rows - 1)
        o_idx = jnp.argsort(owner)
        req_ids = uid[o_idx]
        req_owner = owner[o_idx]
        starts = jnp.searchsorted(req_owner, jnp.arange(n_rows))
        within = jnp.arange(cap_p) - starts[req_owner]
        req = jnp.zeros((n_rows, cap_p), flat.dtype).at[
            req_owner, within].set(req_ids)
        # 3. exchange: requests out, embeddings back
        req_recv = jax.lax.all_to_all(
            req, ROWS_AXIS, split_axis=0, concat_axis=0)
        local = req_recv - r * per                       # [n_rows, cap_p]
        ok = (local >= 0) & (local < per)
        emb = jnp.take(tbl, jnp.where(ok, local, 0), axis=0)
        emb = emb * ok[..., None].astype(emb.dtype)
        resp = jax.lax.all_to_all(
            emb, ROWS_AXIS, split_axis=0, concat_axis=0)
        # 4. un-bucket to unique-slot order, then un-dedup per position
        uemb_sorted = resp[req_owner, within]            # [cap_p, d]
        uemb = jnp.zeros((cap_p, d), resp.dtype).at[o_idx].set(uemb_sorted)
        emb_out = uemb[urank].reshape(ids_.shape + (d,))
        if not with_overflow:
            return emb_out
        return emb_out, jax.lax.psum(ovf, (DATA_AXIS, ROWS_AXIS))

    both = P((DATA_AXIS, ROWS_AXIS))
    out_specs = (both, P()) if with_overflow else both
    out = jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(ROWS_AXIS, None), both),
        out_specs=out_specs)(table, ids_p)
    if with_overflow:
        emb, ovf = out
        return (emb[:n0] if n0_pad != n0 else emb), ovf
    return out[:n0] if n0_pad != n0 else out


def make_lookup_fn(mesh: Mesh, mode: str, capacity: int = 0):
    """Embedding-lookup implementation for ShardingConfig.lookup_mode,
    pluggable into ScoreModel.lookup_fn. 'local'/None -> plain take (GSPMD
    partitions it); 'psum'/'a2a' -> the explicit shard_map exchanges.
    `capacity`: a2a per-device unique-id buffer bound (0 = exact). The a2a
    path returns (emb, overflow_count) — EmbeddingTables._lookup sows the
    counter into the 'diagnostics' collection so capacity overflow is
    detected, never silent (SURVEY.md §7.3 item 1)."""
    import functools
    if mode in (None, "local"):
        return None
    if mode == "psum":
        return functools.partial(psum_lookup, mesh)
    if mode == "a2a":
        return functools.partial(a2a_lookup, mesh, capacity=capacity,
                                 with_overflow=True)
    raise ValueError(f"unknown lookup_mode {mode}")


def pad_rows(table: jnp.ndarray, n_rows: int) -> jnp.ndarray:
    """Pad a table's row count up to a multiple of the rows axis (the pad
    rows are zeros and are never addressed by valid ids)."""
    V = table.shape[0]
    pad = (-V) % n_rows
    if pad == 0:
        return table
    return jnp.pad(table, ((0, pad), (0, 0)))
