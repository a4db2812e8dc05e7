"""Online scoring service (the p50-latency path).

The reference has no serving story (research code); this wraps the trained
model + device-resident graph into a warm, jitted candidate scorer:

    svc = ScoringService(cfg, dataset, params)        # or .from_checkpoint
    scores = svc.score(user_id, item_ids)             # [len(item_ids)]
    items, scores = svc.topk(user_id, k=10)           # over a candidate pool

All scoring shapes are padded to fixed buckets so repeated requests hit the
jit cache; histories are gathered on-device from the resident adjacency
(SURVEY.md §3.4: this path is what the driver's p50 metric times).

Catalog scale: candidate lists wider than `candidate_chunk` are scored in
fixed-size blocks streamed through ONE warm jit shape — a full-catalog
`topk` over millions of items materializes per-dispatch tensors of only
[R, chunk, T, m, d] instead of what a single all-candidate dispatch would
need (tens of GB at 1e6+ items). Block dispatches are issued back-to-back
and read back once at the end, so host dispatch overlaps device work
instead of serializing with it.

configs4 serving: pass `mesh` (and a lookup_fn for the explicit a2a path)
to serve a ROW-SHARDED checkpoint — tables and graph shard over
Mesh('data','rows') exactly as in training, and
`from_checkpoint(..., mesh=...)` restores the checkpoint directly onto the
mesh (sharded template).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .config import Config
from .data.schema import Dataset
from .graph import DeviceGraph, device_graph, gather_candidate_batch
from .train import build_model

_BUCKETS = (1, 16, 64, 256, 1024, 4096)


def _bucket(n: int) -> int:
    for b in _BUCKETS:
        if n <= b:
            return b
    return -(-n // _BUCKETS[-1]) * _BUCKETS[-1]


class ScoringService:
    """Warm jitted scorer over the trained model + graph store.

    mesh/lookup_fn: serve a configs4 model — graph and table params are
    sharded over the mesh (rows axis) and the score dispatch runs the same
    GSPMD or explicit-exchange lookup path as training. Single-device by
    default.
    """

    def __init__(self, cfg: Config, ds: Dataset, params,
                 slot: Optional[int] = None, mesh=None, lookup_fn=None,
                 candidate_chunk: int = 4096, topk_grid_rows: int = 16):
        self.cfg = cfg
        self.mesh = mesh
        self.candidate_chunk = int(candidate_chunk)
        self.topk_grid_rows = int(topk_grid_rows)
        self.graph: DeviceGraph = device_graph(ds.graph)
        self.num_items = ds.num_items
        self.model = build_model(cfg, ds.num_users, ds.num_items,
                                 lookup_fn=lookup_fn)
        # Shard FIRST, then bf16-cast: _prepare_params materializes each
        # table it casts, so casting pre-shard would stage full tables on
        # the default device — exactly the OOM sharded serving exists to
        # avoid. astype on a NamedSharding array preserves its placement
        #.
        if mesh is not None:
            from .sharding import shard_graph, shard_tree
            self.graph = shard_graph(mesh, self.graph)
            params = shard_tree(mesh, params)
        self.params = self._prepare_params(params)
        # default scoring slot: "now" = one past the last slot, so the full
        # history is visible (no leakage concern at serving time)
        self.slot = ds.graph.num_slots if slot is None else slot

        @jax.jit
        def _score_cand(params, graph, users, cand, slots):
            mb = gather_candidate_batch(graph, users, cand, slots)
            return self.model.score_candidates(params, mb)

        self._score_cand = _score_cand

    def _prepare_params(self, params):
        """Serving-side weight prep: when the model computes in bfloat16,
        cast 2-D embedding-table leaves to bf16 once at init.

        Same values by construction: the model already does
        `gather(f32_table).astype(bf16)`, and elementwise rounding commutes
        with row selection, so `gather(bf16_table)` feeds the model the
        identical bf16 rows (BIT-equal at the embedding stage; full-score
        equality is up to XLA's per-compilation bf16 fusion order —
        tested to bf16 resolution). The win is the gather itself: a
        pre-cast bf16 table gathers contiguous rows at half the bytes, and
        the f32->bf16 convert stays out of the gather fusion (where it can
        push XLA to a column-major table layout)."""
        if params is None or (jnp.dtype(self.cfg.model.compute_dtype)
                              != jnp.dtype(jnp.bfloat16)):
            return params

        def cast(path, v):
            if ("table" in jax.tree_util.keystr(path)
                    and getattr(v, "ndim", 0) == 2):
                return jnp.asarray(v).astype(jnp.bfloat16)
            return v
        return jax.tree_util.tree_map_with_path(cast, params)

    @classmethod
    def from_checkpoint(cls, cfg: Config, ds: Dataset, ckpt_dir: str,
                        which: str = "best", mesh=None,
                        lookup_fn=None, **service_kw) -> "ScoringService":
        """Restore a checkpoint and serve it. With `mesh`, the restore
        template is sharded FIRST, so each table leaf is put straight onto
        its row shards — it never exists unsharded on one device (SURVEY.md
        §5 'Checkpoint')."""
        import jax

        from .checkpoint import CheckpointManager
        from .graph import device_graph
        from .train import init_state

        graph = device_graph(ds.graph)
        model = build_model(cfg, ds.num_users, ds.num_items,
                            lookup_fn=lookup_fn)
        state = init_state(cfg, model, graph, jax.random.PRNGKey(0))
        if mesh is not None:
            from .sharding import shard_state
            state = shard_state(mesh, state)
        mgr = CheckpointManager(ckpt_dir)
        restored = mgr.restore(which, state)
        if restored is None:
            raise FileNotFoundError(f"no '{which}' checkpoint in {ckpt_dir}")
        # params already carry their (possibly sharded) placement from the
        # restore template; skip the __init__ re-shard of raw host arrays.
        # service_kw forwards the serving knobs (slot, candidate_chunk,
        # topk_grid_rows) so a restored service can tune the catalog path
        # without poking attributes
        svc = cls(cfg, ds, None, mesh=None, lookup_fn=lookup_fn,
                  **service_kw)
        svc.mesh = mesh
        if mesh is not None:
            from .sharding import shard_graph
            svc.graph = shard_graph(mesh, svc.graph)
        svc.params = svc._prepare_params(restored["params"])
        return svc

    def score(self, user_id: int, item_ids: Sequence[int]) -> np.ndarray:
        """Pointwise scores for one user against a candidate list.

        Runs in candidates form (R=1): the user history tower is computed
        ONCE for the request, not once per candidate — at full-catalog
        candidate counts this is the difference between one and ~10^5 GRU
        passes (ScoreModel.score_candidates; SURVEY.md §3.4)."""
        items = np.asarray(item_ids, np.int32)
        return self.score_batch(np.asarray([user_id], np.int32),
                                items[None, :])[0]

    def _dispatch(self, users: np.ndarray, items: np.ndarray) -> jax.Array:
        """One padded jit dispatch: [R] users x [R, n] candidates -> device
        scores [rb, nb] (bucket-padded; caller slices after readback)."""
        r, n = items.shape
        rb, nb = _bucket(r), _bucket(n)
        pu = np.zeros(rb, np.int32)
        pu[:r] = users
        pi = np.zeros((rb, nb), np.int32)
        pi[:r, :n] = items
        slots = np.full(rb, self.slot, np.int32)
        return self._score_cand(self.params, self.graph, jnp.asarray(pu),
                                jnp.asarray(pi), jnp.asarray(slots))

    def score_batch(self, user_ids: Sequence[int],
                    item_ids) -> np.ndarray:
        """Scores for R independent requests, chunked over wide candidate
        lists.

        `user_ids`: [R]; `item_ids`: [R, n] (one candidate list per user).
        Returns [R, n]. This is the serving-throughput path: the per-call
        dispatch cost amortizes over R requests, and the candidates form
        computes each user's history tower once — not once per candidate
        (SURVEY.md §3.4).

        n > candidate_chunk splits into fixed-width blocks sharing one jit
        shape; all block dispatches are issued before any readback, so the
        device pipelines them (catalog-scale path).
        """
        users = np.asarray(user_ids, np.int32)
        items = np.asarray(item_ids, np.int32)
        if items.ndim != 2 or items.shape[0] != users.size:
            raise ValueError(
                f"item_ids must be [R, n] with R == len(user_ids); got "
                f"{items.shape} vs R={users.size}")
        r, n = items.shape
        chunk = self.candidate_chunk
        if n <= chunk:
            return np.asarray(self._dispatch(users, items))[:r, :n]
        # fixed-width blocks (ragged tail bucket-padded inside _dispatch);
        # issue all dispatches first, read back after
        outs = []
        for lo in range(0, n, chunk):
            blk = items[:, lo:lo + chunk]
            outs.append((self._dispatch(users, blk), blk.shape[1]))
        return np.concatenate(
            [np.asarray(o)[:r, :w] for o, w in outs], axis=1)

    def topk(self, user_id: int, k: int = 10,
             candidates: Optional[Sequence[int]] = None
             ) -> Tuple[np.ndarray, np.ndarray]:
        """Top-k items for a user over `candidates` (default: full catalog).

        Catalog-wide requests are laid out as a GRID of same-user rows —
        [topk_grid_rows, candidate_chunk] per dispatch — so the batch axis
        fills the device the way the serving envelope's R×C dispatches do
        (a 1-row chunk stream leaves it mostly empty). Per-dispatch device
        memory stays [R, chunk, T, m, d]-sized no matter the catalog;
        grid-row pads are item 0 and are sliced off after the one
        readback."""
        if candidates is None:
            candidates = np.arange(1, self.num_items + 1, dtype=np.int32)
        else:
            candidates = np.asarray(candidates, np.int32)
        n = candidates.size
        if n == 0 or k <= 0:
            # argpartition(kth=-1) raises on empty input
            return (np.empty(0, np.int32), np.empty(0, np.float32))
        chunk = self.candidate_chunk
        if n <= chunk:
            scores = self.score(user_id, candidates)
        else:
            pad = (-n) % chunk
            grid = np.concatenate(
                [candidates, np.zeros(pad, np.int32)]).reshape(-1, chunk)
            rows = self.topk_grid_rows
            outs = []
            for lo in range(0, grid.shape[0], rows):
                blk = grid[lo:lo + rows]
                outs.append(self.score_batch(
                    np.full(blk.shape[0], user_id, np.int32), blk))
            scores = np.concatenate([o.reshape(-1) for o in outs])[:n]
        k = min(k, scores.size)
        part = np.argpartition(-scores, k - 1)[:k]
        order = part[np.argsort(-scores[part])]
        return candidates[order], scores[order]

    def topk_batch(self, user_ids: Sequence[int], k: int = 10,
                   candidates: Optional[Sequence[int]] = None,
                   ) -> Tuple[np.ndarray, np.ndarray]:
        """Top-k for R users over a SHARED candidate list (default: full
        catalog). Returns ([R, k] items, [R, k] scores), each row sorted
        descending (the multi-user catalog path).

        Layout: each dispatch carries `g = max(1, topk_grid_rows // R)`
        consecutive candidate chunks for every user — rows are (user,
        chunk) pairs — so the batch axis stays full even at small R (the
        single-user grid trick generalized; without it a small R pays for
        row-bucket padding). Dispatches are issued ahead and merged into a
        running per-user top-k on a bounded cadence — device residency
        stays bounded at catalog scale and host dispatch overlaps
        in-flight blocks, as in `topk`. Grid pad positions (item 0 past the true candidate
        count) are masked to -inf before any merge, so they can never
        enter a top-k."""
        users = np.asarray(user_ids, np.int32)
        r = users.size
        if candidates is None:
            candidates = np.arange(1, self.num_items + 1, dtype=np.int32)
        else:
            candidates = np.asarray(candidates, np.int32)
        n = candidates.size
        if n == 0 or k <= 0 or r == 0:
            return (np.empty((r, 0), np.int32), np.empty((r, 0), np.float32))
        k = min(k, n)

        chunk = self.candidate_chunk
        g = max(1, self.topk_grid_rows // r)     # chunks packed per user
        width = g * chunk                        # candidates per dispatch
        # fixed-width chunk grid, padded with item 0 (masked below)
        pad = (-n) % width
        grid = np.concatenate(
            [candidates, np.zeros(pad, np.int32)]).reshape(-1, g, chunk)
        merge_every = max(1, 64 // g)            # in-flight dispatches
        best_i = np.empty((r, 0), np.int32)
        best_s = np.empty((r, 0), np.float32)
        urow = np.repeat(users, g)               # [r*g] user-major rows

        def merge(pending):
            nonlocal best_i, best_s
            bi, bs = [best_i], [best_s]
            for dev, blk, pos0 in pending:
                s = np.asarray(dev)[:r * g, :chunk] \
                    .reshape(r, width).astype(np.float32)
                valid = min(max(n - pos0, 0), width)
                s[:, valid:] = -np.inf           # grid pads out of the race
                bi.append(np.broadcast_to(blk.reshape(-1), (r, width)))
                bs.append(s)
            all_i = np.concatenate(bi, axis=1)
            all_s = np.concatenate(bs, axis=1)
            kk = min(k, all_s.shape[1])
            part = np.argpartition(-all_s, kk - 1, axis=1)[:, :kk]
            best_i = np.take_along_axis(all_i, part, axis=1)
            best_s = np.take_along_axis(all_s, part, axis=1)

        pending = []
        for j in range(grid.shape[0]):
            blk = grid[j]                        # [g, chunk]
            irow = np.ascontiguousarray(
                np.broadcast_to(blk[None], (r, g, chunk))
                .reshape(r * g, chunk))
            pending.append((self._dispatch(urow, irow), blk, j * width))
            if len(pending) >= merge_every:
                merge(pending)
                pending = []
        if pending:
            merge(pending)
        order = np.argsort(-best_s, axis=1)
        return (np.take_along_axis(best_i, order, axis=1),
                np.take_along_axis(best_s, order, axis=1))
