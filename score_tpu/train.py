"""Train/eval driver (SURVEY.md §2.3 #13, §3.2, §3.4).

The reference's `train.py` runs a TF1 sess.run loop with multiprocessing
samplers. Here the whole step — on-device history gather, on-device negative
sampling, forward, loss, Adam — is ONE jitted function with donated state;
the host only streams (u, i, t*) triples and pulls scalar metrics.

CLI:  python -m score_tpu.train <configs0..configs4> [data_dir] [k=v ...]
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import time
from typing import Any, Callable, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np
import optax

from .config import PRESETS, Config, apply_overrides
from .data.pipeline import TargetIterator
from .data.schema import Dataset
from .graph import DeviceGraph, device_graph, gather_candidate_batch
from .metrics import auc as auc_fn
from .nn.model import ScoreModel
from .nn.scorer import bce_loss


@functools.partial(jax.tree_util.register_dataclass,
                   data_fields=["step", "params", "opt_state"],
                   meta_fields=["tx"])
@dataclasses.dataclass(frozen=True)
class TrainState:
    """Step counter, params and optimizer state (pytree leaves) plus the
    optimizer itself (static)."""

    step: Any
    params: Any
    opt_state: Any
    tx: optax.GradientTransformation

    @classmethod
    def create(cls, params, tx: optax.GradientTransformation) -> "TrainState":
        return cls(step=jnp.zeros((), jnp.int32), params=params,
                   opt_state=tx.init(params), tx=tx)

    def apply_gradients(self, grads) -> "TrainState":
        updates, opt_state = self.tx.update(grads, self.opt_state,
                                            self.params)
        return self.replace(step=self.step + 1,
                            params=optax.apply_updates(self.params, updates),
                            opt_state=opt_state)

    def replace(self, **kw) -> "TrainState":
        return dataclasses.replace(self, **kw)


def build_model(cfg: Config, num_users: int, num_items: int,
                lookup_fn=None):
    if cfg.model.arch != "score":
        from .nn.baselines import DELFModel, MFModel, PopModel, SVDPPModel
        cls = {"mf": MFModel, "pop": PopModel, "svdpp": SVDPPModel,
               "delf": DELFModel}[cfg.model.arch]
    else:
        cls = ScoreModel
    return cls(cfg.model, num_users, num_items, lookup_fn=lookup_fn)


def make_optimizer(cfg: Config, steps_per_epoch: int = 0):
    """Optimizer + LR schedule from TrainConfig (reference: bare Adam at a
    fixed lr — SURVEY.md §2.3 #11; the extra choices are the standard recsys
    hyperparameter surface, all optax one-liners)."""
    tc = cfg.train
    lr = tc.learning_rate
    if tc.lr_schedule == "cosine":
        decay = tc.decay_steps or max(
            steps_per_epoch * cfg.train.num_epochs, 1)
        sched = optax.warmup_cosine_decay_schedule(
            init_value=0.0 if tc.warmup_steps else lr, peak_value=lr,
            warmup_steps=tc.warmup_steps, decay_steps=decay)
    elif tc.warmup_steps:
        sched = optax.linear_schedule(0.0, lr, tc.warmup_steps)
    else:
        sched = lr
    if tc.optimizer == "adam":
        tx = optax.adam(sched)
    elif tc.optimizer == "adamw":
        tx = optax.adamw(sched, weight_decay=tc.weight_decay)
    elif tc.optimizer == "adagrad":
        tx = optax.adagrad(sched)
    else:
        tx = optax.sgd(sched)
    if tc.table_lr_boost != 1.0:
        # scale TABLE-row updates only (same path rule as state_spec):
        # stride-K compensation — K-fold fewer table adam steps, K-fold
        # bigger steps when taken (TrainConfig.table_lr_boost docstring)
        def table_mask(params):
            return jax.tree_util.tree_map_with_path(
                lambda p, v: "table" in jax.tree_util.keystr(p), params)
        tx = optax.chain(
            tx, optax.masked(optax.scale(tc.table_lr_boost), table_mask))
    return tx


def init_state(cfg: Config, model: ScoreModel, graph: DeviceGraph,
               rng: jax.Array, steps_per_epoch: int = 0) -> TrainState:
    """Fresh params and optimizer state. `graph` is unused (param shapes
    follow the config and the id ranges) and kept for the callers."""
    del graph
    params = model.init(rng)
    tx = make_optimizer(cfg, steps_per_epoch)
    return TrainState.create(params=params, tx=tx)


def _freeze_tables(params):
    """stop_gradient on embedding-table leaves: the backward pass then
    produces structural zeros for them — no grad scatter-adds at all (the
    largest share of the step in the profiles this repo has taken). Path
    rule matches state_spec/_table_l2."""
    return jax.tree_util.tree_map_with_path(
        lambda p, v: (jax.lax.stop_gradient(v)
                      if "table" in jax.tree_util.keystr(p) else v), params)


def _keep_table_leaves(old_tree, new_tree):
    """new_tree with every table-path leaf (params AND adam moments — the
    moment trees mirror param paths) taken from old_tree instead. Used by
    the stride-K non-update branch so XLA dead-code-eliminates the zero-grad
    adam arithmetic on the tables."""
    return jax.tree_util.tree_map_with_path(
        lambda p, old, new: (old if "table" in jax.tree_util.keystr(p)
                             else new), old_tree, new_tree)


def _table_l2(params) -> jnp.ndarray:
    """Sum of squares over embedding-table params (paper §3.5 λ‖Emb‖²).
    Path-based so baseline archs (MF biases etc.) are covered too."""
    leaves = jax.tree_util.tree_leaves_with_path(params)
    return sum(jnp.sum(jnp.square(v)) for p, v in leaves
               if "table" in jax.tree_util.keystr(p))


def _resample_collisions(neg: jnp.ndarray, pos: jnp.ndarray,
                         num_items: int) -> jnp.ndarray:
    """Shift negatives that hit their positive by +1 (mod item range)."""
    shifted = neg + (neg == pos)
    return jnp.where(shifted > num_items, 1, shifted)


def item_importance_weights(train_split, num_items: int) -> np.ndarray:
    """Per-item importance weights for train_neg_mode='inbatch_iw':
    w_j = uniform(j) / q(j) where q is the in-batch negative distribution
    (= empirical train popularity, since negatives are rolled positives).
    E_q[w] = 1, so the weighted BCE mean keeps its scale. Items absent from
    the train split can never appear as in-batch negatives; their slot is 0.
    """
    cnt = np.bincount(np.asarray(train_split.item),
                      minlength=num_items + 1).astype(np.float64)
    w = train_split.item.size / (num_items * np.maximum(cnt, 1.0))
    w[cnt == 0] = 0.0
    return w.astype(np.float32)


def _make_train_step_fn(model: ScoreModel, cfg: Config,
                        with_auc: bool = True,
                        neg_iw: Optional[jnp.ndarray] = None,
                        force_branch: Optional[str] = None) -> Callable:
    """Unjitted single-step body (shared by make_train_step / make_train_loop).

    with_auc=False returns the step's logits instead of the batch AUC: the
    rank-sum AUC sorts the scores, a visible share of a fused-loop step, so
    the loop computes AUC once per chunk from the final step's logits
    instead (only the last step's metrics are read).

    force_branch ('full' | 'dense'): build the stride-K step WITHOUT the
    runtime lax.cond, fixing the branch statically — for fused loops that
    know each position's parity (static stride alternation probe) and for
    branch-level tests. Only meaningful when table_update_every > 1.
    """
    k = cfg.data.num_train_neg
    neg_mode = cfg.data.train_neg_mode
    l2 = cfg.train.l2_emb
    # true item-id range for negative sampling (graph/node axes are padded
    # to a mesh-divisible multiple, so shapes over-count)
    num_items = model.num_items

    def _resample(mb, step_rng):
        """Per-step neighbor re-draw (DataConfig.neighbor_resample): the
        dataset stores a wider fan-out; each step samples a fresh uniform
        subset down to the model fan-out, on device."""
        if not cfg.data.neighbor_resample:
            return mb
        from .graph import subsample_neighbors
        r1, r2 = jax.random.split(jax.random.fold_in(step_rng, 2))
        mb = dict(mb)
        mb["u_hist"], mb["u_cnt"] = subsample_neighbors(
            mb["u_hist"], mb["u_cnt"], cfg.data.user_fanout, r1)
        mb["i_hist"], mb["i_cnt"] = subsample_neighbors(
            mb["i_hist"], mb["i_cnt"], cfg.data.item_fanout, r2)
        return mb

    def train_step(state: TrainState, graph: DeviceGraph,
                   batch: Dict[str, jnp.ndarray], rng: jax.Array):
        u, i, t = batch["user"], batch["item"], batch["slot"]
        B = u.shape[0]
        step_rng = jax.random.fold_in(rng, state.step)
        labels = jnp.concatenate(
            [jnp.ones((B, 1), jnp.float32),
             jnp.zeros((B, k), jnp.float32)], axis=1)
        weights = None
        if neg_mode in ("inbatch", "inbatch_iw"):
            # negatives = batch-axis rolls of the positives: only the
            # positives' item-side histories are ever gathered; the model
            # rolls the *embedded* tensors (see ScoreModel.score_candidates)
            if k == 1:
                shifts = jax.random.randint(step_rng, (k,), 1, max(B, 2),
                                            dtype=u.dtype)
            else:
                # distinct shifts: duplicate shifts would double-count a
                # negative column in the loss
                assert k <= max(B - 1, 1), (k, B)
                shifts = jax.random.choice(
                    step_rng, jnp.arange(1, max(B, 2), dtype=u.dtype),
                    (k,), replace=False)
            mb = _resample(gather_candidate_batch(graph, u, i[:, None], t),
                           step_rng)
            mb["neg_shift"] = shifts
            negs = jnp.stack([jnp.roll(i, -s, axis=0) for s in shifts],
                             axis=1)                             # [B, k]
            # a rolled positive can collide with the example's own positive
            # (hot items): drop those elements from the loss
            neg_w = (negs != i[:, None]).astype(jnp.float32)
            if neg_mode == "inbatch_iw":
                # importance-correct the popularity-sampled negatives back
                # to uniform (see item_importance_weights)
                assert neg_iw is not None, \
                    "inbatch_iw needs item_importance_weights(ds.train, ...)"
                neg_w = neg_w * neg_iw[negs]
            weights = jnp.concatenate(
                [jnp.ones((B, 1), jnp.float32), neg_w], axis=1)
        else:
            neg = jax.random.randint(step_rng, (B, k), 1, num_items + 1,
                                     dtype=u.dtype)
            neg = _resample_collisions(neg, i[:, None], num_items)
            # candidates form: [positive | k negatives] per user — the
            # user-side gather/embed/grad runs once per user, not (1+k) times
            cand = jnp.concatenate([i[:, None], neg], axis=1)    # [B, 1+k]
            mb = _resample(gather_candidate_batch(graph, u, cand, t),
                           step_rng)

        def loss_fn(params):
            # ovf: the sharded lookups' capacity-overflow count (a2a —
            # SURVEY.md §7.3 item 1); 0 for local lookups.
            logits, ovf = model.score_candidates_aux(
                params, mb, train=True,
                rng=jax.random.fold_in(step_rng, 1))
            loss = bce_loss(logits, labels, weights)
            reg = l2 * _table_l2(params) if l2 > 0 else 0.0
            return loss + reg, (loss, logits, ovf)

        stride = cfg.train.table_update_every

        def _grad_apply(s, freeze):
            fn = ((lambda p: loss_fn(_freeze_tables(p))) if freeze
                  else loss_fn)
            grads, aux = jax.grad(fn, has_aux=True)(s.params)
            return s.apply_gradients(grads=grads), aux

        if stride <= 1 or force_branch == "full":
            new_state, (loss, logits, ovf) = _grad_apply(state, False)
        elif force_branch == "dense":
            new_state, (loss, logits, ovf) = _grad_apply(state, True)
            new_state = new_state.replace(
                params=_keep_table_leaves(state.params, new_state.params),
                opt_state=_keep_table_leaves(state.opt_state,
                                             new_state.opt_state))
        else:
            # Stride-K table updates (TrainConfig.table_update_every): the
            # runtime executes exactly ONE branch per step (lax.cond), so
            # (stride-1)/stride of steps skip the table-grad scatter-adds
            # AND the table adam arithmetic entirely; dense params update
            # every step. Table params/moments pass through the non-update
            # branch bit-unchanged (_keep_table_leaves).
            def _full(s):
                return _grad_apply(s, False)

            def _dense_only(s):
                ns, aux = _grad_apply(s, True)
                ns = ns.replace(
                    params=_keep_table_leaves(s.params, ns.params),
                    opt_state=_keep_table_leaves(s.opt_state, ns.opt_state))
                return ns, aux

            new_state, (loss, logits, ovf) = jax.lax.cond(
                state.step % stride == 0, _full, _dense_only, state)
        # collision weights feed the monitoring AUC too: in inbatch mode a
        # rolled negative equal to the example's own positive would otherwise
        # be counted as a mislabeled 0
        w = (weights if weights is not None
             else jnp.ones_like(labels))
        if not with_auc:
            return new_state, {"loss": loss, "logits": logits, "weights": w,
                               "a2a_overflow": ovf}
        batch_auc = auc_fn(logits.reshape(-1), labels.reshape(-1),
                           w.reshape(-1))
        return new_state, {"loss": loss, "batch_auc": batch_auc,
                           "a2a_overflow": ovf}

    return train_step


def make_train_step(model: ScoreModel, cfg: Config,
                    neg_iw: Optional[jnp.ndarray] = None) -> Callable:
    return functools.partial(jax.jit, donate_argnums=(0,))(
        _make_train_step_fn(model, cfg, neg_iw=neg_iw))


def make_train_loop(model: ScoreModel, cfg: Config,
                    neg_iw: Optional[jnp.ndarray] = None) -> Callable:
    """Multi-step training: K steps per dispatch via lax.scan.

    The driver stages K batches as one [K, B] device array and runs the
    whole chunk inside one jitted call, so per-step host dispatch never
    sits between two device steps. Returns (state, stacked-metrics).

    Stride-K chunks (table_update_every > 1) are built with STATIC branch
    alternation instead of the per-step lax.cond: the caller passes
    `phase = entry_step % K` (static; at most K compiled variants), a
    python-unrolled lead-in aligns to the next update step, then a scan
    over K-sized groups runs [1 full + (K-1) dense] statically-built step
    graphs, then an unrolled tail. Same math as the cond form, without a
    runtime branch per step."""
    k = cfg.data.num_train_neg
    stride = cfg.train.table_update_every

    def _finish_metrics(m):
        """Chunk metrics from the FINAL step's raw metrics (the driver
        reads only the last step; AUC once per chunk — its rank-sum sort
        is not free)."""
        logits = m["logits"]
        w = m["weights"]
        B = logits.shape[0]
        labels = jnp.concatenate(
            [jnp.ones((B, 1), jnp.float32),
             jnp.zeros((B, k), jnp.float32)], axis=1)
        return auc_fn(logits.reshape(-1), labels.reshape(-1), w.reshape(-1))

    if stride <= 1:
        step_fn = _make_train_step_fn(model, cfg, with_auc=False,
                                      neg_iw=neg_iw)

        @functools.partial(jax.jit, donate_argnums=(0,), static_argnums=(4,))
        def train_loop(state: TrainState, graph: DeviceGraph,
                       batches: Dict[str, jnp.ndarray], rng: jax.Array,
                       phase: int = 0):
            # phase is accepted (and ignored) so callers can pass
            # entry_step % stride uniformly for both loop flavors
            def body(state, batch):
                state, m = step_fn(state, graph, batch, rng)
                return state, m

            state, ms = jax.lax.scan(body, state, batches)
            ms["batch_auc"] = _finish_metrics(
                {k2: ms[k2][-1] for k2 in ("logits", "weights")})[None]
            ms.pop("logits")
            ms.pop("weights")
            return state, ms

        return train_loop

    step_full = _make_train_step_fn(model, cfg, with_auc=False,
                                    neg_iw=neg_iw, force_branch="full")
    step_dense = _make_train_step_fn(model, cfg, with_auc=False,
                                     neg_iw=neg_iw, force_branch="dense")

    @functools.partial(jax.jit, donate_argnums=(0,), static_argnums=(4,))
    def train_loop_stride(state: TrainState, graph: DeviceGraph,
                          batches: Dict[str, jnp.ndarray], rng: jax.Array,
                          phase: int = 0):
        K = next(iter(batches.values())).shape[0]
        at = lambda j: {k2: v[j] for k2, v in batches.items()}
        pick = lambda pos: (step_full if (phase + pos) % stride == 0
                            else step_dense)
        m = None
        ovf_total = jnp.zeros((), jnp.int32)   # whole-chunk overflow sum
        pos = 0
        lead = min((-phase) % stride, K)
        for j in range(lead):                  # unrolled lead-in (< stride)
            state, m = pick(pos)(state, graph, at(pos), rng)
            ovf_total = ovf_total + m["a2a_overflow"]
            pos += 1
        groups = (K - pos) // stride
        if groups > 0:
            sl = {k2: v[pos:pos + groups * stride].reshape(
                (groups, stride) + v.shape[1:])
                for k2, v in batches.items()}

            def body(st, group):
                st, gm = step_full(st, graph,
                                   {k2: v[0] for k2, v in group.items()},
                                   rng)
                ovf = gm["a2a_overflow"]
                for t in range(1, stride):     # unrolled within the group
                    st, gm = step_dense(
                        st, graph, {k2: v[t] for k2, v in group.items()},
                        rng)
                    ovf = ovf + gm["a2a_overflow"]
                gm = dict(gm, a2a_overflow=ovf)
                return st, gm

            state, gms = jax.lax.scan(body, state, sl)
            m = {k2: v[-1] for k2, v in gms.items()}
            ovf_total = ovf_total + gms["a2a_overflow"].sum()
            pos += groups * stride
        for j in range(K - pos):               # unrolled tail (< stride)
            state, m = pick(pos)(state, graph, at(pos), rng)
            ovf_total = ovf_total + m["a2a_overflow"]
            pos += 1
        ms = {"loss": m["loss"][None],
              "a2a_overflow": ovf_total[None],
              "batch_auc": _finish_metrics(m)[None]}
        return state, ms

    return train_loop_stride


def _stack_batches(it, k: int, put=jnp.asarray):
    """Pull k host batches and stack to [k, B] arrays (put: host->device,
    sharded P(None, ('data','rows')) under a mesh)."""
    cols = {"user": [], "item": [], "slot": []}
    for _ in range(k):
        b = next(it)
        for key in cols:
            cols[key].append(b[key])
    return {key: put(np.stack(v)) for key, v in cols.items()}


def make_eval_step(model: ScoreModel) -> Callable:
    @jax.jit
    def eval_step(params, graph: DeviceGraph, batch: Dict[str, jnp.ndarray]):
        """Score each positive against its fixed negatives -> [B, 1+N].
        Candidates form: user-side work is per-user, not per-candidate."""
        u, i, t, neg = (batch["user"], batch["item"], batch["slot"],
                        batch["neg"])
        cand = jnp.concatenate([i[:, None], neg], axis=1)       # [B, 1+N]
        mb = gather_candidate_batch(graph, u, cand, t)
        return model.score_candidates(params, mb)

    return eval_step


@functools.partial(jax.jit, static_argnums=(4,), donate_argnums=(2,))
def _eval_accum(scores, w, carry, bidx, ks):
    """Fold one block of eval scores into the streaming carry.

    carry = {hist_pos, hist_neg: int32[F16_BINS]; msums: f32[n_blocks, M]}.
    The AUC histograms accumulate in place (donated, exact int adds); the
    per-target ranking SUMS write their own msums row (no f32 accumulator
    ever exceeds one block's magnitude — the final reduce is f64 on host).
    """
    from .metrics import rank_sum_keys, ranking_sums, score_hists
    pos = scores[:, 0].astype(jnp.float32)
    neg = scores[:, 1:].astype(jnp.float32)
    sums = ranking_sums(pos, neg, ks=ks, weights=w)
    vec = jnp.stack([sums[k] for k in rank_sum_keys(ks)])
    hp, hn = score_hists(pos, neg, w, carry["hist_pos"], carry["hist_neg"])
    return dict(hist_pos=hp, hist_neg=hn,
                msums=carry["msums"].at[bidx].set(vec))


def eval_table_cast(params, compute_dtype) -> dict:
    """bf16 pre-cast of 2-D embedding-table leaves for EVAL-path gathers.

    A pre-cast bf16 table gathers contiguous rows at half the bytes of the
    f32 master table, and keeps the f32->bf16 convert out of the gather
    fusion (where it can push XLA to a column-major table layout at
    multi-hundred-MB table sizes). Same values by
    construction — rounding commutes with row selection, so the model's
    `gather(table).astype(bf16)` sees bit-equal rows (serve.py
    `_prepare_params` carries the proof; tested to bf16 resolution there).
    Training params stay f32 master weights; this cast is per-eval-call
    and eval-only."""
    import jax

    if jnp.dtype(compute_dtype) != jnp.dtype(jnp.bfloat16):
        return params

    def cast(path, v):
        if ("table" in jax.tree_util.keystr(path)
                and getattr(v, "ndim", 0) == 2):
            return jnp.asarray(v).astype(jnp.bfloat16)
        return v
    return jax.tree_util.tree_map_with_path(cast, params)


def evaluate(eval_step: Callable, params, graph: DeviceGraph, targets,
             batch_size: int = 256, ks=(1, 5, 10),
             max_targets: Optional[int] = None) -> Dict[str, float]:
    """Streaming split evaluation: pooled AUC + per-target ranking metrics
    (SURVEY.md §3.4, §7.3 item 4).

    Fixed-size blocks stream through ONE warm jit shape; each block's
    scores fold into O(1)-size sufficient statistics on device (rank sums
    + the two F16_BINS AUC histograms — metrics.py module docstring), so
    device residency is {block batch, scores, carry} no matter the split:
    the 1e8-prep val split (10.6M targets × 100 negatives) needs ~4.3 GB
    for its negatives alone if shipped whole, and its pooled score vector
    (~2.1e9 floats) cannot be sorted on one chip — neither ever exists
    here. Block dispatches are issued back-to-back with ONE readback at
    the end, so host dispatch overlaps device work.

    Pooled AUC is tie-aware at float16 score resolution (metrics.hist_auc;
    measured |Δ| vs the in-memory sort-based form ~1e-5 on f32 scores,
    exactly 0 on f16-representable scores — tests/test_metrics.py).

    Tail-padding/weights contract is owned by pipeline.eval_index_batches
    (one tested implementation). max_targets subsamples
    for cheap periodic validation; final evals pass None for the full split.
    """
    from .data.pipeline import eval_index_batches
    from .metrics import F16_BINS, hist_auc, rank_sum_keys
    n = len(targets)
    sel = None
    if max_targets is not None and n > max_targets:
        # Deliberately a FIXED seed, independent of cfg.train.seed: every run
        # (and every seed of a multi-seed sweep) early-stops against the same
        # val subsample, so val curves are comparable across runs. The known
        # cost: multi-seed runs share this subsample,
        # mildly correlating their model selection; final test metrics use
        # the FULL split (max_targets=None), so pinned numbers are unaffected.
        sel = np.random.default_rng(0).choice(n, max_targets, replace=False)
        n = max_targets
    # host-side views; per-block fancy-indexing ships only [B(,N)] slices
    cols = {k: (getattr(targets, k) if sel is None
                else getattr(targets, k)[sel])
            for k in ("user", "item", "slot", "neg")}
    names = rank_sum_keys(tuple(ks))
    n_blocks = -(-n // batch_size)
    carry = dict(hist_pos=jnp.zeros(F16_BINS, jnp.int32),
                 hist_neg=jnp.zeros(F16_BINS, jnp.int32),
                 msums=jnp.zeros((n_blocks, len(names)), jnp.float32))
    for bi, (idx_np, w_np) in enumerate(eval_index_batches(n, batch_size)):
        batch = {k: jnp.asarray(v[idx_np]) for k, v in cols.items()}
        scores = eval_step(params, graph, batch)
        carry = _eval_accum(scores, jnp.asarray(w_np), carry,
                            jnp.int32(bi), tuple(ks))
    carry = jax.device_get(carry)                  # single readback
    sums = carry["msums"].astype(np.float64).sum(axis=0)
    by_name = dict(zip(names, sums))
    denom = max(by_name.pop("wsum"), 1.0)
    out = {k2: float(v / denom) for k2, v in by_name.items()}
    out["auc"] = hist_auc(carry["hist_pos"], carry["hist_neg"])
    return out


def train(cfg: Config, ds: Dataset, verbose: bool = True,
          log_path: Optional[str] = None) -> Dict:
    """Epoch loop with periodic validation, early stop on val AUC, best-param
    tracking, final test metrics (SURVEY.md §3.2)."""
    graph = device_graph(ds.graph)
    n_shards = cfg.sharding.num_data * cfg.sharding.num_rows
    lookup_fn = None
    mesh = None
    if n_shards > 1:
        from .sharding import (batch_sharding, bringup, shard_graph,
                               shard_state)
        mesh, lookup_fn = bringup(cfg.sharding)
        graph = shard_graph(mesh, graph)
    model = build_model(cfg, ds.num_users, ds.num_items, lookup_fn=lookup_fn)
    rng = jax.random.PRNGKey(cfg.train.seed)
    it = TargetIterator(ds.train, cfg.train.batch_size, seed=cfg.train.seed)
    state = init_state(cfg, model, graph, rng,
                       steps_per_epoch=it.steps_per_epoch)
    if mesh is not None:
        from .sharding import stacked_batch_sharding
        assert cfg.train.batch_size % mesh.size == 0, (
            f"batch_size {cfg.train.batch_size} must divide over the "
            f"{mesh.size}-device mesh (batch is sharded over both axes)")
        state = shard_state(mesh, state)
        _bs = batch_sharding(mesh)
        _sbs = stacked_batch_sharding(mesh)
        put = lambda v: jax.device_put(jnp.asarray(v), _bs)
        put_stacked = lambda v: jax.device_put(jnp.asarray(v), _sbs)
    else:
        put = jnp.asarray
        put_stacked = jnp.asarray
    neg_iw = None
    if cfg.data.train_neg_mode == "inbatch_iw":
        neg_iw = jnp.asarray(item_importance_weights(ds.train,
                                                     ds.num_items))
    train_step = make_train_step(model, cfg, neg_iw=neg_iw)
    eval_step = make_eval_step(model)

    steps_per_epoch = it.steps_per_epoch
    total_steps = steps_per_epoch * cfg.train.num_epochs
    eval_every = min(cfg.train.eval_every_steps, max(steps_per_epoch, 1))

    best = {"val_auc": -1.0, "step": -1, "params": None}
    history = []
    bad_evals = 0
    logf = open(log_path, "a") if log_path else None
    t_start = time.time()

    step = 0
    ckpt = None
    if cfg.train.checkpoint_dir:
        from .checkpoint import CheckpointManager, apply_restore
        ckpt = CheckpointManager(cfg.train.checkpoint_dir)
        restored = ckpt.restore("latest", state)
        if restored is not None:
            state = apply_restore(state, restored)
            it.set_state((int(restored["it_epoch"]), int(restored["it_pos"])))
            best["val_auc"] = float(restored["best_val"])
            step = int(restored["step"])
            if verbose:
                print(f"resumed from step {step} "
                      f"(best val auc {best['val_auc']:.4f})", flush=True)
    # Fuse K steps per dispatch (lax.scan) whenever no logging/eval boundary
    # falls inside the chunk, so host dispatch never sits between two
    # device steps. Under a mesh the stacked [K, B] batches are device_put
    # sharded
    # P(None, ('data','rows')) so configs4 training is NOT
    # one-dispatch-per-step either.
    train_loop = make_train_loop(model, cfg, neg_iw=neg_iw)

    def _next_boundary(s):
        nxt = [total_steps]
        for period in (eval_every, cfg.train.log_every_steps):
            if period < 10 ** 8:
                nxt.append((s // period + 1) * period)
        return min(nxt)

    profiling = False
    while step < total_steps:
        chunk = min(_next_boundary(step) - step, 50)
        if chunk > 1 and not cfg.train.profile_dir:
            stacked = _stack_batches(it, chunk, put=put_stacked)
            state, ms = train_loop(
                state, graph, stacked, rng,
                step % max(cfg.train.table_update_every, 1))
            m = {k: v[-1] for k, v in ms.items()}
            if "a2a_overflow" in ms:
                m["a2a_overflow"] = ms["a2a_overflow"].sum()  # whole chunk
            step += chunk
        else:
            batch = next(it)
            state, m = train_step(
                state, graph, {k: put(v) for k, v in batch.items()}, rng)
            step += 1
        if cfg.train.profile_dir:
            # trace steps 10..30 (past compile, short enough to inspect)
            if step >= 10 and not profiling:
                jax.profiler.start_trace(cfg.train.profile_dir)
                profiling = True
            elif step >= 30 and profiling:
                jax.profiler.stop_trace()
                profiling = False
        if cfg.sharding.lookup_mode == "a2a":
            # capacity overflow means the lookup read aliased rows — surface
            # it loudly instead of silently training on corrupt embeddings
            # (SURVEY.md §7.3 item 1). Readback only under a2a.
            ovf = int(m.get("a2a_overflow", 0))
            if ovf > 0:
                msg = (f"step {step}: a2a_lookup capacity overflow "
                       f"({ovf} uniques dropped) — raise "
                       f"sharding.a2a_capacity "
                       f"(current {cfg.sharding.a2a_capacity}); metrics "
                       f"from this step on are corrupt")
                if cfg.sharding.overflow_action == "raise":
                    # abort rather than let an unattended run train on
                    # aliased embeddings forever; the
                    # periodic 'latest' checkpoint remains the resume point
                    raise RuntimeError(msg)
                print("WARNING " + msg, flush=True)
        if verbose and step % cfg.train.log_every_steps == 0:
            loss = float(m["loss"])
            print(f"step {step}/{total_steps} epoch {it.epoch} "
                  f"loss {loss:.4f} batch_auc {float(m['batch_auc']):.4f}",
                  flush=True)
        if step % eval_every == 0 or step == total_steps:
            val = evaluate(eval_step,
                           eval_table_cast(state.params,
                                           cfg.model.compute_dtype),
                           graph, ds.val,
                           max_targets=cfg.train.eval_max_targets)
            rec = dict(step=step, split="val", **val,
                       loss=float(m["loss"]),
                       elapsed_s=round(time.time() - t_start, 2))
            history.append(rec)
            if logf:
                logf.write(json.dumps(rec) + "\n")
                logf.flush()
            if verbose:
                print(f"  val @ step {step}: auc {val['auc']:.4f} "
                      f"ndcg@10 {val['ndcg@10']:.4f} hr@10 {val['hr@10']:.4f}",
                      flush=True)
            if ckpt is not None:
                ckpt.save("latest", state, it.get_state(),
                          best["val_auc"], step)
            if val["auc"] > best["val_auc"]:
                # a device-side copy keeps each leaf's sharding (row-sharded
                # tables stay row-sharded); the next step donates state
                best = {"val_auc": val["auc"], "step": step,
                        "params": jax.tree.map(jnp.copy, state.params)}
                bad_evals = 0
                if ckpt is not None:
                    ckpt.save("best", state, it.get_state(),
                              val["auc"], step)
            else:
                bad_evals += 1
                if bad_evals >= cfg.train.early_stop_patience:
                    if verbose:
                        print(f"early stop at step {step} "
                              f"(best val auc {best['val_auc']:.4f} "
                              f"@ {best['step']})")
                    break

    if profiling:
        jax.profiler.stop_trace()
    if ckpt is not None:
        ckpt.wait()   # commit the last async save before we may exit
    final_params = (best["params"] if best["params"] is not None
                    else state.params)
    test = evaluate(eval_step,
                    eval_table_cast(final_params, cfg.model.compute_dtype),
                    graph, ds.test)
    if verbose:
        print(f"test: auc {test['auc']:.4f} ndcg@10 {test['ndcg@10']:.4f} "
              f"hr@10 {test['hr@10']:.4f} mrr {test['mrr']:.4f}")
    if logf:
        logf.write(json.dumps(dict(step=step, split="test", **test)) + "\n")
        logf.close()
    return dict(best_val_auc=best["val_auc"], best_step=best["step"],
                test=test, history=history, params=final_params,
                steps_run=step)


def main(argv=None):
    import sys
    argv = argv if argv is not None else sys.argv[1:]
    if not argv or argv[0] not in PRESETS:
        print(__doc__)
        print("presets:", ", ".join(PRESETS))
        raise SystemExit(2)
    cfg = PRESETS[argv[0]]()
    data_dir = None
    overrides = {}
    for a in argv[1:]:
        if "=" in a:
            key, v = a.split("=", 1)
            overrides[key] = v
        else:
            data_dir = a
    if overrides:
        cfg = apply_overrides(cfg, overrides)
    from .data.prep_datasets import PREP
    from .data.schema import load_dataset
    from .runtime import REPO_ROOT, setup_compile_cache
    setup_compile_cache()
    if data_dir and os.path.exists(os.path.join(data_dir, "meta.json")):
        ds = load_dataset(data_dir)
    else:
        data_dir = data_dir or os.path.join(REPO_ROOT, "data_cache",
                                            cfg.data.dataset)
        prep = PREP.get(cfg.data.dataset, PREP["taobao"])
        ds = prep(data_dir, user_fanout=cfg.data.user_fanout,
                  item_fanout=cfg.data.item_fanout,
                  num_eval_neg=cfg.data.num_eval_neg)
    train(cfg, ds)


if __name__ == "__main__":
    main()
