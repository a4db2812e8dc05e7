"""Perf sweep over train-step variants on the flagship configs3 model.

Measures steady-state train examples/s for a grid of knobs (batch size,
compute dtype, negatives, lowering probes): every timing ends with a host
readback of the last fused step's loss, which waits for the whole chunk.

Usage:  python scripts/perf_sweep.py [variant ...]
        (no args = full grid; variant names printed in output)

Output: one JSON line per variant to stdout.
"""

from __future__ import annotations

import json
import sys
import time

sys.path.insert(0, ".")

import numpy as np

NUM_USERS = 50_000
NUM_ITEMS = 100_000
NUM_EVENTS = 2_000_000
NUM_SLOTS = 9
FANOUT = 10
EMBED_DIM = 32
STEPS_PER_CALL = 50
TRAIN_CALLS = 6


def run_variant(name, ds, graph, *, batch, compute_dtype="float32",
                num_train_neg=1, neg_mode="uniform",
                dotfree=False, gru_unroll=1, embed_dim=EMBED_DIM,
                push_rolls=False, table_stride=1, static_pair=False,
                wr_on_summary=None, table_lr_boost=1.0):
    # push_rolls default matches the SHIPPED nn.coattn default (False =
    # materialized rolls).
    import jax
    from score_tpu.config import configs3
    from score_tpu.nn import coattn as _coattn
    from score_tpu.nn import encoder as _encoder
    _coattn.DOT_FREE = dotfree
    _coattn.PUSH_ROLLS = push_rolls
    if wr_on_summary is not None:
        _coattn.WR_ON_SUMMARY = wr_on_summary
    _encoder.SCAN_UNROLL = gru_unroll
    from score_tpu.data.pipeline import TargetIterator
    from score_tpu.train import (_stack_batches, build_model, init_state,
                                 make_train_loop)

    cfg = configs3()
    cfg = cfg.replace(
        model=cfg.model.__class__(
            embed_dim=embed_dim, hidden_dim=64, mlp_dims=(128, 64),
            sides="dual", slot_agg="coattn", seq_pool="attn",
            target_aware=True, compute_dtype=compute_dtype),
        data=cfg.data.__class__(num_train_neg=num_train_neg,
                                train_neg_mode=neg_mode),
        train=cfg.train.__class__(batch_size=batch,
                                  table_update_every=table_stride,
                                  table_lr_boost=table_lr_boost))
    model = build_model(cfg, ds.num_users, ds.num_items)
    rng = jax.random.PRNGKey(0)
    state = init_state(cfg, model, graph, rng)
    neg_iw = None
    if neg_mode == "inbatch_iw":
        import jax.numpy as jnp

        from score_tpu.train import item_importance_weights
        neg_iw = jnp.asarray(item_importance_weights(ds.train, ds.num_items))
    if static_pair:
        # Static stride-2 alternation probe: the fused loop scans PAIRS of
        # batches through statically-built
        # full/dense step graphs instead of a runtime lax.cond — measures
        # whether the cond's branch plumbing costs anything. Valid because
        # the loop enters at step 0 (even parity).
        import functools

        from score_tpu.train import _make_train_step_fn
        assert table_stride == 2, table_stride
        step_full = _make_train_step_fn(model, cfg, with_auc=False,
                                        neg_iw=neg_iw, force_branch="full")
        step_dense = _make_train_step_fn(model, cfg, with_auc=False,
                                         neg_iw=neg_iw, force_branch="dense")

        @functools.partial(jax.jit, donate_argnums=(0,))
        def train_loop(state, graph_, batches, rng):
            def body(st, pair):
                b0 = {k2: v[0] for k2, v in pair.items()}
                b1 = {k2: v[1] for k2, v in pair.items()}
                st, _ = step_full(st, graph_, b0, rng)
                st, m = step_dense(st, graph_, b1, rng)
                return st, {"loss": m["loss"]}
            k2n = next(iter(batches.values())).shape[0] // 2
            pairs = {k2: v.reshape((k2n, 2) + v.shape[1:])
                     for k2, v in batches.items()}
            return jax.lax.scan(body, state, pairs)
    else:
        train_loop = make_train_loop(model, cfg, neg_iw=neg_iw)
    it = TargetIterator(ds.train, batch, seed=0)

    K = STEPS_PER_CALL
    state, ms = train_loop(state, graph, _stack_batches(it, K), rng)
    float(ms["loss"][-1])  # warmup + compile (readback forces execution)

    rates = []
    for _ in range(TRAIN_CALLS):
        stacked = _stack_batches(it, K)
        t0 = time.time()
        state, ms = train_loop(state, graph, stacked, rng)
        last = float(ms["loss"][-1])   # data-dependent readback = honest wall
        dt = time.time() - t0
        rates.append(K * batch / dt)
    rates = np.array(rates)
    out = dict(variant=name, batch=batch, dtype=compute_dtype,
               neg=num_train_neg,
               examples_per_s=float(np.median(rates)),
               rate_min=float(rates.min()), rate_max=float(rates.max()),
               step_ms=float(1000.0 * STEPS_PER_CALL * batch /
                             np.median(rates) / STEPS_PER_CALL),
               last_loss=last)
    print(json.dumps(out), flush=True)
    return out


VARIANTS = {
    "base_2048_f32": dict(batch=2048),
    "b4096_f32": dict(batch=4096),
    "b8192_f32": dict(batch=8192),
    "b2048_bf16": dict(batch=2048, compute_dtype="bfloat16"),
    "b4096_bf16": dict(batch=4096, compute_dtype="bfloat16"),
    "b8192_bf16": dict(batch=8192, compute_dtype="bfloat16"),
    "b4096_bf16_inbatch": dict(batch=4096, compute_dtype="bfloat16",
                               neg_mode="inbatch"),
    "b8192_bf16_inbatch": dict(batch=8192, compute_dtype="bfloat16",
                               neg_mode="inbatch"),
    "b4096_bf16_inbatch_iw": dict(batch=4096, compute_dtype="bfloat16",
                                  neg_mode="inbatch_iw"),
    "b6144_bf16_inbatch_iw": dict(batch=6144, compute_dtype="bfloat16",
                                  neg_mode="inbatch_iw"),
    "b8192_bf16_inbatch_iw": dict(batch=8192, compute_dtype="bfloat16",
                                  neg_mode="inbatch_iw"),
    "b3072_bf16_inbatch_iw": dict(batch=3072, compute_dtype="bfloat16",
                                  neg_mode="inbatch_iw"),
    "b4096_bf16_iw_dotfree": dict(batch=4096, compute_dtype="bfloat16",
                                  neg_mode="inbatch_iw", dotfree=True),
    "b6144_bf16_iw_dotfree": dict(batch=6144, compute_dtype="bfloat16",
                                  neg_mode="inbatch_iw", dotfree=True),
    "b4096_bf16_iw_unroll": dict(batch=4096, compute_dtype="bfloat16",
                                 neg_mode="inbatch_iw", gru_unroll=9),
    "b4096_bf16_iw_dotfree_unroll": dict(
        batch=4096, compute_dtype="bfloat16", neg_mode="inbatch_iw",
        dotfree=True, gru_unroll=9),
    # Embedding-width sweep: how the [B,T,n,d] co-attention layout cost
    # moves with d
    "b4096_bf16_iw_d64": dict(batch=4096, compute_dtype="bfloat16",
                              neg_mode="inbatch_iw", embed_dim=64),
    "b4096_bf16_iw_d128": dict(batch=4096, compute_dtype="bfloat16",
                               neg_mode="inbatch_iw", embed_dim=128),
    "b4096_bf16_iw_noroll": dict(batch=4096, compute_dtype="bfloat16",
                                 neg_mode="inbatch_iw", push_rolls=False),
    "b4096_bf16_iw_pushroll": dict(batch=4096, compute_dtype="bfloat16",
                                   neg_mode="inbatch_iw", push_rolls=True),
    # Stride-K table updates: (K-1)/K of steps skip the table-grad
    # scatter-adds + table adam entirely
    "b4096_bf16_iw_stride2": dict(batch=4096, compute_dtype="bfloat16",
                                  neg_mode="inbatch_iw", table_stride=2),
    "b4096_bf16_iw_stride4": dict(batch=4096, compute_dtype="bfloat16",
                                  neg_mode="inbatch_iw", table_stride=4),
    "b4096_bf16_iw_stride2_static": dict(
        batch=4096, compute_dtype="bfloat16", neg_mode="inbatch_iw",
        table_stride=2, static_pair=True),
    # the SHIPPED bench step (static stride loop via make_train_loop)
    # with the WR_ON_SUMMARY reassociation off/on
    "b4096_bf16_iw_s2_wrbase": dict(
        batch=4096, compute_dtype="bfloat16", neg_mode="inbatch_iw",
        table_stride=2, table_lr_boost=2.0, wr_on_summary=False),
    "b4096_bf16_iw_s2_wrsum": dict(
        batch=4096, compute_dtype="bfloat16", neg_mode="inbatch_iw",
        table_stride=2, table_lr_boost=2.0, wr_on_summary=True),
}


def main():
    from score_tpu.data import synth
    from score_tpu.data.prep_common import build_dataset
    from score_tpu.graph import device_graph

    names = sys.argv[1:] or list(VARIANTS)
    t0 = time.time()
    user, item, ts = synth.synth_events(
        NUM_USERS, NUM_ITEMS, NUM_EVENTS, num_slots=NUM_SLOTS, seed=0)
    ds = build_dataset(user, item, ts, num_slots=NUM_SLOTS,
                       user_fanout=FANOUT, item_fanout=FANOUT,
                       num_eval_neg=100, min_user=3, min_item=3, seed=0,
                       dataset_name="sweep")
    graph = device_graph(ds.graph)
    print(json.dumps(dict(prep_s=round(time.time() - t0, 1))), flush=True)
    for n in names:
        try:
            run_variant(n, ds, graph, **VARIANTS[n])
        except Exception as e:  # keep sweeping past a broken variant
            print(json.dumps(dict(variant=n, error=repr(e)[:300])), flush=True)


if __name__ == "__main__":
    main()
