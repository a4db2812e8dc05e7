"""Benchmark harness — prints ONE JSON line for the driver.

Metric (BASELINE.md protocol): training examples/s per device on the
flagship configs3 model at Taobao-ish scale (synthetic data made from a
fixed seed, no network), steady-state jitted steps timed to a host readback,
compile excluded; plus ranked-eval throughput and p50 scoring latency over
repeated small-batch forwards.

Needs a GPU: on any other backend it exits non-zero, unless JAX_PLATFORMS=cpu
was set explicitly for a dry run of the code path (whose numbers are then
CPU numbers, not device numbers).
"""

from __future__ import annotations

import json
import time

import jax
import numpy as np

# benchmark shape knobs (Taobao-ish scale per SURVEY.md §2.3 #2, cut to fit
# one device and a short run)
NUM_USERS = 50_000
NUM_ITEMS = 100_000
NUM_EVENTS = 2_000_000
NUM_SLOTS = 9
FANOUT = 10
BATCH = 4096
EMBED_DIM = 32
COMPUTE_DTYPE = "bfloat16"  # true-bf16 activation chain; quality-gated vs
                            # f32 by scripts/bf16_quality.py (BASELINE.md)
NEG_MODE = "inbatch_iw"  # importance-weighted in-batch negatives: zero
                         # negative-side gathers/scatter-adds; quality-gated
                         # vs 'uniform' by scripts/negmode_quality.py — val
                         # AUC 0.7790 vs 0.7557 (BASELINE.md round-2 row)
TABLE_STRIDE = 2         # stride-K table updates + K-fold table-lr boost:
TABLE_LR_BOOST = 2.0     # the table-grad scatter-adds run on half the steps;
                         # 3-seed gate val AUC 0.7815 vs 0.7728 K=1
                         # (BASELINE.md r4 row; stride4 fails its gate even
                         # boosted, not used)
STEPS_PER_CALL = 50     # K steps fused into one dispatch (lax.scan)
TRAIN_CALLS = 8
LATENCY_ITERS = 200
LATENCY_BATCH = 1
EVAL_NEG = 100


def _devices_of(tree) -> set:
    """The devices the arrays of `tree` live on (what a step on it uses)."""
    devs = set()
    for leaf in jax.tree_util.tree_leaves(tree):
        devs |= set(leaf.devices())
    return devs


def main() -> None:
    import jax.numpy as jnp

    from score_tpu.runtime import (gpu_name_and_power_limit, require_gpu,
                                   setup_compile_cache)
    dev = require_gpu(allow_cpu_dry_run=True)
    setup_compile_cache()
    print(f"device: {dev.platform} {dev.device_kind}", flush=True)
    if dev.platform == "gpu":
        print(f"gpu: {gpu_name_and_power_limit()}", flush=True)

    from score_tpu.config import configs3
    from score_tpu.data import synth
    from score_tpu.data.prep_common import build_dataset
    from score_tpu.data.pipeline import TargetIterator
    from score_tpu.graph import device_graph
    from score_tpu.train import build_model, init_state, make_eval_step

    t0 = time.time()
    user, item, ts = synth.synth_events(
        NUM_USERS, NUM_ITEMS, NUM_EVENTS, num_slots=NUM_SLOTS, seed=0)
    ds = build_dataset(user, item, ts, num_slots=NUM_SLOTS,
                       user_fanout=FANOUT, item_fanout=FANOUT,
                       num_eval_neg=EVAL_NEG, min_user=3, min_item=3, seed=0,
                       dataset_name="bench-taobao")
    prep_s = time.time() - t0

    # dataclasses.replace, NOT __class__(...): a bare-constructor rebuild
    # silently resets every unlisted field to its dataclass default, so a
    # future default change would change what the benchmark measures
    import dataclasses
    cfg = configs3()
    cfg = cfg.replace(
        model=dataclasses.replace(
            cfg.model, embed_dim=EMBED_DIM, hidden_dim=64,
            mlp_dims=(128, 64), sides="dual", slot_agg="coattn",
            seq_pool="attn", target_aware=True,
            compute_dtype=COMPUTE_DTYPE),
        data=dataclasses.replace(cfg.data, train_neg_mode=NEG_MODE),
        train=dataclasses.replace(cfg.train, batch_size=BATCH,
                                  table_update_every=TABLE_STRIDE,
                                  table_lr_boost=TABLE_LR_BOOST))
    graph = device_graph(ds.graph)
    model = build_model(cfg, ds.num_users, ds.num_items)
    rng = jax.random.PRNGKey(0)
    state = init_state(cfg, model, graph, rng)
    from score_tpu.train import (_stack_batches, item_importance_weights,
                                 make_train_loop)
    neg_iw = (jnp.asarray(item_importance_weights(ds.train, ds.num_items))
              if NEG_MODE == "inbatch_iw" else None)
    train_loop = make_train_loop(model, cfg, neg_iw=neg_iw)
    eval_step = make_eval_step(model)

    it = TargetIterator(ds.train, BATCH, seed=0)

    # --- training throughput: K steps per dispatch (train-loop-in-jit).
    # Timings end with a host readback of the last step's loss: loss[-1]
    # depends on the whole param chain, so it waits for every step.
    K = STEPS_PER_CALL
    state, ms = train_loop(state, graph, _stack_batches(it, K), rng)
    float(ms["loss"][-1])                      # warmup + compile
    # best-of-2 timed windows (the host's clock is shared with other
    # work); every window still reads back its final loss
    step_s = float("inf")
    for _win in range(2):
        stacks = [_stack_batches(it, K) for _ in range(TRAIN_CALLS)]
        t1 = time.time()
        for s in stacks:
            state, ms = train_loop(state, graph, s, rng)
        final_loss = float(ms["loss"][-1])     # forces the full chain
        step_s = min(step_s, (time.time() - t1) / (TRAIN_CALLS * K))
    examples_per_s = BATCH / step_s

    # --- ranked-eval throughput (targets/s, each vs 1+100 candidates) ---
    # Host-clock numbers vary run to run with the host's other load, so
    # serving numbers here are best-of-3 spaced reps — a floor measurement
    # of the serving path.
    from score_tpu.train import eval_table_cast, evaluate
    # bf16 table pre-cast for the eval path (same values to bf16
    # resolution; see train.eval_table_cast)
    eval_params = eval_table_cast(state.params, cfg.model.compute_dtype)
    n_eval = 4096
    # warmup at the SAME max_targets: the pooled-metric graphs compile per
    # target-count shape, and a shape-cold timed call measures the compile
    ev = evaluate(eval_step, eval_params, graph, ds.val,
                  batch_size=512, max_targets=n_eval)   # compile warmup
    eval_targets_per_s = 0.0
    for _ in range(3):
        t_ev = time.time()
        ev = evaluate(eval_step, eval_params, graph, ds.val,
                      batch_size=512, max_targets=n_eval)
        eval_targets_per_s = max(eval_targets_per_s,
                                 n_eval / (time.time() - t_ev))

    # --- p50 scoring latency (small-batch forward, warm cache) ---
    ev_batch = {
        "user": jnp.asarray(ds.val.user[:LATENCY_BATCH]),
        "item": jnp.asarray(ds.val.item[:LATENCY_BATCH]),
        "slot": jnp.asarray(ds.val.slot[:LATENCY_BATCH]),
        "neg": jnp.asarray(ds.val.neg[:LATENCY_BATCH]),
    }
    scores = eval_step(state.params, graph, ev_batch)
    np.asarray(scores)                         # readback = real completion
    block_medians = []
    for _block in range(3):
        lat = []
        for _ in range(LATENCY_ITERS):
            t2 = time.time()
            scores = eval_step(state.params, graph, ev_batch)
            np.asarray(scores)
            lat.append(time.time() - t2)
        block_medians.append(float(np.median(lat) * 1e3))
        time.sleep(2.0)    # let a transient host-load burst pass
    p50_ms = min(block_medians)

    n_chips = len(_devices_of(state.params))    # devices the step ran on
    value = examples_per_s / n_chips
    print(json.dumps({
        "metric": "train_examples_per_s_per_chip",
        "value": round(value, 1),
        "unit": "examples/s/chip",
        "extra": {
            "p50_scoring_latency_ms": round(p50_ms, 2),
            "eval_targets_per_s": round(eval_targets_per_s, 1),
            "val_auc_probe": round(ev["auc"], 4),
            "step_ms": round(step_s * 1e3, 2),
            "final_loss": round(final_loss, 4),
            "batch": BATCH,
            "chips": n_chips,
            "model": "configs3-coattn",
            "compute_dtype": COMPUTE_DTYPE,
            "table_stride": TABLE_STRIDE,
            "table_lr_boost": TABLE_LR_BOOST,
            "backend": jax.default_backend(),
            "device_kind": dev.device_kind,
            "prep_s": round(prep_s, 1),
            # per-phase attribution, so a slow prep shows where it went
            "prep_phase_s": ds.meta.get("prep_phase_s", {}),
        },
    }))


if __name__ == "__main__":
    main()
