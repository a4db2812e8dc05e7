"""Ranked-eval throughput experiment: candidates-form vs flat-form forward
at eval candidate counts (C = 1+num_eval_neg), plus batch-size scaling.

Motivation: bench.py measured ~87 targets/s at C=101 while training moves
~92k users/s at C=2 — ~20x worse per candidate-scoring, suggesting the
C-axis einsums lower badly at large C (the code already unrolls C<=8 for
exactly that reason). This pins down where eval time goes.

Usage: python scripts/eval_perf.py
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

sys.path.insert(0, ".")

NUM_USERS = 50_000
NUM_ITEMS = 100_000
NUM_EVENTS = 2_000_000
NUM_SLOTS = 9
FANOUT = 10
EMBED_DIM = 32


def main():
    import jax
    import jax.numpy as jnp

    from score_tpu.config import configs3
    from score_tpu.data import synth
    from score_tpu.data.prep_common import build_dataset
    from score_tpu.graph import device_graph, gather_batch, \
        gather_candidate_batch
    from score_tpu.train import build_model, init_state

    user, item, ts = synth.synth_events(
        NUM_USERS, NUM_ITEMS, NUM_EVENTS, num_slots=NUM_SLOTS, seed=0)
    ds = build_dataset(user, item, ts, num_slots=NUM_SLOTS,
                       user_fanout=FANOUT, item_fanout=FANOUT,
                       num_eval_neg=100, min_user=3, min_item=3, seed=0,
                       dataset_name="evalperf")
    graph = device_graph(ds.graph)
    cfg = configs3()
    cfg = cfg.replace(model=cfg.model.__class__(
        embed_dim=EMBED_DIM, hidden_dim=64, mlp_dims=(128, 64),
        sides="dual", slot_agg="coattn", seq_pool="attn", target_aware=True,
        compute_dtype="bfloat16"))
    model = build_model(cfg, ds.num_users, ds.num_items)
    state = init_state(cfg, model, graph, jax.random.PRNGKey(0))
    params = state.params

    @jax.jit
    def cand_form(params, users, cand, slots):
        mb = gather_candidate_batch(graph, users, cand, slots)
        return model.score_candidates(params, mb)

    @jax.jit
    def flat_form(params, users, cand, slots):
        B, C = cand.shape
        uf = jnp.repeat(users, C)
        sf = jnp.repeat(slots, C)
        mb = gather_batch(graph, uf, cand.reshape(-1), sf)
        return model.apply(params, mb).reshape(B, C)

    rng = np.random.default_rng(0)

    def bench(fn, B, C, iters=8):
        users = jnp.asarray(ds.val.user[:B])
        slots = jnp.asarray(ds.val.slot[:B])
        cand = jnp.asarray(
            rng.integers(1, ds.num_items + 1, size=(B, C), dtype=np.int32))
        out = fn(params, users, cand, slots)
        np.asarray(out)                      # compile + honest completion
        t0 = time.time()
        for _ in range(iters):
            out = fn(params, users, cand, slots)
            np.asarray(out)
        dt = (time.time() - t0) / iters
        return dict(batch=B, C=C, ms=round(1000 * dt, 2),
                    targets_per_s=round(B / dt, 1),
                    cand_per_s=round(B * C / dt))

    for B, C in ((512, 101), (128, 101), (2048, 101), (512, 25), (4096, 2)):
        print(json.dumps(dict(form="candidates", **bench(cand_form, B, C))),
              flush=True)
    for B, C in ((512, 101), (128, 101)):
        print(json.dumps(dict(form="flat", **bench(flat_form, B, C))),
              flush=True)


if __name__ == "__main__":
    main()
