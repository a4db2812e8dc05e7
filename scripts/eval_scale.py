"""Reference-scale evaluation run.

Builds the pinned 1e8-event synthetic dataset (same knobs as
scripts/prep_bench.py: 1e6 users, 4e6 items -> ~2.68M kept, ~10.6M val
targets x 100 eval negatives), trains the bench configs3 step briefly so
metrics are non-degenerate, then runs the FULL val split through the
streaming `train.evaluate` on the chip and pins wall time + metrics.

What this proves: the split is never device-resident (the old evaluate
shipped ~4.3 GB of negatives and sorted a ~2.1e9-element pooled score
vector — impossible on one device); the streaming path's device residency is
{graph, tables, one block, the O(1) carry} and the pooled AUC comes from
the two 65536-bin histograms (metrics.py module docstring).

Usage:
  python scripts/eval_scale.py [events=100000000] [train_steps=400]
      [eval_batch=2048] [out=chiprun_out/eval_scale.json]
"""

import json
import sys
import time

sys.path.insert(0, ".")

import numpy as np

from prep_bench import synth_uniform_zipf  # scripts/ on sys.path when run


def main():
    kw = dict(events=100_000_000, users=1_000_000, items=4_000_000, slots=9,
              train_steps=400, eval_batch=2048, cpu=0,
              out="chiprun_out/eval_scale.json")
    for a in sys.argv[1:]:
        k, v = a.split("=", 1)
        kw[k] = type(kw[k])(v)

    import jax
    if kw["cpu"]:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from score_tpu.config import configs3
    from score_tpu.data.pipeline import TargetIterator
    from score_tpu.data.prep_common import build_dataset
    from score_tpu.graph import device_graph
    from score_tpu.train import (_stack_batches, build_model, evaluate,
                                 init_state, item_importance_weights,
                                 make_eval_step, make_train_loop)

    res = dict(events=kw["events"], backend=jax.default_backend())

    t0 = time.time()
    user, item, ts = synth_uniform_zipf(kw["events"], kw["users"],
                                        kw["items"], kw["slots"])
    ds = build_dataset(user, item, ts, num_slots=kw["slots"], user_fanout=10,
                      item_fanout=10, num_eval_neg=100, min_user=5,
                      min_item=5, seed=0, dataset_name="evalscale")
    del user, item, ts
    res["prep_s"] = round(time.time() - t0, 1)
    res["prep_phase_s"] = ds.meta.get("prep_phase_s", {})
    res["num_users"] = ds.num_users
    res["num_items"] = ds.num_items
    res["val_targets"] = len(ds.val)
    print(f"prep {res['prep_s']}s: {ds.num_users:,} users "
          f"{ds.num_items:,} items {len(ds.val):,} val targets", flush=True)

    # the bench model (configs3 bf16 d=32), trained briefly at the bench step
    import dataclasses
    cfg = configs3()
    cfg = cfg.replace(
        model=dataclasses.replace(cfg.model, embed_dim=32, hidden_dim=64,
                                  mlp_dims=(128, 64),
                                  compute_dtype="bfloat16"),
        data=dataclasses.replace(cfg.data, train_neg_mode="inbatch_iw"),
        train=dataclasses.replace(cfg.train, batch_size=4096,
                                  table_update_every=2, table_lr_boost=2.0))
    graph = device_graph(ds.graph)
    model = build_model(cfg, ds.num_users, ds.num_items)
    state = init_state(cfg, model, graph, jax.random.PRNGKey(0))
    neg_iw = jnp.asarray(item_importance_weights(ds.train, ds.num_items))
    loop = make_train_loop(model, cfg, neg_iw=neg_iw)
    it = TargetIterator(ds.train, 4096, seed=0)
    t0 = time.time()
    rng = jax.random.PRNGKey(0)
    steps = 0
    while steps < kw["train_steps"]:
        state, ms = loop(state, graph, _stack_batches(it, 50), rng)
        steps += 50
    final_loss = float(ms["loss"][-1])
    res["train_steps"] = steps
    res["train_s"] = round(time.time() - t0, 1)
    print(f"trained {steps} steps in {res['train_s']}s "
          f"(loss {final_loss:.4f})", flush=True)

    # free the adam moments before the eval (tables are the big leaves)
    params = state.params
    del state, loop, it

    eval_step = make_eval_step(model)
    B = kw["eval_batch"]
    # warmup: compile the block + accum graphs on a small slice first so the
    # timed full pass is pure streaming
    t0 = time.time()
    from score_tpu.train import eval_table_cast
    params = eval_table_cast(params, cfg.model.compute_dtype)
    evaluate(eval_step, params, graph, ds.val, batch_size=B, max_targets=B)
    res["eval_compile_s"] = round(time.time() - t0, 1)
    t0 = time.time()
    out = evaluate(eval_step, params, graph, ds.val, batch_size=B)
    res["eval_wall_s"] = round(time.time() - t0, 1)
    res["eval_metrics"] = {k: round(v, 4) for k, v in out.items()}
    res["eval_targets_per_s"] = round(len(ds.val) / res["eval_wall_s"], 1)
    res["eval_cand_scores_per_s"] = round(
        len(ds.val) * 101 / res["eval_wall_s"], 1)
    res["eval_batch"] = B
    # residency statement (device bytes by construction, for the record)
    T, n, m, d = ds.graph.num_slots, 10, 10, 32
    res["residency_bytes"] = dict(
        graph=int(sum(a.nbytes for a in (ds.graph.u2i, ds.graph.i2u,
                                         ds.graph.u2i_cnt,
                                         ds.graph.i2u_cnt))),
        tables=int((ds.num_users + ds.num_items + 2) * d * 4),
        block_item_side_bf16=int(B * 101 * T * m * d * 2),
        carry=int(2 * 65536 * 4),
        never_resident_negs=int(len(ds.val) * 100 * 4),
        never_materialized_pooled_scores=int(len(ds.val) * 101 * 4))
    print(json.dumps(res), flush=True)
    with open(kw["out"], "w") as f:
        json.dump(res, f, indent=2)
    print(f"wrote {kw['out']}", flush=True)


if __name__ == "__main__":
    main()
