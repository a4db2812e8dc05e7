"""Golden integration run (SURVEY.md §4.2): configs0 on a fixed-seed tiny
dataset — loss decreases, val AUC above a recorded floor. Fast enough for
every commit."""

import jax
import jax.numpy as jnp
import numpy as np

from score_tpu.config import configs0
from score_tpu.data import synth
from score_tpu.data.prep_common import build_dataset
from score_tpu.graph import device_graph
from score_tpu.train import (build_model, evaluate, init_state,
                             make_eval_step, make_train_step, train)

# Golden floor, recorded from the first green run of this test (M0). A
# regression below this means the model/pipeline lost real signal - the
# synthetic generator is latent-factor + drift, AUC well above chance is
# learnable (chance = 0.5).
GOLDEN_VAL_AUC_FLOOR = 0.60


def _golden_ds():
    user, item, ts = synth.synth_events(400, 800, 40000, num_slots=8, seed=42)
    return build_dataset(user, item, ts, num_slots=8, user_fanout=6,
                         item_fanout=6, num_eval_neg=20, min_user=3,
                         min_item=3, seed=42, dataset_name="golden-ccmr")


def test_golden_configs0_run():
    ds = _golden_ds()
    cfg = configs0()
    cfg = cfg.replace(train=cfg.train.__class__(
        batch_size=128, learning_rate=1e-2, num_epochs=2,
        eval_every_steps=100, early_stop_patience=10, seed=0,
        log_every_steps=10 ** 9))
    out = train(cfg, ds, verbose=False)
    assert out["best_val_auc"] > GOLDEN_VAL_AUC_FLOOR, out["best_val_auc"]
    assert out["test"]["auc"] > GOLDEN_VAL_AUC_FLOOR - 0.05, out["test"]
    # loss at the last eval must sit below the BCE chance level
    assert out["history"][-1]["loss"] < 0.69


def test_train_step_decreases_loss():
    ds = _golden_ds()
    cfg = configs0()
    g = device_graph(ds.graph)
    model = build_model(cfg, ds.num_users, ds.num_items)
    rng = jax.random.PRNGKey(0)
    state = init_state(cfg, model, g, rng)
    step = make_train_step(model, cfg)
    batch = {k: jnp.asarray(v) for k, v in dict(
        user=ds.train.user[:256], item=ds.train.item[:256],
        slot=ds.train.slot[:256]).items()}
    losses = []
    for _ in range(30):
        state, m = step(state, g, batch, rng)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.01, (losses[0], losses[-1])


def test_dropout_trains_and_eval_is_deterministic():
    """dropout > 0: train steps run (stochastic regularization active via the
    rngs plumbing) while eval/forward stays deterministic (no dropout rng)."""
    import dataclasses
    ds = _golden_ds()
    cfg = configs0()
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, dropout=0.5))
    g = device_graph(ds.graph)
    model = build_model(cfg, ds.num_users, ds.num_items)
    rng = jax.random.PRNGKey(0)
    state = init_state(cfg, model, g, rng)
    step = make_train_step(model, cfg)
    batch = {k: jnp.asarray(v) for k, v in dict(
        user=ds.train.user[:256], item=ds.train.item[:256],
        slot=ds.train.slot[:256]).items()}
    for _ in range(3):
        state, m = step(state, g, batch, rng)
        assert np.isfinite(float(m["loss"]))
    from score_tpu.graph import gather_batch
    mb = gather_batch(g, batch["user"], batch["item"], batch["slot"])
    o1 = model.apply(state.params, mb)
    o2 = model.apply(state.params, mb)
    np.testing.assert_array_equal(np.asarray(o1), np.asarray(o2))


def test_train_loop_matches_sequential_steps():
    """K steps via the fused lax.scan loop == K sequential jitted steps."""
    from score_tpu.train import _stack_batches, make_train_loop
    from score_tpu.data.pipeline import TargetIterator

    ds = _golden_ds()
    cfg = configs0()
    g = device_graph(ds.graph)
    model = build_model(cfg, ds.num_users, ds.num_items)
    rng = jax.random.PRNGKey(0)

    state_a = init_state(cfg, model, g, rng)
    state_b = init_state(cfg, model, g, rng)
    step = make_train_step(model, cfg)
    loop = make_train_loop(model, cfg)

    K, B = 4, 64
    it = TargetIterator(ds.train, B, seed=3)
    batches = [next(it) for _ in range(K)]
    for b in batches:
        state_a, m_a = step(state_a, g,
                            {k: jnp.asarray(v) for k, v in b.items()}, rng)
    it2 = TargetIterator(ds.train, B, seed=3)
    stacked = _stack_batches(it2, K)
    state_b, m_b = loop(state_b, g, stacked, rng)

    np.testing.assert_allclose(float(m_a["loss"]),
                               float(m_b["loss"][-1]), rtol=1e-5)
    for a, b in zip(jax.tree_util.tree_leaves(state_a.params),
                    jax.tree_util.tree_leaves(state_b.params)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-5, atol=1e-6)


def test_table_update_stride_semantics():
    """Stride-K table updates (TrainConfig.table_update_every
    #3): tables (params AND adam moments) change exactly on steps with
    step % K == 0 and are bit-unchanged otherwise; dense params change every
    step; the update-step table math matches the K=1 step exactly (the
    cond's full branch IS the reference step)."""
    import dataclasses

    from score_tpu.config import configs3

    ds = _golden_ds()
    cfg = configs3()
    cfg = cfg.replace(train=dataclasses.replace(
        cfg.train, table_update_every=2))
    g = device_graph(ds.graph)
    model = build_model(cfg, ds.num_users, ds.num_items)
    rng = jax.random.PRNGKey(0)
    state = init_state(cfg, model, g, rng)
    step = make_train_step(model, cfg)
    batch = {k: jnp.asarray(v) for k, v in dict(
        user=ds.train.user[:64], item=ds.train.item[:64],
        slot=ds.train.slot[:64]).items()}

    def tables_of(tree):
        return {jax.tree_util.keystr(p): np.asarray(v).copy()
                for p, v in jax.tree_util.tree_leaves_with_path(tree)
                if "table" in jax.tree_util.keystr(p)}

    def dense_of(tree):
        return {jax.tree_util.keystr(p): np.asarray(v).copy()
                for p, v in jax.tree_util.tree_leaves_with_path(tree)
                if "table" not in jax.tree_util.keystr(p)}

    for i in range(4):
        prev_t = tables_of(state.params)
        prev_to = tables_of(state.opt_state)
        prev_d = dense_of(state.params)
        is_update = int(state.step) % 2 == 0
        state, m = step(state, g, batch, rng)
        assert np.isfinite(float(m["loss"]))
        cur_t = tables_of(state.params)
        cur_to = tables_of(state.opt_state)
        changed = any(not np.array_equal(prev_t[k2], cur_t[k2])
                      for k2 in prev_t)
        changed_mom = any(not np.array_equal(prev_to[k2], cur_to[k2])
                          for k2 in prev_to)
        assert changed == is_update, (i, is_update)
        assert changed_mom == is_update, (i, is_update)
        if not is_update:       # bit-unchanged, not merely close
            for k2 in prev_t:
                np.testing.assert_array_equal(prev_t[k2], cur_t[k2])
        cur_d = dense_of(state.params)
        assert any(not np.array_equal(prev_d[k2], cur_d[k2])
                   for k2 in prev_d), i

    # the update-step table math IS the reference step: step 0 of a K=2 run
    # equals step 0 of a K=1 run bit-for-bit
    cfg1 = cfg.replace(train=dataclasses.replace(
        cfg.train, table_update_every=1))
    s2 = init_state(cfg, model, g, rng)
    s1 = init_state(cfg1, model, g, rng)
    s2, _ = make_train_step(model, cfg)(s2, g, batch, rng)
    s1, _ = make_train_step(model, cfg1)(s1, g, batch, rng)
    for a, b in zip(jax.tree_util.tree_leaves(s1.params),
                    jax.tree_util.tree_leaves(s2.params)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-6, atol=1e-7)


def test_table_lr_boost_scales_table_updates_only():
    """TrainConfig.table_lr_boost=b: the table-param update is exactly b x
    the unboosted update; dense params are untouched by the mask."""
    import dataclasses

    from score_tpu.config import configs3

    ds = _golden_ds()
    cfg1 = configs3()
    cfg2 = cfg1.replace(train=dataclasses.replace(
        cfg1.train, table_lr_boost=2.0))
    g = device_graph(ds.graph)
    model = build_model(cfg1, ds.num_users, ds.num_items)
    rng = jax.random.PRNGKey(0)
    batch = {k: jnp.asarray(v) for k, v in dict(
        user=ds.train.user[:64], item=ds.train.item[:64],
        slot=ds.train.slot[:64]).items()}
    outs = {}
    for name, cfg in (("base", cfg1), ("boost", cfg2)):
        state = init_state(cfg, model, g, rng)
        params0 = jax.device_get(state.params)
        state, _ = make_train_step(model, cfg)(state, g, batch, rng)
        outs[name] = (params0, jax.device_get(state.params))
    for (p, v0), (_, v1), (_, w0), (_, w1) in zip(
            jax.tree_util.tree_leaves_with_path(outs["base"][0]),
            jax.tree_util.tree_leaves_with_path(outs["base"][1]),
            jax.tree_util.tree_leaves_with_path(outs["boost"][0]),
            jax.tree_util.tree_leaves_with_path(outs["boost"][1])):
        du = v1 - v0                     # unboosted update
        db = w1 - w0                     # boosted update
        if "table" in jax.tree_util.keystr(p):
            np.testing.assert_allclose(db, 2.0 * du, rtol=1e-5, atol=1e-7)
        else:
            np.testing.assert_allclose(db, du, rtol=1e-6, atol=1e-8)


def test_table_update_stride_loop_matches_steps():
    """The fused lax.scan loop preserves stride-K semantics (cond inside
    scan): loop over 4 batches == 4 sequential steps, K=2."""
    import dataclasses

    from score_tpu.config import configs3
    from score_tpu.data.pipeline import TargetIterator
    from score_tpu.train import _stack_batches, make_train_loop

    ds = _golden_ds()
    cfg = configs3()
    cfg = cfg.replace(train=dataclasses.replace(
        cfg.train, table_update_every=2))
    g = device_graph(ds.graph)
    model = build_model(cfg, ds.num_users, ds.num_items)
    rng = jax.random.PRNGKey(0)
    state_a = init_state(cfg, model, g, rng)
    state_b = init_state(cfg, model, g, rng)
    step = make_train_step(model, cfg)
    loop = make_train_loop(model, cfg)
    K, B = 4, 64
    it = TargetIterator(ds.train, B, seed=3)
    batches = [next(it) for _ in range(K)]
    for b in batches:
        state_a, m_a = step(state_a, g,
                            {k: jnp.asarray(v) for k, v in b.items()}, rng)
    it2 = TargetIterator(ds.train, B, seed=3)
    state_b, m_b = loop(state_b, g, _stack_batches(it2, K), rng)
    np.testing.assert_allclose(float(m_a["loss"]),
                               float(m_b["loss"][-1]), rtol=1e-5)
    for a, b in zip(jax.tree_util.tree_leaves(state_a.params),
                    jax.tree_util.tree_leaves(state_b.params)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-5, atol=1e-6)


def test_table_update_stride_loop_phase_alignment():
    """The static-alternation stride loop with phase = entry_step % K
    (lead-in + groups + tail, odd chunk length) == sequential jitted steps
    from the same mid-stride state."""
    import dataclasses

    from score_tpu.config import configs3
    from score_tpu.data.pipeline import TargetIterator
    from score_tpu.train import _stack_batches, make_train_loop

    ds = _golden_ds()
    cfg = configs3()
    cfg = cfg.replace(train=dataclasses.replace(
        cfg.train, table_update_every=2))
    g = device_graph(ds.graph)
    model = build_model(cfg, ds.num_users, ds.num_items)
    rng = jax.random.PRNGKey(0)
    step = make_train_step(model, cfg)
    loop = make_train_loop(model, cfg)
    B = 64
    it = TargetIterator(ds.train, B, seed=3)
    batches = [next(it) for _ in range(6)]
    # sequential reference: 1 step, then 5 more
    state_a = init_state(cfg, model, g, rng)
    for b in batches:
        state_a, m_a = step(state_a, g,
                            {k: jnp.asarray(v) for k, v in b.items()}, rng)
    # loop path: 1 sequential step (entering step becomes 1), then a
    # 5-batch chunk with phase=1 (lead-in 1 dense + 2 groups + 0 tail)
    state_b = init_state(cfg, model, g, rng)
    state_b, _ = step(state_b, g,
                      {k: jnp.asarray(v) for k, v in batches[0].items()},
                      rng)
    it2 = TargetIterator(ds.train, B, seed=3)
    next(it2)                                   # consume batch 0
    stacked = _stack_batches(it2, 5)
    state_b, m_b = loop(state_b, g, stacked, rng, 1)
    np.testing.assert_allclose(float(m_a["loss"]),
                               float(m_b["loss"][-1]), rtol=1e-5)
    for a, b in zip(jax.tree_util.tree_leaves(state_a.params),
                    jax.tree_util.tree_leaves(state_b.params)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-5, atol=1e-6)


def test_inbatch_negatives_train_step():
    """train_neg_mode='inbatch' learns (loss falls well below BCE chance)
    and its collision weighting keeps the loss finite on duplicate items."""
    import dataclasses

    from score_tpu.config import configs3

    ds = _golden_ds()
    cfg = configs3()
    cfg = cfg.replace(data=dataclasses.replace(
        cfg.data, train_neg_mode="inbatch", num_train_neg=2))
    g = device_graph(ds.graph)
    model = build_model(cfg, ds.num_users, ds.num_items)
    rng = jax.random.PRNGKey(0)
    state = init_state(cfg, model, g, rng)
    step = make_train_step(model, cfg)
    batch = {k: jnp.asarray(v) for k, v in dict(
        user=ds.train.user[:256], item=ds.train.item[:256],
        slot=ds.train.slot[:256]).items()}
    losses = []
    for _ in range(30):
        state, m = step(state, g, batch, rng)
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all(), losses
    assert losses[-1] < losses[0] - 0.01, (losses[0], losses[-1])


def test_inbatch_iw_weights_and_step():
    """'inbatch_iw': importance weights satisfy E_q[w] = 1 over the train
    popularity distribution, and the weighted step learns."""
    import dataclasses

    from score_tpu.config import configs3
    from score_tpu.train import item_importance_weights

    ds = _golden_ds()
    iw = item_importance_weights(ds.train, ds.num_items)
    assert iw.shape == (ds.num_items + 1,)
    cnt = np.bincount(np.asarray(ds.train.item), minlength=ds.num_items + 1)
    # E_{j~q}[w_j] = sum_j (cnt_j/E) * E/(N*cnt_j) = (#items with cnt>0)/N
    e_q = float(np.sum(cnt * iw.astype(np.float64)) / ds.train.item.size)
    np.testing.assert_allclose(e_q, (cnt > 0).sum() / ds.num_items, rtol=1e-6)

    cfg = configs3()
    cfg = cfg.replace(data=dataclasses.replace(
        cfg.data, train_neg_mode="inbatch_iw", num_train_neg=2))
    g = device_graph(ds.graph)
    model = build_model(cfg, ds.num_users, ds.num_items)
    rng = jax.random.PRNGKey(0)
    state = init_state(cfg, model, g, rng)
    step = make_train_step(model, cfg, neg_iw=jnp.asarray(iw))
    batch = {k: jnp.asarray(v) for k, v in dict(
        user=ds.train.user[:256], item=ds.train.item[:256],
        slot=ds.train.slot[:256]).items()}
    losses = []
    for _ in range(30):
        state, m = step(state, g, batch, rng)
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all(), losses
    assert losses[-1] < losses[0] - 0.01, (losses[0], losses[-1])


def test_eval_step_shapes():
    ds = _golden_ds()
    cfg = configs0()
    g = device_graph(ds.graph)
    model = build_model(cfg, ds.num_users, ds.num_items)
    state = init_state(cfg, model, g, jax.random.PRNGKey(0))
    ev = make_eval_step(model)
    res = evaluate(ev, state.params, g, ds.val, batch_size=64)
    for k in ("auc", "ndcg@10", "hr@10", "hr@1", "mrr"):
        assert k in res
        assert 0.0 <= res[k] <= 1.0
    # untrained model ranks near chance
    assert 0.3 < res["auc"] < 0.7


def test_eval_table_cast_matches_f32_eval():
    """eval_table_cast (the serving bf16 table-gather fix applied to the
    eval path, round 5): evaluating with pre-cast bf16 tables must agree
    with the f32-table path to bf16 resolution — the model already casts
    gathered rows to the compute dtype, so cast-then-gather commutes with
    gather-then-cast. Also: f32 compute dtype must be an exact no-op."""
    import dataclasses

    from score_tpu.train import eval_table_cast
    ds = _golden_ds()
    cfg = configs0()
    cfg = cfg.replace(model=dataclasses.replace(
        cfg.model, compute_dtype="bfloat16"))
    g = device_graph(ds.graph)
    model = build_model(cfg, ds.num_users, ds.num_items)
    state = init_state(cfg, model, g, jax.random.PRNGKey(0))
    ev = make_eval_step(model)
    base = evaluate(ev, state.params, g, ds.val, batch_size=64)
    cast = eval_table_cast(state.params, cfg.model.compute_dtype)
    import jax.numpy as jnp
    tkey = next(iter(state.params["tables"]))   # 'table' (shared, configs0)
    assert cast["tables"][tkey].dtype == jnp.bfloat16
    got = evaluate(ev, cast, g, ds.val, batch_size=64)
    for k in base:
        assert abs(got[k] - base[k]) < 2e-3, (k, got[k], base[k])
    # f32 compute: identity (no accidental cast of master weights)
    same = eval_table_cast(state.params, "float32")
    assert same["tables"][tkey] is state.params["tables"][tkey]


def test_streaming_evaluate_matches_in_memory_oracle():
    """The streamed evaluate (rank sums + f16-bucket AUC histograms)
    reproduces the in-memory formulation — score
    the whole split in one shot, run ranking_metrics + pooled auc — on a
    real model over a real split, with a ragged tail (batch_size 64 over
    a non-multiple split size).

    AUC tolerance is f16 tie granularity (pinned ~1e-5 scale in
    test_metrics); ranking metrics must agree to float tolerance."""
    import jax.numpy as jnp

    from score_tpu.data.pipeline import eval_index_batches
    from score_tpu.metrics import auc as auc_fn
    from score_tpu.metrics import ranking_metrics
    ds = _golden_ds()
    cfg = configs0()
    g = device_graph(ds.graph)
    model = build_model(cfg, ds.num_users, ds.num_items)
    state = init_state(cfg, model, g, jax.random.PRNGKey(0))
    ev = make_eval_step(model)
    got = evaluate(ev, state.params, g, ds.val, batch_size=64)

    n = len(ds.val)
    pos_l, neg_l, w_l = [], [], []
    for idx, w in eval_index_batches(n, 64):
        batch = dict(user=jnp.asarray(ds.val.user[idx]),
                     item=jnp.asarray(ds.val.item[idx]),
                     slot=jnp.asarray(ds.val.slot[idx]),
                     neg=jnp.asarray(ds.val.neg[idx]))
        s = np.asarray(ev(state.params, g, batch), np.float32)
        pos_l.append(s[:, 0])
        neg_l.append(s[:, 1:])
        w_l.append(w)
    pos = np.concatenate(pos_l)
    neg = np.concatenate(neg_l)
    w = np.concatenate(w_l)
    want = {k: float(v) for k, v in ranking_metrics(
        jnp.asarray(pos), jnp.asarray(neg), ks=(1, 5, 10),
        weights=jnp.asarray(w)).items()}
    pooled = np.concatenate([pos, neg.reshape(-1)])
    labels = np.concatenate(
        [np.ones(pos.size), np.zeros(neg.size)]).astype(np.float32)
    pooled_w = np.concatenate([w, np.repeat(w, neg.shape[1])])
    want["auc"] = float(auc_fn(jnp.asarray(pooled), jnp.asarray(labels),
                               jnp.asarray(pooled_w)))
    assert set(got) == set(want)
    for k in want:
        tol = 5e-4 if k == "auc" else 1e-5
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=tol,
                                   err_msg=k)


def test_optimizer_and_schedule_choices():
    """Every optimizer/schedule combo builds, steps, and decreases loss."""
    import dataclasses
    ds = _golden_ds()
    g = device_graph(ds.graph)
    batch = {k: jnp.asarray(v) for k, v in dict(
        user=ds.train.user[:256], item=ds.train.item[:256],
        slot=ds.train.slot[:256]).items()}
    combos = [dict(optimizer="adagrad"),
              dict(optimizer="sgd", learning_rate=0.5),
              dict(optimizer="adamw", weight_decay=1e-4),
              dict(optimizer="adam", lr_schedule="cosine", decay_steps=100,
                   warmup_steps=5)]
    for kw in combos:
        cfg = configs0()
        cfg = cfg.replace(train=dataclasses.replace(cfg.train, **kw))
        model = build_model(cfg, ds.num_users, ds.num_items)
        state = init_state(cfg, model, g, jax.random.PRNGKey(0),
                           steps_per_epoch=50)
        step = make_train_step(model, cfg)
        losses = []
        for _ in range(15):
            state, m = step(state, g, batch, jax.random.PRNGKey(0))
            losses.append(float(m["loss"]))
        assert np.isfinite(losses).all(), kw
        assert losses[-1] < losses[0], (kw, losses[0], losses[-1])


def test_warmup_schedule_starts_small():
    """With warmup, the first update must be ~zero-sized (lr starts at 0)."""
    import dataclasses
    ds = _golden_ds()
    g = device_graph(ds.graph)
    cfg = configs0()
    cfg = cfg.replace(train=dataclasses.replace(
        cfg.train, lr_schedule="cosine", warmup_steps=100, decay_steps=200))
    model = build_model(cfg, ds.num_users, ds.num_items)
    state = init_state(cfg, model, g, jax.random.PRNGKey(0),
                       steps_per_epoch=50)
    before = jax.tree_util.tree_leaves(state.params)[0].copy()
    batch = {k: jnp.asarray(v) for k, v in dict(
        user=ds.train.user[:64], item=ds.train.item[:64],
        slot=ds.train.slot[:64]).items()}
    step = make_train_step(model, cfg)
    state, _ = step(state, g, batch, jax.random.PRNGKey(0))
    after = jax.tree_util.tree_leaves(state.params)[0]
    # step 0 of a 0-init linear warmup: lr == 0 -> params unchanged
    np.testing.assert_allclose(np.asarray(before), np.asarray(after),
                               atol=1e-7)


def test_subsample_neighbors_uniform_and_exact():
    """graph.subsample_neighbors: (a) keeps all valid entries when cnt <= k,
    (b) draws a uniform without-replacement k-subset when cnt > k, (c) new
    counts clamp to k."""
    from score_tpu.graph import subsample_neighbors

    hist = jnp.asarray(np.arange(1, 13).reshape(1, 12).astype(np.int32))
    # cnt < k: all 3 valid ids survive, in some order
    cnt = jnp.asarray([3], np.int32)
    h2, c2 = subsample_neighbors(hist, cnt, 8, jax.random.PRNGKey(0))
    assert h2.shape == (1, 8) and int(c2[0]) == 3
    assert set(np.asarray(h2[0, :3]).tolist()) == {1, 2, 3}
    # cnt > k: each valid id appears with ~uniform frequency over draws
    cnt = jnp.asarray([12], np.int32)
    counts = np.zeros(13)
    draws = 400
    for s in range(draws):
        h3, c3 = subsample_neighbors(hist, cnt, 4, jax.random.PRNGKey(s))
        assert int(c3[0]) == 4
        sel = np.asarray(h3[0])
        assert len(set(sel.tolist())) == 4      # no replacement
        counts[sel] += 1
    freq = counts[1:] / draws
    np.testing.assert_allclose(freq, 4 / 12, atol=0.08)


def test_neighbor_resample_train_step_runs(tiny_dataset):
    """Train step with per-step neighbor re-sampling: model fan-out smaller
    than the stored fan-out, loss stays finite."""
    from score_tpu.config import configs3
    from score_tpu.train import make_train_step

    cfg = configs3()
    cfg = cfg.replace(data=cfg.data.__class__(
        user_fanout=3, item_fanout=3, neighbor_resample=True))
    g = device_graph(tiny_dataset.graph)     # stores fanout 6 (conftest)
    model = build_model(cfg, tiny_dataset.num_users, tiny_dataset.num_items)
    state = init_state(cfg, model, g, jax.random.PRNGKey(0))
    B = 8
    batch = {
        "user": jnp.asarray(tiny_dataset.train.user[:B]),
        "item": jnp.asarray(tiny_dataset.train.item[:B]),
        "slot": jnp.asarray(tiny_dataset.train.slot[:B]),
    }
    state, m = make_train_step(model, cfg)(state, g, batch,
                                           jax.random.PRNGKey(0))
    assert np.isfinite(float(m["loss"]))
