"""Sharding tests without a cluster (SURVEY.md §4.2): 8 fake CPU devices.

Gates for configs4: row-sharded lookups must be bit-identical to a
single-device gather (forward AND gradient), and N-way data-parallel
training must match single-device training on the concatenated batch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from score_tpu.sharding import (a2a_lookup, batch_sharding, factor_mesh,
                                make_mesh, pad_rows, psum_lookup, shard_graph,
                                shard_state, state_spec)

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 fake devices")


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(jax.devices()[:8])


def test_factor_mesh():
    assert factor_mesh(1) == (1, 1)
    assert factor_mesh(8) == (2, 4)
    assert factor_mesh(4) == (2, 2)
    assert factor_mesh(6) == (2, 3)


@pytest.mark.parametrize("lookup", [psum_lookup, a2a_lookup])
@pytest.mark.parametrize("n_ids", [16, 40, 18])
def test_sharded_lookup_matches_local(mesh, rng, lookup, n_ids):
    V, d = 64, 16
    table = jnp.asarray(rng.normal(size=(V, d)).astype(np.float32))
    ids = jnp.asarray(rng.integers(0, V, size=(n_ids,)).astype(np.int32))
    got = lookup(mesh, table, ids)
    want = jnp.take(table, ids, axis=0)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("lookup", [psum_lookup, a2a_lookup])
def test_sharded_lookup_grads(mesh, rng, lookup):
    V, d = 64, 8
    table = jnp.asarray(rng.normal(size=(V, d)).astype(np.float32))
    ids = jnp.asarray(rng.integers(0, V, size=(24,)).astype(np.int32))
    w = jnp.asarray(rng.normal(size=(24, d)).astype(np.float32))

    def loss(t):
        return jnp.sum(lookup(mesh, t, ids) * w)

    g = jax.grad(loss)(table)
    want = np.zeros((V, d), np.float32)
    np.add.at(want, np.asarray(ids), np.asarray(w))
    np.testing.assert_allclose(np.asarray(g), want, rtol=1e-6, atol=1e-6)


def _a2a_exchange_bytes(mesh, table, ids, cap: int) -> int:
    """Total bytes moved by the all-to-all pair, from the compiled HLO."""
    import functools
    import re
    f = jax.jit(functools.partial(a2a_lookup, mesh, capacity=cap))
    txt = f.lower(table, ids).compile().as_text()
    total = 0
    for line in txt.splitlines():
        if not re.search(r"\) all-to-all\(", line):
            continue
        for _, dims in re.findall(r"(s32|f32)\[([\d,]+)\]", line):
            total += 4 * int(np.prod([int(x) for x in dims.split(",")]))
    assert total > 0, "no all-to-all found in compiled HLO"
    return total


def test_a2a_dedup_capacity_exact_and_shrinks(mesh, rng):
    """With a static unique-id capacity, (a) results stay
    exact whenever capacity >= per-device unique count, and (b) the exchange
    buffers (compiled collective bytes) shrink vs the exact worst case."""
    V, d = 64, 16
    table = jnp.asarray(rng.normal(size=(V, d)).astype(np.float32))
    # 256 ids over only 5 distinct values: <=5 uniques per device
    ids = jnp.asarray((rng.integers(0, 5, size=(256,)) * 7 + 1
                       ).astype(np.int32))
    got = a2a_lookup(mesh, table, ids, capacity=8)
    want = jnp.take(table, ids, axis=0)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    full = _a2a_exchange_bytes(mesh, table, ids, 0)
    capped = _a2a_exchange_bytes(mesh, table, ids, 8)
    assert capped < full, (capped, full)


def test_a2a_dedup_grads_with_duplicates(mesh, rng):
    """Duplicate-heavy grads pre-reduce before the return exchange and land
    on the right rows (capacity-bounded path)."""
    V, d = 64, 8
    table = jnp.asarray(rng.normal(size=(V, d)).astype(np.float32))
    ids = jnp.asarray((rng.integers(0, 6, size=(64,)) * 9 + 2
                       ).astype(np.int32))
    w = jnp.asarray(rng.normal(size=(64, d)).astype(np.float32))

    def loss(t):
        return jnp.sum(a2a_lookup(mesh, t, ids, capacity=8) * w)

    g = jax.grad(loss)(table)
    want = np.zeros((V, d), np.float32)
    np.add.at(want, np.asarray(ids), np.asarray(w))
    np.testing.assert_allclose(np.asarray(g), want, rtol=1e-5, atol=1e-5)


def test_a2a_overflow_detected_not_silent(mesh, rng):
    """SURVEY.md §7.3 item 1 'static capacity with overflow counters':
    when capacity < per-device uniques the lookup
    REPORTS a positive overflow count; when capacity suffices the count is
    zero and the embeddings are bit-identical to the counter-free path."""
    V, d = 64, 16
    table = jnp.asarray(rng.normal(size=(V, d)).astype(np.float32))
    # 256 ids over 5 distinct values -> <=5 uniques per device
    ids = jnp.asarray((rng.integers(0, 5, size=(256,)) * 7 + 1
                       ).astype(np.int32))
    emb, ovf = a2a_lookup(mesh, table, ids, capacity=8, with_overflow=True)
    assert int(ovf) == 0
    np.testing.assert_array_equal(
        np.asarray(emb), np.asarray(a2a_lookup(mesh, table, ids, capacity=8)))
    np.testing.assert_array_equal(
        np.asarray(emb), np.asarray(jnp.take(table, ids, axis=0)))
    # now force overflow: 16 distinct ids with capacity 2 per device
    ids_many = jnp.asarray((rng.permutation(V)[:64]).astype(np.int32))
    _, ovf2 = a2a_lookup(mesh, table, ids_many, capacity=2,
                         with_overflow=True)
    assert int(ovf2) > 0


def test_a2a_overflow_surfaces_in_train_metrics(mesh, tiny_dataset):
    """The train step exposes the sown overflow counter as the
    'a2a_overflow' metric (0 with ample capacity, >0 when the capacity
    truncates uniques)."""
    from score_tpu.config import configs4
    from score_tpu.graph import device_graph
    from score_tpu.sharding import make_lookup_fn
    from score_tpu.train import build_model, init_state, make_train_step

    cfg = configs4()
    g = device_graph(tiny_dataset.graph)
    batch = {
        "user": jnp.asarray(tiny_dataset.train.user[:16]),
        "item": jnp.asarray(tiny_dataset.train.item[:16]),
        "slot": jnp.asarray(tiny_dataset.train.slot[:16]),
    }
    rng = jax.random.PRNGKey(0)
    for cap, expect_overflow in ((0, False), (1, True)):
        model = build_model(cfg, tiny_dataset.num_users,
                            tiny_dataset.num_items,
                            lookup_fn=make_lookup_fn(mesh, "a2a",
                                                     capacity=cap))
        state = init_state(cfg, model, g, rng)
        _, m = make_train_step(model, cfg)(state, g, batch, rng)
        assert "a2a_overflow" in m
        assert (int(m["a2a_overflow"]) > 0) == expect_overflow, (
            cap, int(m["a2a_overflow"]))


def test_a2a_responses_are_data_sharded(mesh, rng):
    """The v2 exchange returns responses sharded over BOTH mesh axes — no
    replicating all_gather."""
    table = jnp.asarray(rng.normal(size=(64, 16)).astype(np.float32))
    ids = jax.device_put(
        jnp.asarray(rng.integers(0, 64, size=(128,)).astype(np.int32)),
        batch_sharding(mesh))
    out = a2a_lookup(mesh, table, ids)
    assert out.sharding.spec == P(("data", "rows"))


def test_pad_rows():
    t = jnp.ones((10, 4))
    p = pad_rows(t, 4)
    assert p.shape == (12, 4)
    assert np.all(np.asarray(p[10:]) == 0)
    assert pad_rows(t, 5).shape == (10, 4)


def test_state_spec_rules():
    assert state_spec("['tables']['user_table']", jnp.ones((8, 4))) == \
        P("rows", None)
    assert state_spec("['gru_u']['wx']", jnp.ones((8, 4))) == P()
    assert state_spec("['tables']['user_table']", jnp.ones(())) == P()


def test_data_parallel_grads_match_single_device(mesh, tiny_dataset, rng):
    """N-way DP grads on a sharded batch == single-device grads on the full
    batch (SURVEY.md §4.2)."""
    from score_tpu.config import configs3
    from score_tpu.graph import device_graph, gather_batch
    from score_tpu.train import build_model, init_state
    from score_tpu.nn.scorer import bce_loss

    cfg = configs3()
    g = device_graph(tiny_dataset.graph)
    model = build_model(cfg, tiny_dataset.num_users, tiny_dataset.num_items)
    state = init_state(cfg, model, g, jax.random.PRNGKey(0))

    B = 32
    idx = np.linspace(0, len(tiny_dataset.train) - 1, B).astype(np.int64)
    users = jnp.asarray(tiny_dataset.train.user[idx])
    items = jnp.asarray(tiny_dataset.train.item[idx])
    slots = jnp.asarray(tiny_dataset.train.slot[idx])
    labels = jnp.asarray((np.arange(B) % 2).astype(np.float32))

    def loss_fn(params, graph, u, i, t, y):
        mb = gather_batch(graph, u, i, t)
        logits = model.apply(params, mb)
        return bce_loss(logits, y)

    # single device
    g_single = jax.grad(loss_fn)(state.params, g, users, items, slots, labels)

    # sharded: params/graph sharded on mesh, batch over 'data'
    params_sh = shard_state(mesh, state.params)
    graph_sh = shard_graph(mesh, g)
    bs = batch_sharding(mesh)
    args_sh = [jax.device_put(x, bs) for x in (users, items, slots, labels)]
    g_shard = jax.jit(jax.grad(loss_fn))(params_sh, graph_sh, *args_sh)

    flat_s = jax.tree_util.tree_leaves(g_single)
    flat_m = jax.tree_util.tree_leaves(g_shard)
    for a, b in zip(flat_s, flat_m):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("mode", ["psum", "a2a"])
def test_model_forward_with_exchange_lookup(mesh, tiny_dataset, mode):
    """Full configs3 forward with the shard_map lookup exchange == local
    gather, through the model (the configs4 integration path)."""
    from score_tpu.config import configs3
    from score_tpu.graph import device_graph, gather_batch
    from score_tpu.sharding import make_lookup_fn
    from score_tpu.train import build_model, init_state

    cfg = configs3()
    g = device_graph(tiny_dataset.graph)
    model_local = build_model(cfg, tiny_dataset.num_users,
                              tiny_dataset.num_items)
    state = init_state(cfg, model_local, g, jax.random.PRNGKey(0))
    model_x = build_model(cfg, tiny_dataset.num_users,
                          tiny_dataset.num_items,
                          lookup_fn=make_lookup_fn(mesh, mode))
    B = 16
    idx = np.linspace(0, len(tiny_dataset.train) - 1, B).astype(np.int64)
    mb = gather_batch(g, jnp.asarray(tiny_dataset.train.user[idx]),
                      jnp.asarray(tiny_dataset.train.item[idx]),
                      jnp.asarray(tiny_dataset.train.slot[idx]))
    out_local = model_local.apply(state.params, mb)
    out_x = model_x.apply(state.params, mb)
    np.testing.assert_allclose(np.asarray(out_x), np.asarray(out_local),
                               rtol=1e-5, atol=1e-6)


def test_a2a_train_step_matches_local(mesh, tiny_dataset):
    """One full a2a-lookup train step == the local-lookup step (params after
    update compared), under jit on the mesh."""
    from score_tpu.config import configs4
    from score_tpu.graph import device_graph
    from score_tpu.sharding import make_lookup_fn
    from score_tpu.train import build_model, init_state, make_train_step

    cfg = configs4()
    g = device_graph(tiny_dataset.graph)
    m_local = build_model(cfg, tiny_dataset.num_users, tiny_dataset.num_items)
    m_a2a = build_model(cfg, tiny_dataset.num_users, tiny_dataset.num_items,
                        lookup_fn=make_lookup_fn(mesh, "a2a"))
    s_local = init_state(cfg, m_local, g, jax.random.PRNGKey(0))
    s_a2a = init_state(cfg, m_a2a, g, jax.random.PRNGKey(0))
    B = 16
    batch = {
        "user": jnp.asarray(tiny_dataset.train.user[:B]),
        "item": jnp.asarray(tiny_dataset.train.item[:B]),
        "slot": jnp.asarray(tiny_dataset.train.slot[:B]),
    }
    rng = jax.random.PRNGKey(0)
    s_local, ml = make_train_step(m_local, cfg)(s_local, g, batch, rng)
    s_a2a, ma = make_train_step(m_a2a, cfg)(s_a2a, g, batch, rng)
    np.testing.assert_allclose(float(ml["loss"]), float(ma["loss"]),
                               rtol=1e-6)
    # a2a dedup pre-reduces duplicate grad rows before the return exchange,
    # so grad summation order differs from the local scatter-add -> float
    # associativity tolerance, not bit-exactness.
    for a, b in zip(jax.tree_util.tree_leaves(s_local.params),
                    jax.tree_util.tree_leaves(s_a2a.params)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-4, atol=1e-6)


def test_a2a_inbatch_train_step_matches_local(mesh, tiny_dataset):
    """In-batch negatives under the sharded lookup roll the item-side IDS
    before the exchange (model.py id-roll path — kills the dominant
    all-gather of the compiled configs4 step) and must
    match the single-device embedded-roll path exactly (embedding(roll) ==
    roll(embedding))."""
    import dataclasses

    from score_tpu.config import configs4
    from score_tpu.graph import device_graph
    from score_tpu.sharding import make_lookup_fn
    from score_tpu.train import (build_model, init_state,
                                 item_importance_weights, make_train_step)

    cfg = configs4()
    cfg = cfg.replace(data=dataclasses.replace(
        cfg.data, train_neg_mode="inbatch_iw", num_train_neg=2))
    g = device_graph(tiny_dataset.graph)
    neg_iw = jnp.asarray(item_importance_weights(tiny_dataset.train,
                                                 tiny_dataset.num_items))
    m_local = build_model(cfg, tiny_dataset.num_users, tiny_dataset.num_items)
    m_a2a = build_model(cfg, tiny_dataset.num_users, tiny_dataset.num_items,
                        lookup_fn=make_lookup_fn(mesh, "a2a"))
    s_local = init_state(cfg, m_local, g, jax.random.PRNGKey(0))
    s_a2a = init_state(cfg, m_a2a, g, jax.random.PRNGKey(0))
    B = 16
    batch = {
        "user": jnp.asarray(tiny_dataset.train.user[:B]),
        "item": jnp.asarray(tiny_dataset.train.item[:B]),
        "slot": jnp.asarray(tiny_dataset.train.slot[:B]),
    }
    rng = jax.random.PRNGKey(0)
    s_local, ml = make_train_step(m_local, cfg, neg_iw=neg_iw)(
        s_local, g, batch, rng)
    s_a2a, ma = make_train_step(m_a2a, cfg, neg_iw=neg_iw)(
        s_a2a, g, batch, rng)
    np.testing.assert_allclose(float(ml["loss"]), float(ma["loss"]),
                               rtol=1e-5)
    for a, b in zip(jax.tree_util.tree_leaves(s_local.params),
                    jax.tree_util.tree_leaves(s_a2a.params)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-4, atol=1e-6)


def test_configs4_driver_end_to_end(tiny_dataset):
    """The full train() driver under configs4 (mesh + a2a lookups) on the
    fake 8-device mesh — the configs[4] gate (SURVEY.md §4.2)."""
    from score_tpu.config import configs4
    from score_tpu.train import train

    cfg = configs4(num_data=2, num_rows=4)
    cfg = cfg.replace(train=cfg.train.__class__(
        batch_size=64, num_epochs=1, eval_every_steps=10 ** 9,
        early_stop_patience=10 ** 9, log_every_steps=10 ** 9))
    out = train(cfg, tiny_dataset, verbose=False)
    # step-count-vs-plan: exactly steps_per_epoch * num_epochs ran (no chunk
    # mis-count in the fused mesh loop)
    assert out["steps_run"] == len(tiny_dataset.train) // 64
    assert np.isfinite(out["test"]["auc"])


@pytest.mark.parametrize("action", ["raise", "warn"])
def test_overflow_action_policy(tiny_dataset, action, capsys):
    """An overflowing configs4 run ABORTS with the
    capacity hint under the default overflow_action='raise'; 'warn' keeps
    the old log-and-continue behavior for bring-up."""
    from score_tpu.config import ShardingConfig, configs4
    from score_tpu.train import train

    cfg = configs4(num_data=2, num_rows=4)
    cfg = cfg.replace(
        sharding=ShardingConfig(num_data=2, num_rows=4, lookup_mode="a2a",
                                a2a_capacity=1, overflow_action=action),
        train=cfg.train.__class__(
            batch_size=64, num_epochs=1, eval_every_steps=10 ** 9,
            early_stop_patience=10 ** 9, log_every_steps=10 ** 9))
    if action == "raise":
        with pytest.raises(RuntimeError, match="a2a_capacity"):
            train(cfg, tiny_dataset, verbose=False)
    else:
        out = train(cfg, tiny_dataset, verbose=False)
        assert out["steps_run"] == len(tiny_dataset.train) // 64
        assert "capacity overflow" in capsys.readouterr().out


def test_sharded_stride_train_step(mesh, tiny_dataset):
    """The adopted stride2+boost2 step (lax.cond around the update) runs
    under shardings on the mesh: table shards bit-unchanged on the skip
    step, updated on the update step, loss finite both steps."""
    import dataclasses

    from score_tpu.config import configs3
    from score_tpu.graph import device_graph
    from score_tpu.train import build_model, init_state, make_train_step

    cfg = configs3()
    cfg = cfg.replace(train=dataclasses.replace(
        cfg.train, table_update_every=2, table_lr_boost=2.0))
    g = device_graph(tiny_dataset.graph)
    model = build_model(cfg, tiny_dataset.num_users, tiny_dataset.num_items)
    state = init_state(cfg, model, g, jax.random.PRNGKey(0))
    state = shard_state(mesh, state)
    g = shard_graph(mesh, g)
    step = make_train_step(model, cfg)
    bs = batch_sharding(mesh)
    B = 16
    batch = {
        "user": jax.device_put(jnp.asarray(tiny_dataset.train.user[:B]), bs),
        "item": jax.device_put(jnp.asarray(tiny_dataset.train.item[:B]), bs),
        "slot": jax.device_put(jnp.asarray(tiny_dataset.train.slot[:B]), bs),
    }
    t0 = np.asarray(state.params["tables"]["user_table"])
    state, m = step(state, g, batch, jax.random.PRNGKey(0))  # step 0: update
    assert np.isfinite(float(m["loss"]))
    t1 = np.asarray(state.params["tables"]["user_table"])
    assert not np.array_equal(t0, t1)
    assert not state.params["tables"]["user_table"] \
        .sharding.is_fully_replicated
    state, m = step(state, g, batch, jax.random.PRNGKey(0))  # step 1: skip
    assert np.isfinite(float(m["loss"]))
    t2 = np.asarray(state.params["tables"]["user_table"])
    np.testing.assert_array_equal(t1, t2)    # bit-unchanged on skip


def test_configs4_stride_loop_end_to_end(tiny_dataset):
    """The bench-SHIPPED train-loop configuration — the
    static-alternation stride loop (table_update_every=2, lead-in/groups/
    tail) — under GSPMD shardings through the full train() driver. The
    single-step lax.cond form has mesh coverage above; this exercises the
    fused loop with a mid-stride entry (batch chunks of 50 against an odd
    boundary) on the fake 8-device mesh."""
    import dataclasses

    from score_tpu.config import configs4
    from score_tpu.train import train

    cfg = configs4(num_data=2, num_rows=4)
    cfg = cfg.replace(train=dataclasses.replace(
        cfg.train, batch_size=64, num_epochs=1,
        table_update_every=2, table_lr_boost=2.0,
        eval_every_steps=10 ** 9, early_stop_patience=10 ** 9,
        log_every_steps=10 ** 9))
    out = train(cfg, tiny_dataset, verbose=False)
    assert out["steps_run"] == len(tiny_dataset.train) // 64
    assert np.isfinite(out["test"]["auc"])


def test_sharded_stride_loop_matches_steps(mesh, tiny_dataset):
    """The static-alternation stride LOOP under mesh shardings ==
    sequential lax.cond stride STEPS on the same sharded state, entering
    mid-stride (phase=1): params equal leaf-by-leaf after the chunk, and
    table shards stay row-sharded + bit-unchanged across skip steps."""
    import dataclasses

    from score_tpu.config import configs3
    from score_tpu.graph import device_graph
    from score_tpu.train import (build_model, init_state, make_train_loop,
                                 make_train_step)

    cfg = configs3()
    cfg = cfg.replace(train=dataclasses.replace(
        cfg.train, table_update_every=2, table_lr_boost=2.0))
    g0 = device_graph(tiny_dataset.graph)
    model = build_model(cfg, tiny_dataset.num_users, tiny_dataset.num_items)
    state0 = init_state(cfg, model, g0, jax.random.PRNGKey(0))
    # advance one step so the loop entry is mid-stride (entry_step % 2 == 1)
    g = shard_graph(mesh, g0)
    bs = batch_sharding(mesh)
    B, K = 16, 5
    rng = jax.random.PRNGKey(0)
    batches_np = {
        k: np.stack([np.asarray(getattr(tiny_dataset.train, k)[j * B:
                                                               (j + 1) * B])
                     for j in range(K + 1)])
        for k in ("user", "item", "slot")}

    def put(v):
        return jax.device_put(jnp.asarray(v), bs)

    # init_state is deterministic in rng, so each arm rebuilds the same
    # starting state (the jitted step/loop donate their state argument, so
    # the two arms cannot alias one tree)
    def fresh_entry_state():
        s = shard_state(mesh, init_state(cfg, model, g0,
                                         jax.random.PRNGKey(0)))
        s, _ = step(s, g, {k: put(v[0]) for k, v in batches_np.items()},
                    rng)
        return s                       # step == 1 -> mid-stride entry

    step = make_train_step(model, cfg)

    from score_tpu.sharding import stacked_batch_sharding
    sbs = stacked_batch_sharding(mesh)
    loop = make_train_loop(model, cfg)
    s_loop = fresh_entry_state()
    entry = int(s_loop.step)
    assert entry % 2 == 1              # phase 1: loop enters mid-stride
    stacked = {k: jax.device_put(jnp.asarray(v[1:]), sbs)
               for k, v in batches_np.items()}
    s_loop, ms = loop(s_loop, g, stacked, rng, entry % 2)
    assert np.isfinite(float(ms["loss"][-1]))

    s_step = fresh_entry_state()
    for j in range(1, K + 1):
        s_step, _ = step(s_step, g,
                         {k: put(v[j]) for k, v in batches_np.items()}, rng)
    for a, b in zip(jax.tree_util.tree_leaves(s_loop.params),
                    jax.tree_util.tree_leaves(s_step.params)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-6, atol=1e-7)
    assert not s_loop.params["tables"]["user_table"] \
        .sharding.is_fully_replicated


def test_sharded_train_step_runs(mesh, tiny_dataset):
    """Full donated train step under shardings executes and stays finite."""
    from score_tpu.config import configs3
    from score_tpu.graph import device_graph
    from score_tpu.train import build_model, init_state, make_train_step

    cfg = configs3()
    g = device_graph(tiny_dataset.graph)
    model = build_model(cfg, tiny_dataset.num_users, tiny_dataset.num_items)
    state = init_state(cfg, model, g, jax.random.PRNGKey(0))
    state = shard_state(mesh, state)
    g = shard_graph(mesh, g)
    step = make_train_step(model, cfg)
    bs = batch_sharding(mesh)
    B = 16
    batch = {
        "user": jax.device_put(jnp.asarray(tiny_dataset.train.user[:B]), bs),
        "item": jax.device_put(jnp.asarray(tiny_dataset.train.item[:B]), bs),
        "slot": jax.device_put(jnp.asarray(tiny_dataset.train.slot[:B]), bs),
    }
    state2, m = step(state, g, batch, jax.random.PRNGKey(0))
    assert np.isfinite(float(m["loss"]))
    # table params stay row-sharded after the update
    ut = state2.params["tables"]["user_table"]
    assert not ut.sharding.is_fully_replicated