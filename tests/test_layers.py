"""The plain-JAX building blocks: param trees of every preset, each block
against numpy, and the embedding/graph gathers against numpy `take`."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from score_tpu.config import PRESETS
from score_tpu.graph import device_graph, gather_batch, gather_candidate_batch
from score_tpu.nn.embed import EmbeddingTables
from score_tpu.nn.layers import (CausalConv, Dense, LayerNorm,
                                 MultiHeadAttention, dropout, subkey)
from score_tpu.train import build_model, init_state

with open(os.path.join(os.path.dirname(__file__), "data",
                       "param_trees.json")) as _f:
    PARAM_TREES = json.load(_f)   # preset -> {key path: shape} on tiny_dataset


@pytest.mark.parametrize("name", sorted(PRESETS))
def test_param_tree_names_and_shapes(tiny_dataset, name):
    """Every preset keeps its param names, nesting and shapes (the 'table'
    path rule drives sharding, the lr boost, stride freezing and casts)."""
    cfg = PRESETS[name]()
    model = build_model(cfg, tiny_dataset.num_users, tiny_dataset.num_items)
    params = model.init(jax.random.PRNGKey(0))
    got = {jax.tree_util.keystr(p): list(np.shape(v))
           for p, v in jax.tree_util.tree_leaves_with_path(params)}
    assert got == PARAM_TREES[name]
    assert all(v.dtype == jnp.float32 for v in jax.tree.leaves(params))


def test_init_distributions(tiny_dataset):
    """Tables ~ N(0, 0.01); LeCun-normal GRU kernels; zero attention
    weights and biases."""
    cfg = PRESETS["configs3"]()
    model = build_model(cfg, tiny_dataset.num_users, tiny_dataset.num_items)
    p = model.init(jax.random.PRNGKey(0))
    ut = np.asarray(p["tables"]["user_table"])
    assert abs(ut.std() - 0.01) < 0.001 and abs(ut.mean()) < 0.001
    wx = np.asarray(p["gru_u"]["wx"])
    assert abs(wx.std() - 1.0 / np.sqrt(wx.shape[0])) < 0.2 / np.sqrt(
        wx.shape[0])
    for leaf in (p["coattn"]["wr"], p["pool_u"]["w"], p["gru_u"]["b"],
                 p["scorer"]["mlp_0"]["bias"]):
        assert not np.any(np.asarray(leaf))
    # distinct keys per block: the two GRUs do not share a draw
    assert not np.allclose(wx, np.asarray(p["gru_i"]["wx"]))


def test_init_is_deterministic_and_seeded(tiny_dataset):
    cfg = PRESETS["configs1"]()
    model = build_model(cfg, tiny_dataset.num_users, tiny_dataset.num_items)
    a = model.init(jax.random.PRNGKey(3))
    b = model.init(jax.random.PRNGKey(3))
    c = model.init(jax.random.PRNGKey(4))
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    assert not np.allclose(np.asarray(a["tables"]["item_table"]),
                           np.asarray(c["tables"]["item_table"]))
    # subkey depends on the name only
    k = jax.random.PRNGKey(0)
    assert np.array_equal(jax.random.key_data(subkey(k, "a")),
                          jax.random.key_data(subkey(k, "a")))
    assert not np.array_equal(jax.random.key_data(subkey(k, "a")),
                              jax.random.key_data(subkey(k, "b")))


def _rand(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def test_dense_vs_numpy(rng):
    layer = Dense(5, 3)
    p = {"kernel": _rand(rng, 5, 3), "bias": _rand(rng, 3)}
    x = _rand(rng, 2, 4, 5)
    np.testing.assert_allclose(np.asarray(layer(p, x)),
                               x @ p["kernel"] + p["bias"], rtol=1e-5,
                               atol=1e-6)
    assert layer.init(jax.random.PRNGKey(0))["kernel"].shape == (5, 3)
    # explicit compute dtype; an unset dtype promotes bf16 x f32 to f32
    assert Dense(5, 3, dtype="bfloat16")(p, x).dtype == jnp.bfloat16
    assert layer(p, x.astype(jnp.bfloat16)).dtype == jnp.float32


def test_layer_norm_vs_numpy(rng):
    ln = LayerNorm(6)
    p = {"scale": _rand(rng, 6), "bias": _rand(rng, 6)}
    x = _rand(rng, 3, 6) * 4 + 2
    mu = x.mean(-1, keepdims=True)
    var = x.var(-1, keepdims=True)
    want = (x - mu) / np.sqrt(var + 1e-6) * p["scale"] + p["bias"]
    np.testing.assert_allclose(np.asarray(ln(p, x)), want, rtol=1e-5,
                               atol=1e-5)
    p0 = ln.init(jax.random.PRNGKey(0))
    assert np.all(np.asarray(p0["scale"]) == 1.0)
    assert np.all(np.asarray(p0["bias"]) == 0.0)


@pytest.mark.parametrize("width", [1, 2, 4])
def test_causal_conv_vs_numpy(rng, width):
    B, T, d, f = 2, 6, 3, 4
    conv = CausalConv(d, f, width)
    p = {"kernel": _rand(rng, width, d, f), "bias": _rand(rng, f)}
    x = _rand(rng, B, T, d)
    want = np.zeros((B, T, f), np.float64)
    for t in range(T):
        for j in range(width):
            src = t - (width - 1) + j
            if src >= 0:
                want[:, t] += x[:, src] @ p["kernel"][j]
    want += p["bias"]
    np.testing.assert_allclose(np.asarray(conv(p, x)), want, rtol=1e-5,
                               atol=1e-5)


def test_multi_head_attention_vs_numpy(rng):
    B, T, dim, H = 2, 5, 8, 2
    hd = dim // H
    mha = MultiHeadAttention(dim, H)
    p = jax.tree.map(lambda v: _rand(rng, *v.shape),
                     mha.init(jax.random.PRNGKey(0)))
    x = _rand(rng, B, T, dim)
    mask = np.tril(np.ones((T, T), bool))[None, None] & \
        (rng.random((B, 1, 1, T)) > 0.2)
    mask[:, :, :, 0] = True
    proj = {k: np.einsum("btd,dhk->bthk", x, p[k]["kernel"]) + p[k]["bias"]
            for k in ("query", "key", "value")}
    logits = np.einsum("bqhd,bkhd->bhqk", proj["query"] / np.sqrt(hd),
                       proj["key"])
    logits = np.where(mask, logits, -np.inf)
    w = np.exp(logits - logits.max(-1, keepdims=True))
    w = w / w.sum(-1, keepdims=True)
    y = np.einsum("bhqk,bkhd->bqhd", w, proj["value"])
    want = np.einsum("bqhd,hdf->bqf", y, p["out"]["kernel"]) + \
        p["out"]["bias"]
    np.testing.assert_allclose(np.asarray(mha(p, x, mask)), want,
                               rtol=1e-4, atol=1e-5)


def test_dropout_rate_and_identity(rng):
    x = jnp.ones((200, 50))
    k = jax.random.PRNGKey(0)
    assert dropout(x, 0.5, k, train=False) is x
    assert dropout(x, 0.0, k, train=True) is x
    y = np.asarray(dropout(x, 0.25, k, train=True))
    kept = y != 0
    assert abs(kept.mean() - 0.75) < 0.02
    np.testing.assert_allclose(y[kept], 1.0 / 0.75, rtol=1e-6)
    # same key, same mask; another key, another mask
    np.testing.assert_array_equal(
        y, np.asarray(dropout(x, 0.25, k, train=True)))
    assert not np.array_equal(
        y, np.asarray(dropout(x, 0.25, jax.random.PRNGKey(1), train=True)))
    with pytest.raises(ValueError):
        dropout(x, 0.25, None, train=True)


@pytest.mark.parametrize("n_ids", [7, 1000, 1024, 1500, 2048])
@pytest.mark.parametrize("d", [8, 32])
def test_embedding_lookup_matches_take(rng, n_ids, d):
    V = 300
    tables = EmbeddingTables(num_users=V - 1, num_items=V - 1, dim=d)
    p = jax.tree.map(lambda v: _rand(rng, *v.shape),
                     tables.init(jax.random.PRNGKey(0)))
    ids = rng.integers(0, V, size=(n_ids,)).astype(np.int32)
    np.testing.assert_array_equal(
        np.asarray(tables.item_emb(p, jnp.asarray(ids))),
        np.take(p["item_table"], ids, axis=0))
    np.testing.assert_array_equal(
        np.asarray(tables.user_emb(p, jnp.asarray(ids))),
        np.take(p["user_table"], ids, axis=0))


def test_embedding_lookup_nd_ids_and_shared_layout(rng):
    tables = EmbeddingTables(num_users=20, num_items=30, dim=16, shared=True)
    p = {"table": _rand(rng, 64, 16)}
    ids = rng.integers(0, 21, size=(3, 5, 7)).astype(np.int32)
    np.testing.assert_array_equal(
        np.asarray(tables.item_emb(p, jnp.asarray(ids))),
        np.take(p["table"], ids, axis=0))
    # users sit after the items; id 0 stays the pad row
    want = np.take(p["table"], np.where(ids > 0, ids + 30, 0), axis=0)
    np.testing.assert_array_equal(
        np.asarray(tables.user_emb(p, jnp.asarray(ids))), want)


def test_embedding_lookup_reports_overflow():
    """A lookup_fn returning (emb, overflow) feeds the diag list."""
    tables = EmbeddingTables(
        num_users=4, num_items=4, dim=2,
        lookup_fn=lambda t, ids: (jnp.take(t, ids, axis=0),
                                  jnp.asarray(3, jnp.int32)))
    p = tables.init(jax.random.PRNGKey(0))
    diag = []
    tables.item_emb(p, jnp.asarray([1, 2]), diag)
    tables.user_emb(p, jnp.asarray([1]), diag)
    assert [int(x) for x in diag] == [3, 3]


@pytest.mark.parametrize("n", [1, 7, 64, 300])
def test_gather_batch_matches_take(tiny_dataset, n):
    g = device_graph(tiny_dataset.graph)
    idx = np.linspace(0, len(tiny_dataset.train) - 1, n).astype(np.int64)
    u = tiny_dataset.train.user[idx]
    i = tiny_dataset.train.item[idx]
    t = tiny_dataset.train.slot[idx]
    mb = gather_batch(g, jnp.asarray(u), jnp.asarray(i), jnp.asarray(t))
    for key, table, ids in (("u_hist", g.u2i, u), ("u_cnt", g.u2i_cnt, u),
                            ("i_hist", g.i2u, i), ("i_cnt", g.i2u_cnt, i)):
        np.testing.assert_array_equal(
            np.asarray(mb[key]), np.take(np.asarray(table), ids, axis=0))


def test_gather_candidate_batch_matches_take(tiny_dataset):
    g = device_graph(tiny_dataset.graph)
    u = tiny_dataset.val.user[:6]
    cand = np.concatenate([tiny_dataset.val.item[:6, None],
                           tiny_dataset.val.neg[:6, :4]], axis=1)
    t = tiny_dataset.val.slot[:6]
    mb = gather_candidate_batch(g, jnp.asarray(u), jnp.asarray(cand),
                                jnp.asarray(t))
    np.testing.assert_array_equal(np.asarray(mb["i_hist"]),
                                  np.take(np.asarray(g.i2u), cand, axis=0))
    np.testing.assert_array_equal(np.asarray(mb["u_hist"]),
                                  np.take(np.asarray(g.u2i), u, axis=0))


def test_train_state_is_a_pytree(tiny_dataset):
    """TrainState: step/params/opt_state are leaves, the optimizer is
    static; apply_gradients steps the counter."""
    cfg = PRESETS["configs0"]()
    g = device_graph(tiny_dataset.graph)
    model = build_model(cfg, tiny_dataset.num_users, tiny_dataset.num_items)
    state = init_state(cfg, model, g, jax.random.PRNGKey(0))
    leaves, treedef = jax.tree_util.tree_flatten(state)
    again = jax.tree_util.tree_unflatten(treedef, leaves)
    assert again.tx is state.tx
    zero = jax.tree.map(jnp.zeros_like, state.params)
    st2 = jax.jit(lambda s, gr: s.apply_gradients(gr))(state, zero)
    assert int(st2.step) == 1
    paths = {jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_leaves_with_path(state)}
    assert ".params['tables']['table']" in paths
