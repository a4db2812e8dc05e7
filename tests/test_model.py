"""Model-level tests: every config-ladder variant, padding invariance,
graph gather semantics (SURVEY.md §4.2)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from score_tpu.config import configs0, configs1, configs2, configs3
from score_tpu.graph import device_graph, gather_batch, slot_valid_mask
from score_tpu.train import build_model, init_state

ALL_CFGS = [("configs0", configs0), ("configs1", configs1),
            ("configs2", configs2), ("configs3", configs3)]


def _batch(ds, g, n=8):
    # spread over the split so slots (and history lengths) vary — targets are
    # slot-sorted, so a prefix would be all t*=1
    idx = np.linspace(0, len(ds.train) - 1, n).astype(np.int64)
    return gather_batch(g, jnp.asarray(ds.train.user[idx]),
                        jnp.asarray(ds.train.item[idx]),
                        jnp.asarray(ds.train.slot[idx]))


@pytest.mark.parametrize("name,mk", ALL_CFGS)
def test_forward_shapes_finite(tiny_dataset, name, mk):
    cfg = mk()
    g = device_graph(tiny_dataset.graph)
    model = build_model(cfg, tiny_dataset.num_users, tiny_dataset.num_items)
    state = init_state(cfg, model, g, jax.random.PRNGKey(0))
    mb = _batch(tiny_dataset, g)
    logits = model.apply(state.params, mb)
    assert logits.shape == (8,)
    assert np.isfinite(np.asarray(logits)).all()


def test_slot_valid_mask():
    m = np.asarray(slot_valid_mask(jnp.asarray([0, 1, 3]), 4))
    want = np.array([[0, 0, 0, 0], [1, 0, 0, 0], [1, 1, 1, 0]], dtype=bool)
    np.testing.assert_array_equal(m, want)


def test_gather_matches_host(tiny_dataset):
    g = device_graph(tiny_dataset.graph)
    users = jnp.asarray(tiny_dataset.train.user[:5])
    items = jnp.asarray(tiny_dataset.train.item[:5])
    slots = jnp.asarray(tiny_dataset.train.slot[:5])
    mb = gather_batch(g, users, items, slots)
    gh = tiny_dataset.graph
    for b in range(5):
        u = int(users[b])
        np.testing.assert_array_equal(np.asarray(mb["u_hist"])[b],
                                      gh.u2i[:, u, :])
        np.testing.assert_array_equal(np.asarray(mb["u_cnt"])[b],
                                      gh.u2i_cnt[:, u])
        i = int(items[b])
        np.testing.assert_array_equal(np.asarray(mb["i_hist"])[b],
                                      gh.i2u[:, i, :])


def test_no_leakage_through_future_slots(tiny_dataset):
    """Mutating adjacency at slots >= t* must not change the logits."""
    cfg = configs3()
    gh = tiny_dataset.graph
    g = device_graph(gh)
    model = build_model(cfg, tiny_dataset.num_users, tiny_dataset.num_items)
    state = init_state(cfg, model, g, jax.random.PRNGKey(0))
    n = 8
    users = jnp.asarray(tiny_dataset.train.user[:n])
    items = jnp.asarray(tiny_dataset.train.item[:n])
    slots = jnp.asarray(tiny_dataset.train.slot[:n])
    out1 = model.apply(state.params,
                       gather_batch(g, users, items, slots))
    # corrupt all adjacency at the max slot and above
    import dataclasses
    t0 = int(np.min(np.asarray(slots)))
    u2i2 = gh.u2i.copy()
    u2i2[t0:] = 1                   # garbage neighbors in future slots
    cnt2 = gh.u2i_cnt.copy()
    cnt2[t0:] = gh.user_fanout
    i2u2 = gh.i2u.copy()
    i2u2[t0:] = 1
    icnt2 = gh.i2u_cnt.copy()
    icnt2[t0:] = gh.item_fanout
    g2 = device_graph(dataclasses.replace(
        gh, u2i=u2i2, u2i_cnt=cnt2, i2u=i2u2, i2u_cnt=icnt2))
    # only examples whose t* <= t0 are guaranteed unchanged
    keep = np.asarray(slots) <= t0
    out2 = model.apply(state.params,
                       gather_batch(g2, users, items, slots))
    np.testing.assert_allclose(np.asarray(out1)[keep], np.asarray(out2)[keep],
                               atol=1e-6)


def test_padded_tail_invariance(tiny_dataset):
    """Garbage ids in the padded tail of dense adjacency rows (j >= cnt) must
    not change logits — the ids are masked, not zero-relied-upon."""
    cfg = configs3()
    gh = tiny_dataset.graph
    g = device_graph(gh)
    model = build_model(cfg, tiny_dataset.num_users, tiny_dataset.num_items)
    state = init_state(cfg, model, g, jax.random.PRNGKey(0))
    mb = _batch(tiny_dataset, g)
    out1 = model.apply(state.params, mb)
    # overwrite padding positions with a valid-looking id
    import dataclasses
    j = np.arange(gh.user_fanout)[None, None, :]
    upad = j >= gh.u2i_cnt[..., None]
    u2i2 = gh.u2i.copy()
    u2i2[upad] = 3
    jm = np.arange(gh.item_fanout)[None, None, :]
    ipad = jm >= gh.i2u_cnt[..., None]
    i2u2 = gh.i2u.copy()
    i2u2[ipad] = 3
    g2 = device_graph(dataclasses.replace(gh, u2i=u2i2, i2u=i2u2))
    mb2 = _batch(tiny_dataset, g2)
    out2 = model.apply(state.params, mb2)
    np.testing.assert_allclose(np.asarray(out1), np.asarray(out2), atol=1e-6)


def test_gradients_flow_everywhere(tiny_dataset):
    cfg = configs3()
    g = device_graph(tiny_dataset.graph)
    model = build_model(cfg, tiny_dataset.num_users, tiny_dataset.num_items)
    state = init_state(cfg, model, g, jax.random.PRNGKey(0))
    mb = _batch(tiny_dataset, g)

    def loss(params):
        return jnp.sum(model.apply(params, mb) ** 2)

    grads = jax.grad(loss)(state.params)
    flat = jax.tree_util.tree_leaves_with_path(grads)
    for path, leaf in flat:
        name = jax.tree_util.keystr(path)
        assert np.isfinite(np.asarray(leaf)).all(), name
        # every non-table param should receive some gradient
        if "table" not in name:
            assert np.any(np.asarray(leaf) != 0.0), name


def test_shared_table_offsets(tiny_dataset):
    """configs0 shared table: same id as user vs item must hit different rows."""
    cfg = configs0()
    g = device_graph(tiny_dataset.graph)
    model = build_model(cfg, tiny_dataset.num_users, tiny_dataset.num_items)
    state = init_state(cfg, model, g, jax.random.PRNGKey(0))
    table = state.params["tables"]["table"]
    need = 1 + tiny_dataset.num_users + tiny_dataset.num_items
    assert need <= table.shape[0] < need + 64  # rounded up to row_multiple


def test_bfloat16_compute_path(tiny_dataset):
    """Mixed precision: compute_dtype=bfloat16 keeps the activation chain in
    bf16 (f32 master params), trains, and tracks the f32 forward closely."""
    import dataclasses
    from score_tpu.train import make_train_step
    g = device_graph(tiny_dataset.graph)
    cfg32 = configs3()
    cfg16 = cfg32.replace(model=dataclasses.replace(
        cfg32.model, compute_dtype="bfloat16"))
    m32 = build_model(cfg32, tiny_dataset.num_users, tiny_dataset.num_items)
    m16 = build_model(cfg16, tiny_dataset.num_users, tiny_dataset.num_items)
    state = init_state(cfg32, m32, g, jax.random.PRNGKey(0))
    idx = np.arange(16)
    b = gather_batch(g, jnp.asarray(tiny_dataset.train.user[idx]),
                     jnp.asarray(tiny_dataset.train.item[idx]),
                     jnp.asarray(tiny_dataset.train.slot[idx]))
    o32 = m32.apply(state.params, b)
    o16 = m16.apply(state.params, b)   # same f32 master params
    assert o16.dtype == jnp.float32                # logits always f32
    np.testing.assert_allclose(np.asarray(o32), np.asarray(o16),
                               rtol=0.05, atol=0.05)
    # bf16 train step runs and decreases loss
    state16 = init_state(cfg16, m16, g, jax.random.PRNGKey(0))
    step = make_train_step(m16, cfg16)
    batch = {k: jnp.asarray(v) for k, v in dict(
        user=tiny_dataset.train.user[:128],
        item=tiny_dataset.train.item[:128],
        slot=tiny_dataset.train.slot[:128]).items()}
    losses = []
    for _ in range(10):
        state16, m = step(state16, g, batch, jax.random.PRNGKey(0))
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
