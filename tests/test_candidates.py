"""score_candidates (the hot path) must equal the flat forward on tiled
pairs — across every config-ladder variant and pooling mode."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from score_tpu.config import PRESETS, configs3
from score_tpu.graph import device_graph, gather_batch, gather_candidate_batch
from score_tpu.train import build_model, init_state

CASES = [
    ("configs0", {}),
    ("configs1", {}),
    ("configs2", {}),
    ("configs3", {}),
    ("configs3", {"coattn_pool": "max"}),
    ("configs3", {"coattn_pool": "mean"}),
    ("configs3", {"target_aware": False}),
    ("configs3", {"seq_pool": "last"}),
    ("configs1", {"seq_pool": "last"}),
]


def _setup(tiny_dataset, name, over):
    cfg = PRESETS[name]()
    if over:
        cfg = cfg.replace(model=dataclasses.replace(cfg.model, **over))
    g = device_graph(tiny_dataset.graph)
    model = build_model(cfg, tiny_dataset.num_users, tiny_dataset.num_items)
    state = init_state(cfg, model, g, jax.random.PRNGKey(0))
    # replace zero-init attention weights with random so the test
    # distinguishes the paths
    params = jax.tree_util.tree_map(
        lambda x: x if x.ndim != 2 or x.shape[0] != x.shape[1]
        else jnp.asarray(np.random.default_rng(1).normal(
            size=x.shape).astype(np.float32) * 0.3),
        state.params)
    return cfg, g, model, params


@pytest.mark.parametrize("name,over", CASES)
def test_candidates_equals_flat(tiny_dataset, name, over):
    cfg, g, model, params = _setup(tiny_dataset, name, over)
    B, C = 6, 4
    rng = np.random.default_rng(0)
    idx = np.linspace(0, len(tiny_dataset.train) - 1, B).astype(np.int64)
    users = jnp.asarray(tiny_dataset.train.user[idx])
    slots = jnp.asarray(tiny_dataset.train.slot[idx])
    cand = jnp.asarray(rng.integers(
        1, tiny_dataset.num_items + 1, size=(B, C)).astype(np.int32))

    mb_c = gather_candidate_batch(g, users, cand, slots)
    out_c = model.score_candidates(params, mb_c)
    assert out_c.shape == (B, C)

    # flat forward, one (user, cand[j]) pair at a time
    for j in range(C):
        mb_f = gather_batch(g, users, cand[:, j], slots)
        out_f = model.apply(params, mb_f)
        np.testing.assert_allclose(np.asarray(out_c[:, j]),
                                   np.asarray(out_f),
                                   rtol=2e-5, atol=2e-5,
                                   err_msg=f"{name} {over} cand {j}")


def test_candidates_grads_match_flat(tiny_dataset):
    """Gradients through score_candidates == summed flat-pair gradients."""
    cfg, g, model, params = _setup(tiny_dataset, "configs3", {})
    B, C = 4, 3
    rng = np.random.default_rng(0)
    idx = np.linspace(0, len(tiny_dataset.train) - 1, B).astype(np.int64)
    users = jnp.asarray(tiny_dataset.train.user[idx])
    slots = jnp.asarray(tiny_dataset.train.slot[idx])
    cand = jnp.asarray(rng.integers(
        1, tiny_dataset.num_items + 1, size=(B, C)).astype(np.int32))

    def loss_c(p):
        mb = gather_candidate_batch(g, users, cand, slots)
        out = model.score_candidates(p, mb)
        return jnp.sum(out ** 2)

    def loss_f(p):
        acc = 0.0
        for j in range(C):
            mb = gather_batch(g, users, cand[:, j], slots)
            acc = acc + jnp.sum(model.apply(p, mb) ** 2)
        return acc

    g_c = jax.grad(loss_c)(params)
    g_f = jax.grad(loss_f)(params)
    for a, b in zip(jax.tree_util.tree_leaves(g_c),
                    jax.tree_util.tree_leaves(g_f)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=3e-4, atol=1e-4)


def test_inbatch_roll_equals_explicit_candidates(tiny_dataset):
    """In-batch negatives via neg_shift (rolling the *embedded* item-side
    tensors) must score identically to explicitly gathering the rolled
    items as candidates — forward and gradients."""
    cfg, g, model, params = _setup(tiny_dataset, "configs3", {})
    B = 6
    idx = np.linspace(0, len(tiny_dataset.train) - 1, B).astype(np.int64)
    users = jnp.asarray(tiny_dataset.train.user[idx])
    items = jnp.asarray(tiny_dataset.train.item[idx])
    slots = jnp.asarray(tiny_dataset.train.slot[idx])
    shifts = (2, 4)

    def out_roll(p):
        mb = gather_candidate_batch(g, users, items[:, None], slots)
        mb["neg_shift"] = jnp.asarray(shifts, jnp.int32)
        return model.score_candidates(p, mb)

    def out_explicit(p):
        cand = jnp.stack(
            [items] + [jnp.roll(items, -s, axis=0) for s in shifts], axis=1)
        mb = gather_candidate_batch(g, users, cand, slots)
        return model.score_candidates(p, mb)

    a, b = out_roll(params), out_explicit(params)
    assert a.shape == (B, 1 + len(shifts))
    np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                               rtol=2e-5, atol=2e-5)

    g_r = jax.grad(lambda p: jnp.sum(out_roll(p) ** 2))(params)
    g_e = jax.grad(lambda p: jnp.sum(out_explicit(p) ** 2))(params)
    for x, y in zip(jax.tree_util.tree_leaves(g_r),
                    jax.tree_util.tree_leaves(g_e)):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y),
                                   rtol=3e-4, atol=1e-4)


def test_mf_candidates(tiny_dataset):
    cfg, g, model, params = _setup(
        tiny_dataset, "configs1", {"arch": "mf"})
    B, C = 5, 3
    rng = np.random.default_rng(0)
    users = jnp.asarray(tiny_dataset.train.user[:B])
    slots = jnp.asarray(tiny_dataset.train.slot[:B])
    cand = jnp.asarray(rng.integers(
        1, tiny_dataset.num_items + 1, size=(B, C)).astype(np.int32))
    mb_c = gather_candidate_batch(g, users, cand, slots)
    out_c = model.score_candidates(params, mb_c)
    for j in range(C):
        mb_f = gather_batch(g, users, cand[:, j], slots)
        out_f = model.apply(params, mb_f)
        np.testing.assert_allclose(np.asarray(out_c[:, j]),
                                   np.asarray(out_f), rtol=1e-5)
