"""Checkpoint/resume (SURVEY.md §5): save/restore round-trip, resume
continues exactly, best/latest retention."""

import jax
import jax.numpy as jnp
import numpy as np

from score_tpu.checkpoint import CheckpointManager, apply_restore
from score_tpu.config import configs0
from score_tpu.graph import device_graph
from score_tpu.train import build_model, init_state, make_train_step, train


def _setup(tiny_dataset):
    cfg = configs0()
    g = device_graph(tiny_dataset.graph)
    model = build_model(cfg, tiny_dataset.num_users, tiny_dataset.num_items)
    state = init_state(cfg, model, g, jax.random.PRNGKey(0))
    return cfg, g, model, state


def test_save_restore_roundtrip(tiny_dataset, tmp_path):
    cfg, g, model, state = _setup(tiny_dataset)
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save("latest", state, (2, 7), 0.81, 123)
    restored = mgr.restore("latest", state)
    assert restored is not None
    assert int(restored["step"]) == 123
    assert (int(restored["it_epoch"]), int(restored["it_pos"])) == (2, 7)
    np.testing.assert_allclose(float(restored["best_val"]), 0.81)
    for a, b in zip(jax.tree_util.tree_leaves(state.params),
                    jax.tree_util.tree_leaves(restored["params"])):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_restore_missing_returns_none(tiny_dataset, tmp_path):
    cfg, g, model, state = _setup(tiny_dataset)
    mgr = CheckpointManager(str(tmp_path / "empty"))
    assert mgr.restore("latest", state) is None
    assert not mgr.has("best")


def test_resume_continues_exactly(tiny_dataset, tmp_path):
    """Train K steps, checkpoint, train K more; vs restore + K more: params
    must match bit-for-bit (deterministic iterator + rng folding)."""
    cfg, g, model, state = _setup(tiny_dataset)
    step_fn = make_train_step(model, cfg)
    rng = jax.random.PRNGKey(0)
    from score_tpu.data.pipeline import TargetIterator

    def drive(state, it, k):
        for _ in range(k):
            b = next(it)
            state, _ = step_fn(
                state, g, {kk: jnp.asarray(v) for kk, v in b.items()}, rng)
        return state

    it = TargetIterator(tiny_dataset.train, 64, seed=0)
    state = drive(state, it, 5)
    mgr = CheckpointManager(str(tmp_path / "resume"))
    mgr.save("latest", state, it.get_state(), 0.5, 5)
    cont = drive(state, it, 5)

    # fresh process simulation: new state template, restore, same 5 steps
    state2 = init_state(cfg, model, g, jax.random.PRNGKey(1))  # diff init
    restored = mgr.restore("latest", state2)
    state2 = apply_restore(state2, restored)
    it2 = TargetIterator(tiny_dataset.train, 64, seed=0)
    it2.set_state((int(restored["it_epoch"]), int(restored["it_pos"])))
    cont2 = drive(state2, it2, 5)

    for a, b in zip(jax.tree_util.tree_leaves(cont.params),
                    jax.tree_util.tree_leaves(cont2.params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_train_with_checkpointing(tiny_dataset, tmp_path):
    """Driver-integrated: train writes latest+best; resumed run starts from
    the saved step."""
    cfg = configs0()
    tc = cfg.train.__class__(batch_size=64, num_epochs=1,
                             eval_every_steps=30, early_stop_patience=100,
                             log_every_steps=10 ** 9,
                             checkpoint_dir=str(tmp_path / "run"))
    cfg = cfg.replace(train=tc)
    out = train(cfg, tiny_dataset, verbose=False)
    from score_tpu.checkpoint import CheckpointManager
    mgr = CheckpointManager(str(tmp_path / "run"))
    assert mgr.has("latest") and mgr.has("best")
    # resume: runs remaining steps (none or few) without error
    out2 = train(cfg, tiny_dataset, verbose=False)
    assert out2["steps_run"] >= out["steps_run"] - 1


def test_cost_summary_and_timed():
    from score_tpu.profiling import cost_summary, timed
    f = lambda x: (x @ x).sum()
    x = jnp.ones((64, 64))
    cs = cost_summary(f, x)
    assert cs["flops"] > 0
    t = timed(jax.jit(f), x)
    assert t >= 0.0


def test_checkpoint_layout_and_atomic_swap(tiny_dataset, tmp_path):
    """One .npy per leaf named by key path plus meta.json, behind a
    symlink that a second save swaps atomically (the old version goes)."""
    import json
    import os
    cfg, g, model, state = _setup(tiny_dataset)
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save("latest", state, (0, 1), 0.5, 1, block=True)
    link = tmp_path / "ck" / "latest"
    assert link.is_symlink()
    first = os.readlink(link)
    files = set(os.listdir(link))
    assert "params.tables.table.npy" in files
    assert any(f.startswith("opt_state.") and f.endswith(".npy")
               for f in files)
    with open(link / "meta.json") as f:
        assert json.load(f) == {"step": 1, "it_epoch": 0, "it_pos": 1,
                                "best_val": 0.5}
    mgr.save("latest", state, (0, 2), 0.6, 2, block=True)
    assert os.readlink(link) != first
    assert not (tmp_path / "ck" / first).exists()
    leftovers = [n for n in os.listdir(tmp_path / "ck") if "link-" in n]
    assert leftovers == []
    assert int(mgr.restore("latest", state)["step"]) == 2


def test_async_save_wait_and_error(tiny_dataset, tmp_path):
    """save() returns before the files are written; wait() (or any reader)
    blocks for them and re-raises a failed write."""
    cfg, g, model, state = _setup(tiny_dataset)
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save("best", state, (0, 0), 0.1, 3)
    other = CheckpointManager(str(tmp_path / "ck"))   # a second reader
    assert other.has("best")
    assert int(other.restore("best", state)["step"]) == 3
    mgr.wait()                                        # nothing pending: no-op

    def broken(*a, **k):
        raise OSError("disk full")
    mgr._write = broken
    mgr.save("latest", state, (0, 0), 0.1, 4)
    import pytest
    with pytest.raises(OSError, match="disk full"):
        mgr.wait()


def test_restore_rejects_shape_mismatch(tiny_dataset, tmp_path):
    import pytest
    cfg, g, model, state = _setup(tiny_dataset)
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save("latest", state, (0, 0), 0.1, 1, block=True)
    bad = state.replace(params=jax.tree.map(
        lambda v: jnp.zeros((v.shape[0] + 1,) + v.shape[1:], v.dtype)
        if v.ndim == 2 else v, state.params))
    with pytest.raises(ValueError, match="shape"):
        mgr.restore("latest", bad)


def test_sharded_restore_onto_mesh(tiny_dataset, tmp_path):
    """A checkpoint restores onto a row-sharded template on the 8-device
    mesh: table leaves come back sharded P('rows', None), values equal."""
    from jax.sharding import PartitionSpec as P

    from score_tpu.config import configs3
    from score_tpu.sharding import make_mesh, shard_state
    cfg = configs3()
    g = device_graph(tiny_dataset.graph)
    model = build_model(cfg, tiny_dataset.num_users, tiny_dataset.num_items)
    state = init_state(cfg, model, g, jax.random.PRNGKey(0))
    mesh = make_mesh(jax.devices()[:8])
    sharded = shard_state(mesh, state)
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save("best", sharded, (0, 0), 0.3, 7, block=True)
    template = shard_state(mesh, init_state(cfg, model, g,
                                            jax.random.PRNGKey(5)))
    out = apply_restore(template, mgr.restore("best", template))
    ut = out.params["tables"]["user_table"]
    assert tuple(ut.sharding.spec)[:1] == ("rows",)
    assert not ut.sharding.is_fully_replicated
    for a, b in zip(jax.tree.leaves(state.params),
                    jax.tree.leaves(out.params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    mu = out.opt_state[0].mu["tables"]["user_table"]
    assert tuple(mu.sharding.spec)[:1] == ("rows",)
    assert int(out.step) == 7
