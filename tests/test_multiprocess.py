"""Real 2-process `jax.distributed` smoke test (SURVEY.md §4.2 'multi-host
smoke'): the only way a single machine without a cluster can execute
`sharding.bringup`'s `jax.distributed.initialize` branch.

Spawns two CPU subprocesses wired through a localhost coordinator; each runs
bringup(), builds the global 2-device mesh, and runs the a2a + psum lookup
exchanges across the process boundary, checking against a local numpy
reference. Skipped (not failed) where localhost sockets are blocked.
"""

import os
import socket
import subprocess
import sys

import pytest

_WORKER = r"""
import sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")

pid, port = int(sys.argv[1]), sys.argv[2]
from score_tpu.config import ShardingConfig
from score_tpu.sharding import bringup, make_lookup_fn, make_mesh

mesh, lookup = bringup(
    ShardingConfig(num_data=1, num_rows=2, lookup_mode="a2a"),
    coordinator_address=f"127.0.0.1:{port}", num_processes=2, process_id=pid)
assert jax.process_count() == 2, jax.process_count()
assert len(jax.devices()) == 2, jax.devices()

import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from score_tpu.sharding import a2a_lookup, psum_lookup

rng = np.random.default_rng(0)        # same seed in both processes
V, d, n = 32, 8, 64
table_h = rng.normal(size=(V, d)).astype(np.float32)
ids_h = rng.integers(0, V, size=(n,)).astype(np.int32)

table = jax.make_array_from_callback(
    (V, d), NamedSharding(mesh, P("rows", None)),
    lambda idx: table_h[idx])
ids = jax.make_array_from_callback(
    (n,), NamedSharding(mesh, P(("data", "rows"))),
    lambda idx: ids_h[idx])

want = table_h[ids_h]
for fn in (a2a_lookup, psum_lookup):
    got = fn(mesh, table, ids) if fn is a2a_lookup else fn(
        mesh, table, jax.make_array_from_callback(
            (n,), NamedSharding(mesh, P("data")), lambda idx: ids_h[idx]))
    # checksum is fully-addressable (replicated-safe): sum via jnp
    chk = float(jnp.sum(got * jnp.asarray(want)))
    ref = float(np.sum(want * want))
    assert abs(chk - ref) < 1e-3 * max(abs(ref), 1.0), (fn.__name__, chk, ref)
print(f"OK {pid} {ref:.6f}", flush=True)
"""


_TRAIN_WORKER = r"""
import sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")

pid, port = int(sys.argv[1]), sys.argv[2]
from score_tpu.config import ShardingConfig, configs4
from score_tpu.sharding import bringup, make_lookup_fn, state_spec

mesh, _ = bringup(
    ShardingConfig(num_data=1, num_rows=2, lookup_mode="a2a"),
    coordinator_address=f"127.0.0.1:{port}", num_processes=2, process_id=pid)
assert jax.process_count() == 2

import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from jax.tree_util import keystr, tree_map_with_path

from score_tpu.data import synth
from score_tpu.data.prep_common import build_dataset
from score_tpu.graph import device_graph
from score_tpu.train import build_model, init_state, make_train_step

# deterministic dataset, identical in both processes AND the parent's
# single-process reference (== conftest tiny_dataset knobs)
user, item, ts = synth.synth_events(300, 600, 20000, num_slots=8, seed=0)
ds = build_dataset(user, item, ts, num_slots=8, user_fanout=6, item_fanout=6,
                   num_eval_neg=20, min_user=3, min_item=3, seed=0,
                   dataset_name="tiny")
cfg = configs4(num_data=1, num_rows=2)
cfg = cfg.replace(model=cfg.model.__class__(
    embed_dim=8, hidden_dim=16, mlp_dims=(16,), sides="dual",
    slot_agg="coattn", seq_pool="attn", target_aware=True))
graph_local = device_graph(ds.graph)


def put_global(tree, spec_fn):
    def put(path, leaf):
        spec = spec_fn(keystr(path), leaf)
        arr = np.asarray(leaf)
        return jax.make_array_from_callback(
            arr.shape, NamedSharding(mesh, spec), lambda idx, a=arr: a[idx])
    return tree_map_with_path(put, tree)


graph = put_global(graph_local, lambda p, l: P())       # replicated store
B = 32
batch_h = {k: np.asarray(getattr(ds.train, k)[:B])
           for k in ("user", "item", "slot")}
batch = {k: jax.make_array_from_callback(
             v.shape, NamedSharding(mesh, P(("data", "rows"))),
             lambda idx, a=v: a[idx])
         for k, v in batch_h.items()}

# both lookup variants: explicit a2a exchange AND GSPMD auto-partitioning —
# each runs grad psum + sparse table grads + adam across the REAL process
# boundary (SURVEY.md §4.2 multi-host smoke)
for mode in ("a2a", "gspmd"):
    lookup_fn = make_lookup_fn(mesh, "a2a") if mode == "a2a" else None
    model = build_model(cfg, ds.num_users, ds.num_items, lookup_fn=lookup_fn)
    state = init_state(cfg, model, graph_local, jax.random.PRNGKey(0))
    state = put_global(state, state_spec)               # == shard_state
    state2, m = make_train_step(model, cfg)(state, graph, batch,
                                            jax.random.PRNGKey(0))
    loss = float(m["loss"])
    ut = float(jnp.sum(jnp.square(state2.params["tables"]["user_table"])))
    itb = float(jnp.sum(jnp.square(state2.params["tables"]["item_table"])))
    assert np.isfinite(loss)
    print(f"RES {mode} {loss:.6f} {ut:.6f} {itb:.6f}", flush=True)
print("OK", flush=True)
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_bringup_and_lookup(tmp_path):
    try:
        port = _free_port()
    except OSError:
        pytest.skip("no localhost sockets in this sandbox")
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)          # 1 CPU device per process
    env["JAX_PLATFORMS"] = "cpu"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(i), str(port)],
        cwd=repo, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for i in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=300)
            outs.append((p.returncode, out))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.skip("distributed bring-up timed out (coordinator port issue)")
    for rc, out in outs:
        if rc != 0 and ("UNAVAILABLE" in out or "failed to connect" in out):
            pytest.skip(f"coordinator unavailable in sandbox: {out[-200:]}")
        assert rc == 0, out
        assert "OK" in out, out
    # both processes computed the identical checksum
    chk = [o.split("OK")[1].split()[1] for _, o in outs]
    assert chk[0] == chk[1], chk


def test_two_process_full_train_step(tiny_dataset):
    """A FULL train step (grad psum + sparse table grads +
    adam update) across a real jax.distributed process boundary, for both
    the explicit a2a lookup and the GSPMD path — loss and post-step table
    checksums must match a single-process run on the same batch."""
    import re

    import jax
    import jax.numpy as jnp
    import numpy as np

    try:
        port = _free_port()
    except OSError:
        pytest.skip("no localhost sockets in this sandbox")
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)          # 1 CPU device per process
    env["JAX_PLATFORMS"] = "cpu"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _TRAIN_WORKER, str(i), str(port)],
        cwd=repo, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for i in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=600)
            outs.append((p.returncode, out))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.skip("distributed bring-up timed out (coordinator port issue)")
    for rc, out in outs:
        if rc != 0 and ("UNAVAILABLE" in out or "failed to connect" in out):
            pytest.skip(f"coordinator unavailable in sandbox: {out[-200:]}")
        assert rc == 0, out
        assert "OK" in out, out

    # single-process reference on the SAME dataset/batch/seeds
    from score_tpu.config import configs4
    from score_tpu.graph import device_graph
    from score_tpu.train import build_model, init_state, make_train_step

    ds = tiny_dataset
    cfg = configs4(num_data=1, num_rows=2)
    cfg = cfg.replace(model=cfg.model.__class__(
        embed_dim=8, hidden_dim=16, mlp_dims=(16,), sides="dual",
        slot_agg="coattn", seq_pool="attn", target_aware=True))
    g = device_graph(ds.graph)
    model = build_model(cfg, ds.num_users, ds.num_items)
    state = init_state(cfg, model, g, jax.random.PRNGKey(0))
    B = 32
    batch = {k: jnp.asarray(getattr(ds.train, k)[:B])
             for k in ("user", "item", "slot")}
    state2, m = make_train_step(model, cfg)(state, g, batch,
                                            jax.random.PRNGKey(0))
    want = (float(m["loss"]),
            float(jnp.sum(jnp.square(state2.params["tables"]["user_table"]))),
            float(jnp.sum(jnp.square(state2.params["tables"]["item_table"]))))

    got = {}
    for _, out in outs:
        for mode, loss, ut, itb in re.findall(
                r"RES (\w+) ([-\d.e]+) ([-\d.e]+) ([-\d.e]+)", out):
            got.setdefault(mode, []).append(
                (float(loss), float(ut), float(itb)))
    assert set(got) == {"a2a", "gspmd"}, got
    for mode, vals in got.items():
        assert vals[0] == vals[1], (mode, vals)   # both procs agree exactly
        np.testing.assert_allclose(vals[0], want, rtol=1e-3,
                                   err_msg=f"mode={mode}")
