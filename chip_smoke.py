"""End-to-end smoke run of SCoRe on one NVIDIA GPU (or four, with --four).

    python chip_smoke.py          # one card: correctness, train, eval,
                                  # checkpoint, serve, GPU-marked tests
    python chip_smoke.py --four   # four cards: the configs4 mesh path only

Drives the main path through the entry points a user calls, at the full
width of the flagship model as bench.py builds it (configs3 co-attention,
embed 32, hidden 64, MLP (128, 64), bf16 compute, importance-weighted
in-batch negatives, stride-2 table updates with boost 2, batch 4096) on a
synthetic Taobao-shaped log (T=9 slots, fan-out 10, 50k users x 100k items
x 2M events) made from --seed. Weights are random from the same seed.

Every check prints its error beside its tolerance; any failed check makes
the run exit non-zero. It refuses to run when JAX finds no GPU. The last
line of stdout is one JSON object: {"ok": true, "device": {...}}.
Everything runs in this one process (a JAX process reserves most of the
card's memory; a second one would fail).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


@dataclasses.dataclass(frozen=True)
class Shape:
    """Data and model sizes of one smoke run (the defaults are the bench's)."""

    users: int = 50_000
    items: int = 100_000
    events: int = 2_000_000
    slots: int = 9
    fanout: int = 10
    eval_neg: int = 100
    batch: int = 4096
    embed_dim: int = 32
    hidden_dim: int = 64
    mlp_dims: tuple = (128, 64)
    chunk: int = 50              # fused train steps per dispatch
    check_batch: int = 512       # batch of the on-card correctness checks
    eval_targets: int = 4096


class Checks:
    """Records named pass/fail checks; prints each as it is made."""

    def __init__(self):
        self.failed = []

    def close(self, name: str, got, want, tol: float, note: str = "",
              expect_fail: bool = False) -> float:
        """Compare by max |got - want| / max(|want|, 1e-30) <= tol."""
        got = np.asarray(got, np.float64)
        want = np.asarray(want, np.float64)
        if got.shape != want.shape:
            self.fail(name, f"shape {got.shape} != {want.shape}")
            return float("inf")
        abs_err = float(np.max(np.abs(got - want))) if got.size else 0.0
        scale = float(np.max(np.abs(want))) if want.size else 0.0
        rel = abs_err / max(scale, 1e-30)
        finite = bool(np.isfinite(got).all())
        ok = finite and rel <= tol
        if expect_fail:                  # a demonstration that tol rejects it
            ok = finite and rel > tol
        verdict = ("rejected as expected" if expect_fail and ok else
                   "ok" if ok else "FAIL")
        print(f"  [{verdict}] {name}: max_abs {abs_err:.3e} max_rel "
              f"{rel:.3e} (tol {tol:.1e} of max|ref| {scale:.3e}){note}",
              flush=True)
        if not ok:
            self.failed.append(name)
        return rel

    def true(self, name: str, cond: bool, detail: str = "") -> None:
        print(f"  [{'ok' if cond else 'FAIL'}] {name}: {detail}", flush=True)
        if not cond:
            self.failed.append(name)

    def fail(self, name: str, detail: str) -> None:
        self.true(name, False, detail)


def _phase(title: str) -> float:
    print(f"== {title}", flush=True)
    return time.time()


def make_dataset(shape: Shape, seed: int):
    from score_tpu.data import synth
    from score_tpu.data.prep_common import build_dataset
    user, item, ts = synth.synth_events(shape.users, shape.items,
                                        shape.events, num_slots=shape.slots,
                                        seed=seed)
    return build_dataset(user, item, ts, num_slots=shape.slots,
                         user_fanout=shape.fanout, item_fanout=shape.fanout,
                         num_eval_neg=shape.eval_neg, min_user=3, min_item=3,
                         seed=seed, dataset_name="smoke-taobao")


def flagship_config(shape: Shape, compute_dtype: str = "bfloat16"):
    """configs3 at the bench's widths and training knobs."""
    from score_tpu.config import configs3
    cfg = configs3()
    return cfg.replace(
        model=dataclasses.replace(
            cfg.model, embed_dim=shape.embed_dim, hidden_dim=shape.hidden_dim,
            mlp_dims=tuple(shape.mlp_dims), compute_dtype=compute_dtype),
        data=dataclasses.replace(cfg.data, train_neg_mode="inbatch_iw"),
        train=dataclasses.replace(cfg.train, batch_size=shape.batch,
                                  table_update_every=2, table_lr_boost=2.0))


def _perturbed(params, seed: int, scale: float = 0.1):
    """Params with every leaf moved off its (often zero) init, so each
    weight matters in a correctness comparison."""
    import jax
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: (np.asarray(x) + scale * rng.standard_normal(x.shape)
                   ).astype(np.float32), params)


# --- phase: correctness of the blocks and the forward on the card ---

def check_correctness(checks: Checks, shape: Shape, ds, seed: int) -> None:
    import jax
    import jax.numpy as jnp

    from score_tpu.graph import device_graph, gather_candidate_batch
    from score_tpu.nn.coattn import CrossCoAttention, cross_coattn_ref
    from score_tpu.nn.encoder import GRU
    from score_tpu.train import build_model

    sys.path.insert(0, os.path.join(HERE, "tests"))
    from test_encoder import np_gru

    gpu, cpu = jax.devices()[0], jax.devices("cpu")[0]
    rng = np.random.default_rng(seed)
    B, T, n, d = shape.check_batch, shape.slots, shape.fanout, shape.embed_dim
    C = 2
    Eu = rng.standard_normal((B, T, n, d)).astype(np.float32)
    Ei = rng.standard_normal((B, C, T, n, d)).astype(np.float32)
    mu = rng.random((B, T, n)) > 0.3
    mi = rng.random((B, C, T, n)) > 0.3
    mu[0, 0] = False                     # fully padded slots on both sides
    mi[1, :, 2] = False
    eu = rng.standard_normal((B, d)).astype(np.float32)
    ei = rng.standard_normal((B, C, d)).astype(np.float32)
    # f32 products on this card run as TF32 unless asked otherwise; every
    # check below holds "highest" to a tolerance TF32 (10-bit mantissa,
    # ~1e-3 relative) cannot meet, while f32 reduction-order noise (~1e-6)
    # passes it.
    TOL = 2e-5

    for pool in ("sum", "max"):
        blk = CrossCoAttention(dim=d, pool=pool, target_aware=True)
        p = _perturbed(blk.init(jax.random.PRNGKey(seed)), seed + 1)

        def block(p, *a):
            return blk(p, *a)

        def ref(p, Eu, Ei, mu, mi, eu, ei):
            # per-candidate per-pair reference on the projected targets
            eq = jnp.einsum("de,be->bd", p["wti"], eu)
            iq = jnp.einsum("de,bce->bcd", p["wtu"], ei)
            outs = [cross_coattn_ref(Eu, Ei[:, c], mu, mi[:, c], p["wr"], eq,
                                     iq[:, c], pool=pool, target_aware=True)
                    for c in range(Ei.shape[1])]
            return (jnp.stack([o[0] for o in outs], 1),
                    jnp.stack([o[1] for o in outs], 1))

        args = (Eu, Ei, mu, mi, eu, ei)
        with jax.default_device(cpu):
            want = np.stack(jax.jit(ref)(*jax.device_put((p,) + args, cpu)))
        name = f"coattn pool={pool} C={C} B={B} gpu vs ref on cpu"
        for prec in ("highest", "tensorfloat32"):
            with jax.default_matmul_precision(prec):
                got = np.stack(
                    jax.jit(block)(*jax.device_put((p,) + args, gpu)))
            checks.close(f"{name} [{prec}]", got, want, TOL,
                         expect_fail=prec == "tensorfloat32")

    # GRU vs the numpy recurrence (float64)
    f = shape.hidden_dim
    gru = GRU(in_dim=d, features=f)
    gp = _perturbed(gru.init(jax.random.PRNGKey(seed + 2)), seed + 3, 0.05)
    xs = rng.standard_normal((B, T, d)).astype(np.float32)
    mask = rng.random((B, T)) > 0.2
    want = np_gru(xs.astype(np.float64), mask,
                  *(np.asarray(gp[k], np.float64) for k in ("wx", "wh", "b")))
    for prec in ("highest", "default"):
        with jax.default_matmul_precision(prec):
            got = jax.jit(gru)(*jax.device_put((gp, xs, mask), gpu))
        if prec == "highest":
            checks.close(f"GRU B={B} T={T} d={d} f={f} vs numpy [{prec}]",
                         got, want, TOL)
        else:
            print(f"  [info] GRU vs numpy [{prec}]: max_rel "
                  f"{_rel(got, want):.3e}", flush=True)

    # full f32 score_candidates forward: card vs host CPU, same process
    cfg32 = flagship_config(shape, "float32")
    model = build_model(cfg32, ds.num_users, ds.num_items)
    params = _perturbed(model.init(jax.random.PRNGKey(seed)), seed + 4, 0.05)
    graph = device_graph(ds.graph)
    Bc = min(B, len(ds.val))
    cand = np.concatenate([ds.val.item[:Bc, None], ds.val.neg[:Bc]], axis=1)
    inputs = (ds.val.user[:Bc], cand, ds.val.slot[:Bc])

    def fwd(model):
        def f(params, graph, u, c, t):
            mb = gather_candidate_batch(graph, u, c, t)
            return model.score_candidates(params, mb)
        return jax.jit(f)

    with jax.default_device(cpu):
        want = fwd(model)(*jax.device_put((params, graph) + inputs, cpu))
    want = np.asarray(want)
    on_gpu = jax.device_put((params, graph) + inputs, gpu)
    errs = {}
    for prec in ("highest", "default", "tensorfloat32"):
        with jax.default_matmul_precision(prec):
            got = np.asarray(fwd(model)(*on_gpu))
        name = (f"score_candidates f32 B={Bc} C={cand.shape[1]} "
                f"gpu vs cpu [{prec}]")
        if prec == "highest":
            errs[prec] = checks.close(name, got, want, TOL)
        elif prec == "tensorfloat32":
            errs[prec] = checks.close(name, got, want, TOL, expect_fail=True)
        else:
            errs[prec] = _rel(got, want)
            print(f"  [info] {name}: max_rel {errs[prec]:.3e} "
                  f"({'would be rejected' if errs[prec] > TOL else 'passes'}"
                  f" at tol {TOL:.1e})", flush=True)

    # bf16 compute vs f32 compute, same f32 params, on the card
    cfg16 = flagship_config(shape, "bfloat16")
    model16 = build_model(cfg16, ds.num_users, ds.num_items)
    with jax.default_matmul_precision("highest"):
        ref32 = np.asarray(fwd(model)(*on_gpu))
        got16 = np.asarray(fwd(model16)(*on_gpu))
    # bf16 keeps 8 mantissa bits (~4e-3 relative per rounding); the chain
    # of ~10 rounded stages between embedding and logit stays within ~5%
    # of the logit scale
    checks.close(f"score_candidates bf16 vs f32 B={Bc}", got16, ref32, 5e-2)


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) /
                 max(float(np.max(np.abs(want))), 1e-30))


# --- phases: train, eval, checkpoint, serve ---

def _train_chunks(train_loop, state, graph, it, rng, n: int, K: int):
    """n fused chunks; returns (state, losses, seconds per chunk)."""
    from score_tpu.train import _stack_batches
    losses, secs = [], []
    for _ in range(n):
        stacked = _stack_batches(it, K)
        t0 = time.time()
        state, ms = train_loop(state, graph, stacked, rng, 0)
        losses.append(float(ms["loss"][-1]))        # waits for the chunk
        secs.append(time.time() - t0)
    return state, losses, secs


def run_one_card(checks: Checks, shape: Shape, seed: int) -> None:
    import jax
    import jax.numpy as jnp

    from score_tpu.checkpoint import CheckpointManager, apply_restore
    from score_tpu.data.pipeline import TargetIterator
    from score_tpu.graph import device_graph
    from score_tpu.serve import ScoringService
    from score_tpu.train import (_stack_batches, build_model,
                                 eval_table_cast, evaluate, init_state,
                                 item_importance_weights, make_eval_step,
                                 make_train_loop)

    t0 = _phase("data")
    ds = make_dataset(shape, seed)
    print(f"  users {ds.num_users} items {ds.num_items} train "
          f"{len(ds.train)} val {len(ds.val)} ({time.time() - t0:.1f} s)",
          flush=True)

    _phase("correctness on the card")
    check_correctness(checks, shape, ds, seed)

    _phase("train")
    cfg = flagship_config(shape)
    graph = device_graph(ds.graph)
    model = build_model(cfg, ds.num_users, ds.num_items)
    rng = jax.random.PRNGKey(seed)
    state = init_state(cfg, model, graph, rng)
    neg_iw = jnp.asarray(item_importance_weights(ds.train, ds.num_items))
    train_loop = make_train_loop(model, cfg, neg_iw=neg_iw)
    it = TargetIterator(ds.train, shape.batch, seed=seed)
    K = shape.chunk
    state, losses, secs = _train_chunks(train_loop, state, graph, it, rng,
                                        3, K)
    print(f"  chunk losses {losses}; first chunk (compile + {K} steps) "
          f"{secs[0]:.2f} s; steady step "
          f"{1e3 * np.mean(secs[1:]) / K:.3f} ms", flush=True)
    checks.true("train loss finite and falling",
                all(np.isfinite(losses)) and losses[-1] < losses[0],
                f"{losses[0]:.4f} -> {losses[-1]:.4f}")

    _phase("eval")
    eval_step = make_eval_step(model)
    eval_params = eval_table_cast(state.params, cfg.model.compute_dtype)
    t0 = time.time()
    ev = evaluate(eval_step, eval_params, graph, ds.val, batch_size=512,
                  max_targets=shape.eval_targets)
    print(f"  {shape.eval_targets} val targets: auc {ev['auc']:.4f} "
          f"ndcg@10 {ev['ndcg@10']:.4f} hr@10 {ev['hr@10']:.4f} "
          f"({time.time() - t0:.2f} s incl. compile)", flush=True)
    checks.true("eval auc > 0.5 and ndcg@10 finite",
                ev["auc"] > 0.5 and np.isfinite(ev["ndcg@10"]),
                f"auc {ev['auc']:.4f} ndcg@10 {ev['ndcg@10']:.4f}")

    with tempfile.TemporaryDirectory(dir=HERE, prefix=".smoke_ckpt_") as ck:
        _phase("checkpoint")
        mgr = CheckpointManager(ck)
        mgr.save("latest", state, it.get_state(), ev["auc"], 3 * K,
                 block=True)
        fresh = init_state(cfg, model, graph, jax.random.PRNGKey(seed + 1))
        restored = mgr.restore("latest", fresh)
        state_r = apply_restore(fresh, restored)
        same = all(np.array_equal(np.asarray(a), np.asarray(b))
                   for a, b in zip(
                       jax.tree.leaves((state.params, state.opt_state)),
                       jax.tree.leaves((state_r.params, state_r.opt_state))))
        checks.true("restored params and optimizer state bit-equal", same,
                    f"{len(jax.tree.leaves(state.params))} param leaves")

        _phase("serve")
        serve_checks(checks, cfg, ds, state.params, eval_step, graph, ck)

        _phase("resume from checkpoint")
        stacked = _stack_batches(it, K)
        (state, ms_a) = train_loop(state, graph, stacked, rng, 0)
        (state_r, ms_b) = train_loop(state_r, graph, stacked, rng, 0)
        la, lb = float(ms_a["loss"][-1]), float(ms_b["loss"][-1])
        # table-grad scatter-adds are float atomics on this card, applied in
        # a run-dependent order: the two 50-step trajectories may drift in
        # the last bits, not beyond 1e-3 of a ~0.5 loss
        checks.true("one more chunk from saved vs restored state",
                    abs(la - lb) <= 1e-3,
                    f"loss {la:.6f} vs {lb:.6f} (|diff| {abs(la - lb):.2e}, "
                    f"tol 1.0e-03)")

    _phase("gpu-marked tests")
    run_gpu_tests(checks)


def serve_checks(checks: Checks, cfg, ds, params, eval_step, graph,
                 ckpt_dir: str) -> None:
    import jax.numpy as jnp

    from score_tpu.serve import ScoringService
    from score_tpu.train import eval_table_cast

    # rows sharing one slot, so one service (one serving slot) covers them
    slot = int(ds.val.slot[0])
    rows = np.flatnonzero(ds.val.slot == slot)[:8]
    svc = ScoringService(cfg, ds, params, slot=slot)
    cand = np.concatenate([ds.val.item[rows, None], ds.val.neg[rows]], 1)
    want = np.asarray(eval_step(
        eval_table_cast(params, cfg.model.compute_dtype), graph,
        {"user": jnp.asarray(ds.val.user[rows]),
         "item": jnp.asarray(ds.val.item[rows]),
         "slot": jnp.asarray(ds.val.slot[rows]),
         "neg": jnp.asarray(ds.val.neg[rows])}))
    got = np.stack([svc.score(int(u), c)
                    for u, c in zip(ds.val.user[rows], cand)])
    # bf16 activations: two compilations at different padded shapes may
    # fuse and round differently; agreement to bf16 resolution (2^-8) of
    # the logit scale
    TOL16 = 1e-2
    checks.close(f"serve score C={cand.shape[1]} vs eval_step", got, want,
                 TOL16)
    sb = svc.score_batch(ds.val.user[rows], cand)
    checks.close(f"serve score_batch R={len(rows)}", sb, want, TOL16)

    u = int(ds.val.user[rows[0]])
    items, scores = svc.topk(u, k=10)
    checks.true("topk over the full catalog returns 10 items",
                items.shape == (10,) and bool(np.all(np.diff(scores) <= 0)),
                f"{ds.num_items} candidates, top item {int(items[0])} "
                f"score {float(scores[0]):.4f}")
    checks.close("topk scores vs score() on its items", scores,
                 svc.score(u, items), TOL16)

    svc_ck = ScoringService.from_checkpoint(cfg, ds, ckpt_dir,
                                            which="latest", slot=slot)
    got_ck = np.stack([svc_ck.score(int(u), c)
                       for u, c in zip(ds.val.user[rows], cand)])
    checks.close("serve from checkpoint vs from params", got_ck, got, TOL16)


def run_gpu_tests(checks: Checks) -> None:
    """The tests marked `gpu` (they skip on a machine with no card), called
    here in this process on the card."""
    sys.path.insert(0, os.path.join(HERE, "tests"))
    import test_gpu
    import jax
    for name in sorted(n for n in dir(test_gpu) if n.startswith("test_")):
        try:
            getattr(test_gpu, name)(jax.devices("gpu")[0])
            checks.true(f"tests/test_gpu.py::{name}", True, "passed")
        except AssertionError as e:
            checks.fail(f"tests/test_gpu.py::{name}", str(e)[:300])


# --- the four-card mesh path (configs4) ---

def run_four(checks: Checks, shape: Shape, seed: int, train_epochs: int = 1
             ) -> None:
    import jax
    import jax.numpy as jnp

    from score_tpu.data.pipeline import TargetIterator
    from score_tpu.graph import device_graph
    from score_tpu.serve import ScoringService
    from score_tpu.sharding import (make_lookup_fn, make_mesh, shard_graph,
                                    shard_state, stacked_batch_sharding)
    from score_tpu.train import (_stack_batches, build_model, init_state,
                                 item_importance_weights, make_train_loop,
                                 train)

    devs = jax.devices()
    if len(devs) < 4:
        raise SystemExit(f"--four needs 4 devices, JAX sees {len(devs)}")
    t0 = _phase("data")
    ds = make_dataset(shape, seed)
    print(f"  ({time.time() - t0:.1f} s)", flush=True)

    cfg1 = flagship_config(shape)
    cfg4 = cfg1.replace(sharding=dataclasses.replace(
        cfg1.sharding, num_data=2, num_rows=2, lookup_mode="a2a"))
    mesh = make_mesh(devs[:4], data=2, rows=2)
    graph1 = device_graph(ds.graph)
    neg_iw = jnp.asarray(item_importance_weights(ds.train, ds.num_items))
    rng = jax.random.PRNGKey(seed)
    K = shape.chunk
    it = TargetIterator(ds.train, shape.batch, seed=seed)
    stacked = _stack_batches(it, K, put=np.asarray)

    def one_chunk(lookup_fn, sharded: bool):
        model = build_model(cfg1, ds.num_users, ds.num_items,
                            lookup_fn=lookup_fn)
        state = init_state(cfg1, model, graph1, rng)
        graph, batches = graph1, {k: jnp.asarray(v)
                                  for k, v in stacked.items()}
        if sharded:
            state = shard_state(mesh, state)
            graph = shard_graph(mesh, graph1)
            sbs = stacked_batch_sharding(mesh)
            batches = {k: jax.device_put(v, sbs) for k, v in stacked.items()}
        state, ms = make_train_loop(model, cfg1, neg_iw=neg_iw)(
            state, graph, batches, rng, 0)
        return state, float(ms["loss"][-1]), int(ms["a2a_overflow"].sum())

    _phase(f"configs4 train chunk on Mesh('data','rows') 2x2 vs one card")
    _, loss1, _ = one_chunk(None, False)
    print(f"  one card: loss after {K} steps {loss1:.6f}", flush=True)
    # bf16 activations with atomically accumulated table grads: the sharded
    # runs reduce in other orders, so 50-step losses agree to ~1e-3, not
    # bit for bit
    TOL_LOSS = 5e-3
    states = {}
    for mode in ("gspmd", "a2a"):
        lookup = make_lookup_fn(mesh, "a2a") if mode == "a2a" else None
        st, loss, ovf = one_chunk(lookup, True)
        states[mode] = st
        checks.true(f"{mode} loss vs one card", abs(loss - loss1) <= TOL_LOSS,
                    f"{loss:.6f} vs {loss1:.6f} (|diff| "
                    f"{abs(loss - loss1):.2e}, tol {TOL_LOSS:.0e})")
        checks.true(f"{mode} a2a_overflow == 0", ovf == 0, f"{ovf}")
        tbl = st.params["tables"]["user_table"]
        rows = sorted({s.data.shape[0] for s in tbl.addressable_shards})
        checks.true(f"{mode} each device holds half the user-table rows",
                    rows == [tbl.shape[0] // 2],
                    f"shard rows {rows} of {tbl.shape[0]} over "
                    f"{len(tbl.addressable_shards)} devices")

    _phase(f"train() configs4 for {train_epochs} epoch(s)")
    t0 = time.time()
    cfg_t = cfg4.replace(train=dataclasses.replace(
        cfg4.train, num_epochs=train_epochs, eval_every_steps=200))
    out = train(cfg_t, ds, verbose=False)
    print(f"  {out['steps_run']} steps, best val auc "
          f"{out['best_val_auc']:.4f}, test auc {out['test']['auc']:.4f} "
          f"({time.time() - t0:.1f} s)", flush=True)
    tbl = out["params"]["tables"]["item_table"]
    checks.true("train() final params stay row-sharded",
                tuple(tbl.sharding.spec)[:1] == ("rows",)
                and len(tbl.sharding.device_set) == 4,
                f"spec {tbl.sharding.spec} on "
                f"{len(tbl.sharding.device_set)} devices")

    _phase("mesh serving vs one-card serving")
    params = states["a2a"].params
    host = jax.device_get(params)
    slot = int(ds.graph.num_slots)
    users = ds.val.user[:16]
    cand = np.concatenate([ds.val.item[:16, None], ds.val.neg[:16]], 1)
    want = ScoringService(cfg1, ds, host, slot=slot).score_batch(users, cand)
    for mode in ("gspmd", "a2a"):
        lookup = make_lookup_fn(mesh, "a2a") if mode == "a2a" else None
        svc = ScoringService(cfg4, ds, host, slot=slot, mesh=mesh,
                             lookup_fn=lookup)
        checks.close(f"mesh serving ({mode}) vs one card, R={len(users)} "
                     f"C={cand.shape[1]}",
                     svc.score_batch(users, cand), want, 1e-2)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card configs4 mesh path")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    from score_tpu.runtime import (gpu_name_and_power_limit, require_gpu,
                                   setup_compile_cache)
    dev = require_gpu()
    print(gpu_name_and_power_limit(), flush=True)
    import jax
    print(f"jax {jax.__version__}: {len(jax.devices())} x {dev.device_kind}",
          flush=True)
    setup_compile_cache()

    checks = Checks()
    t0 = time.time()
    if args.four:
        run_four(checks, Shape(), args.seed)
    else:
        run_one_card(checks, Shape(), args.seed)
    print(f"== done in {time.time() - t0:.1f} s; "
          f"{len(checks.failed)} failed check(s)", flush=True)
    if checks.failed:
        print("failed: " + "; ".join(checks.failed), file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
