"""Baseline archs + self-attention encoder + serving API."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from score_tpu.config import configs1, configs3
from score_tpu.graph import device_graph, gather_batch
from score_tpu.train import build_model, init_state, make_train_step


def _cfg_with(base, **model_kw):
    return base.replace(model=dataclasses.replace(base.model, **model_kw))


def _batch(ds, g, n=8):
    idx = np.linspace(0, len(ds.train) - 1, n).astype(np.int64)
    return gather_batch(g, jnp.asarray(ds.train.user[idx]),
                        jnp.asarray(ds.train.item[idx]),
                        jnp.asarray(ds.train.slot[idx]))


def test_mf_and_pop_forward_and_train(tiny_dataset):
    g = device_graph(tiny_dataset.graph)
    for arch in ("mf", "pop"):
        cfg = _cfg_with(configs1(), arch=arch)
        model = build_model(cfg, tiny_dataset.num_users,
                           tiny_dataset.num_items)
        state = init_state(cfg, model, g, jax.random.PRNGKey(0))
        out = model.apply(state.params, _batch(tiny_dataset, g))
        assert out.shape == (8,)
        step = make_train_step(model, cfg)
        batch = {k: jnp.asarray(v) for k, v in dict(
            user=tiny_dataset.train.user[:64],
            item=tiny_dataset.train.item[:64],
            slot=tiny_dataset.train.slot[:64]).items()}
        losses = []
        for _ in range(10):
            state, m = step(state, g, batch, jax.random.PRNGKey(0))
            losses.append(float(m["loss"]))
        assert losses[-1] < losses[0], (arch, losses)


def test_svdpp_and_delf_forward_and_train(tiny_dataset):
    """SVD++ / DELF roster entries: forward shapes + loss decreases."""
    g = device_graph(tiny_dataset.graph)
    for arch in ("svdpp", "delf"):
        cfg = _cfg_with(configs1(), arch=arch)
        model = build_model(cfg, tiny_dataset.num_users,
                            tiny_dataset.num_items)
        state = init_state(cfg, model, g, jax.random.PRNGKey(0))
        out = model.apply(state.params, _batch(tiny_dataset, g))
        assert out.shape == (8,)
        assert np.isfinite(np.asarray(out)).all()
        step = make_train_step(model, cfg)
        batch = {k: jnp.asarray(v) for k, v in dict(
            user=tiny_dataset.train.user[:64],
            item=tiny_dataset.train.item[:64],
            slot=tiny_dataset.train.slot[:64]).items()}
        losses = []
        for _ in range(10):
            state, m = step(state, g, batch, jax.random.PRNGKey(0))
            losses.append(float(m["loss"]))
        assert losses[-1] < losses[0], (arch, losses)


def test_svdpp_implicit_factor_matches_numpy(tiny_dataset):
    """SVD++ user vector = eu + |N(u)|^-1/2 sum of implicit item embs."""
    from score_tpu.nn.baselines import SVDPPModel
    g = device_graph(tiny_dataset.graph)
    cfg = _cfg_with(configs1(), arch="svdpp")
    model = build_model(cfg, tiny_dataset.num_users, tiny_dataset.num_items)
    state = init_state(cfg, model, g, jax.random.PRNGKey(0))
    b = _batch(tiny_dataset, g)
    assert isinstance(model, SVDPPModel)
    pu = model._user_vec(state.params, b)
    p = state.params
    eu = np.asarray(p["tables"]["user_table"])[np.asarray(b["user"])]
    Y = np.asarray(p["implicit_tables"]["item_table"])
    hist = np.asarray(b["u_hist"])               # [B, T, n]
    cnt = np.asarray(b["u_cnt"])                 # [B, T]
    sv = np.asarray(b["slot_valid"])             # [B, T]
    want = eu.copy()
    for r in range(hist.shape[0]):
        ids = [hist[r, t, j]
               for t in range(hist.shape[1]) if sv[r, t]
               for j in range(min(cnt[r, t], hist.shape[2]))]
        if ids:
            want[r] += Y[np.asarray(ids)].sum(0) / np.sqrt(len(ids))
    np.testing.assert_allclose(np.asarray(pu), want, rtol=1e-5, atol=1e-6)


def test_caser_encoder_causal(rng):
    """Caser conv encoder: output at slot t must not see slots > t."""
    from score_tpu.nn.baselines import CaserEncoder
    B, T, d, f = 2, 6, 8, 16
    xs = rng.normal(size=(B, T, d)).astype(np.float32)
    mask = np.ones((B, T), bool)
    enc = CaserEncoder(in_dim=d, features=f)
    params = enc.init(jax.random.PRNGKey(0))
    h1 = enc(params, jnp.asarray(xs), jnp.asarray(mask))
    assert h1.shape == (B, T, f)
    xs2 = xs.copy()
    xs2[:, 4:] = 99.0          # corrupt the future
    h2 = enc(params, jnp.asarray(xs2), jnp.asarray(mask))
    np.testing.assert_allclose(np.asarray(h1)[:, :4], np.asarray(h2)[:, :4],
                               rtol=1e-5, atol=1e-5)


def test_caser_encoder_variant(tiny_dataset):
    cfg = _cfg_with(configs1(), sides="user", seq_encoder="caser",
                    seq_pool="last", target_aware=False)
    g = device_graph(tiny_dataset.graph)
    model = build_model(cfg, tiny_dataset.num_users, tiny_dataset.num_items)
    state = init_state(cfg, model, g, jax.random.PRNGKey(0))
    out = model.apply(state.params, _batch(tiny_dataset, g))
    assert out.shape == (8,)
    assert np.isfinite(np.asarray(out)).all()


def test_baseline_presets_build(tiny_dataset):
    """Every named baseline preset builds, inits, and scores candidates."""
    from score_tpu.config import BASELINE_PRESETS
    from score_tpu.graph import gather_candidate_batch
    g = device_graph(tiny_dataset.graph)
    u = jnp.asarray(tiny_dataset.train.user[:4])
    cand = jnp.asarray(
        np.stack([tiny_dataset.train.item[:4],
                  tiny_dataset.train.item[4:8]], axis=1))
    t = jnp.asarray(tiny_dataset.train.slot[:4])
    cb = gather_candidate_batch(g, u, cand, t)
    for name, mk in BASELINE_PRESETS.items():
        cfg = mk()
        model = build_model(cfg, tiny_dataset.num_users,
                            tiny_dataset.num_items)
        state = init_state(cfg, model, g, jax.random.PRNGKey(0))
        s = model.score_candidates(state.params, cb)
        assert s.shape == (4, 2), name
        assert np.isfinite(np.asarray(s)).all(), name


def test_selfattn_encoder_variant(tiny_dataset):
    cfg = _cfg_with(configs3(), seq_encoder="selfattn")
    g = device_graph(tiny_dataset.graph)
    model = build_model(cfg, tiny_dataset.num_users, tiny_dataset.num_items)
    state = init_state(cfg, model, g, jax.random.PRNGKey(0))
    out = model.apply(state.params, _batch(tiny_dataset, g))
    assert out.shape == (8,)
    assert np.isfinite(np.asarray(out)).all()
    # causality: corrupting future slots must not change targets at t* <= t0
    # (covered structurally by slot_valid masking upstream of the encoder)


def test_selfattn_causal_masking(rng):
    from score_tpu.nn.baselines import SelfAttnEncoder
    B, T, d, f = 2, 6, 8, 16
    xs = rng.normal(size=(B, T, d)).astype(np.float32)
    mask = np.ones((B, T), bool)
    enc = SelfAttnEncoder(in_dim=d, features=f)
    params = enc.init(jax.random.PRNGKey(0))
    h1 = enc(params, jnp.asarray(xs), jnp.asarray(mask))
    xs2 = xs.copy()
    xs2[:, 4:] = 99.0          # corrupt the future
    h2 = enc(params, jnp.asarray(xs2), jnp.asarray(mask))
    np.testing.assert_allclose(np.asarray(h1)[:, :4], np.asarray(h2)[:, :4],
                               rtol=1e-5, atol=1e-5)


def test_scoring_service(tiny_dataset):
    from score_tpu.serve import ScoringService
    cfg = configs3()
    g = device_graph(tiny_dataset.graph)
    model = build_model(cfg, tiny_dataset.num_users, tiny_dataset.num_items)
    state = init_state(cfg, model, g, jax.random.PRNGKey(0))
    svc = ScoringService(cfg, tiny_dataset, state.params)
    items = [1, 2, 3, 5, 7]
    s = svc.score(3, items)
    assert s.shape == (5,)
    # bucketing: different lengths give identical scores for shared prefix
    s2 = svc.score(3, items + [11, 13])
    np.testing.assert_allclose(s, s2[:5], rtol=1e-5, atol=1e-6)
    top_items, top_scores = svc.topk(3, k=4, candidates=np.arange(1, 50))
    assert top_items.shape == (4,)
    assert (np.diff(top_scores) <= 1e-6).all()


def test_scoring_service_from_checkpoint(tiny_dataset, tmp_path):
    from score_tpu.checkpoint import CheckpointManager
    from score_tpu.serve import ScoringService
    cfg = configs3()
    g = device_graph(tiny_dataset.graph)
    model = build_model(cfg, tiny_dataset.num_users, tiny_dataset.num_items)
    state = init_state(cfg, model, g, jax.random.PRNGKey(0))
    mgr = CheckpointManager(str(tmp_path))
    mgr.save("best", state, (0, 0), 0.7, 10)
    svc = ScoringService.from_checkpoint(cfg, tiny_dataset, str(tmp_path))
    assert svc.score(1, [1, 2]).shape == (2,)
    # serving knobs forward through from_checkpoint
    svc2 = ScoringService.from_checkpoint(cfg, tiny_dataset, str(tmp_path),
                                          candidate_chunk=16,
                                          topk_grid_rows=4, slot=2)
    assert (svc2.candidate_chunk, svc2.topk_grid_rows, svc2.slot) == (16, 4, 2)


def test_topk_empty_and_zero_k(tiny_dataset):
    """topk on an empty candidate list / k=0 returns empty arrays instead of
    raising from argpartition."""
    from score_tpu.serve import ScoringService
    cfg = configs3()
    g = device_graph(tiny_dataset.graph)
    model = build_model(cfg, tiny_dataset.num_users, tiny_dataset.num_items)
    state = init_state(cfg, model, g, jax.random.PRNGKey(0))
    svc = ScoringService(cfg, tiny_dataset, state.params)
    for items, scores in (svc.topk(3, k=5, candidates=[]),
                          svc.topk(3, k=0, candidates=[1, 2, 3])):
        assert items.shape == (0,) and scores.shape == (0,)


def test_scoring_service_batch_matches_single(tiny_dataset):
    """score_batch (one-dispatch candidates form) ≡ per-request score()."""
    from score_tpu.serve import ScoringService
    cfg = configs3()
    g = device_graph(tiny_dataset.graph)
    model = build_model(cfg, tiny_dataset.num_users, tiny_dataset.num_items)
    state = init_state(cfg, model, g, jax.random.PRNGKey(0))
    svc = ScoringService(cfg, tiny_dataset, state.params)
    users = [3, 1, 5]
    items = np.array([[1, 2, 3], [4, 5, 6], [7, 8, 2]], np.int32)
    out = svc.score_batch(users, items)
    assert out.shape == (3, 3)
    for r, u in enumerate(users):
        np.testing.assert_allclose(out[r], svc.score(u, items[r]),
                                   rtol=1e-5, atol=1e-5)
    # request-bucket padding invariance: adding a request leaves others fixed
    out2 = svc.score_batch(users + [2], np.vstack([items, items[:1]]))
    np.testing.assert_allclose(out, out2[:3], rtol=1e-5, atol=1e-6)


def test_topk_batch_matches_per_user(tiny_dataset):
    """topk_batch (multi-user catalog path) ≡
    per-user topk — same items, same scores, per row — through the chunked
    merge (candidate_chunk forces multiple blocks), plus the empty edges."""
    from score_tpu.serve import ScoringService
    cfg = configs3()
    g = device_graph(tiny_dataset.graph)
    model = build_model(cfg, tiny_dataset.num_users, tiny_dataset.num_items)
    state = init_state(cfg, model, g, jax.random.PRNGKey(0))
    svc = ScoringService(cfg, tiny_dataset, state.params,
                         candidate_chunk=16)   # catalog -> several blocks
    users = [3, 1, 5]
    bi, bs = svc.topk_batch(users, k=4)
    assert bi.shape == (3, 4) and bs.shape == (3, 4)
    assert (np.diff(bs, axis=1) <= 1e-6).all()
    for r, u in enumerate(users):
        ti, ts = svc.topk(u, k=4)
        np.testing.assert_array_equal(bi[r], ti)
        np.testing.assert_allclose(bs[r], ts, rtol=1e-5, atol=1e-6)
    # shared explicit candidate list + empty edges. 29 candidates with
    # chunk=16 and r=3 -> g=5, width=80: the whole list fits ONE grouped
    # dispatch with 51 item-0 pad positions — exercises the -inf pad mask
    # (an unmasked pad would win top-3 whenever item 0 scores high)
    cand = np.arange(1, 30, dtype=np.int32)
    bi2, bs2 = svc.topk_batch(users, k=3, candidates=cand)
    for r, u in enumerate(users):
        ti, ts = svc.topk(u, k=3, candidates=cand)
        np.testing.assert_array_equal(bi2[r], ti)
    # r=1 takes the widest packing (g = topk_grid_rows): must still match
    bi3, bs3 = svc.topk_batch([3], k=4)
    ti, ts = svc.topk(3, k=4)
    np.testing.assert_array_equal(bi3[0], ti)
    np.testing.assert_allclose(bs3[0], ts, rtol=1e-5, atol=1e-6)
    for bad in (svc.topk_batch(users, k=0), svc.topk_batch([], k=4),
                svc.topk_batch(users, k=3, candidates=[])):
        assert bad[0].shape[1] == 0 and bad[1].shape[1] == 0


def test_scoring_service_matches_model_apply(tiny_dataset):
    """Pin the service path to the flat model forward:
    svc.score == a direct model.apply(__call__) on a gather_batch minibatch
    — an independent oracle, since score() is internally score_batch(R=1)."""
    import jax.numpy as jnp

    from score_tpu.graph import gather_batch
    from score_tpu.serve import ScoringService
    cfg = configs3()
    g = device_graph(tiny_dataset.graph)
    model = build_model(cfg, tiny_dataset.num_users, tiny_dataset.num_items)
    state = init_state(cfg, model, g, jax.random.PRNGKey(0))
    svc = ScoringService(cfg, tiny_dataset, state.params)
    user, items = 3, np.array([1, 4, 9], np.int32)
    got = svc.score(user, items)
    # flat forward: one (user, item) row per candidate, slot = svc.slot
    B = items.size
    mb = gather_batch(g, jnp.full((B,), user, jnp.int32), jnp.asarray(items),
                      jnp.full((B,), svc.slot, jnp.int32))
    want = np.asarray(model.apply(state.params, mb))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_scoring_service_chunked_matches_unchunked(tiny_dataset):
    """Catalog-scale chunking: a candidate list wider
    than candidate_chunk streams through fixed-width blocks and must score
    identically to the one-dispatch path (same jit bucket per block)."""
    from score_tpu.serve import ScoringService
    cfg = configs3()
    g = device_graph(tiny_dataset.graph)
    model = build_model(cfg, tiny_dataset.num_users, tiny_dataset.num_items)
    state = init_state(cfg, model, g, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    items = rng.integers(1, tiny_dataset.num_items + 1,
                         size=(2, 40)).astype(np.int32)
    users = np.array([3, 5], np.int32)
    big = ScoringService(cfg, tiny_dataset, state.params)
    small = ScoringService(cfg, tiny_dataset, state.params,
                           candidate_chunk=16)  # 40 -> blocks 16/16/8
    np.testing.assert_allclose(small.score_batch(users, items),
                               big.score_batch(users, items),
                               rtol=1e-5, atol=1e-5)
    # full-catalog topk through the chunk pipeline agrees with a host argsort
    # over the unchunked scores
    ti, ts = small.topk(3, k=5)
    all_scores = big.score(3, np.arange(1, tiny_dataset.num_items + 1))
    want_idx = np.argsort(-all_scores)[:5]
    np.testing.assert_array_equal(np.sort(ti), np.sort(want_idx + 1))


def test_scoring_service_bf16_table_prep_matches(tiny_dataset):
    """Serving-side bf16 table pre-cast (the r4 catalog-gather fix):
    cast-then-gather commutes with the model's gather-then-astype — BIT
    equal at the embedding stage (same graph); full scores agree to bf16
    resolution (different compiled graphs may fuse bf16 reductions in a
    different order, so whole-model bit-equality is not guaranteed)."""
    import dataclasses

    import jax.numpy as jnp

    from score_tpu.serve import ScoringService
    cfg = configs3()
    cfg = cfg.replace(model=dataclasses.replace(
        cfg.model, compute_dtype="bfloat16"))
    g = device_graph(tiny_dataset.graph)
    model = build_model(cfg, tiny_dataset.num_users, tiny_dataset.num_items)
    state = init_state(cfg, model, g, jax.random.PRNGKey(0))
    svc = ScoringService(cfg, tiny_dataset, state.params)
    # the service really holds bf16 tables...
    ut16 = svc.params["tables"]["user_table"]
    assert ut16.dtype == jnp.bfloat16
    # ...the embedding stage commutes BIT-exactly...
    ut32 = state.params["tables"]["user_table"]
    ids = jnp.asarray([0, 1, 3, 7], jnp.int32)
    np.testing.assert_array_equal(
        np.asarray(jnp.take(ut32, ids, 0).astype(jnp.bfloat16)),
        np.asarray(jnp.take(ut16, ids, 0)))
    # ...and full scores equal a direct apply with the ORIGINAL f32 params
    # to bf16 resolution
    items = np.array([1, 2, 3, 9], np.int32)
    got = svc.score(3, items)
    from score_tpu.graph import gather_candidate_batch
    mb = gather_candidate_batch(g, jnp.asarray([3], jnp.int32),
                                jnp.asarray(items)[None, :],
                                jnp.full((1,), svc.slot, jnp.int32))
    want = np.asarray(model.score_candidates(state.params, mb))[0]
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-3)


def test_scoring_service_sharded_matches_single(tiny_dataset):
    """configs4 serving: a row-sharded service (mesh +
    a2a lookup exchange) scores identically to the single-device service."""
    import jax

    if len(jax.devices()) < 8:
        import pytest
        pytest.skip("needs 8 fake devices")
    from score_tpu.serve import ScoringService
    from score_tpu.sharding import make_lookup_fn, make_mesh
    cfg = configs3()
    g = device_graph(tiny_dataset.graph)
    model = build_model(cfg, tiny_dataset.num_users, tiny_dataset.num_items)
    state = init_state(cfg, model, g, jax.random.PRNGKey(0))
    host_params = jax.device_get(state.params)
    svc1 = ScoringService(cfg, tiny_dataset, state.params)
    mesh = make_mesh(jax.devices()[:8])
    users = np.array([3, 1], np.int32)
    items = np.array([[1, 2, 3], [4, 5, 6]], np.int32)
    want = svc1.score_batch(users, items)
    for lookup in (None, make_lookup_fn(mesh, "a2a")):
        svc = ScoringService(cfg, tiny_dataset, host_params, mesh=mesh,
                             lookup_fn=lookup)
        ut = svc.params["tables"]["user_table"]
        assert not ut.sharding.is_fully_replicated  # really row-sharded
        np.testing.assert_allclose(svc.score_batch(users, items), want,
                                   rtol=1e-5, atol=1e-5)


def test_scoring_service_from_sharded_checkpoint(tiny_dataset, tmp_path):
    """from_checkpoint(mesh=...) restores a row-sharded checkpoint
    directly onto the mesh and serves it (no host gather)."""
    import jax

    if len(jax.devices()) < 8:
        import pytest
        pytest.skip("needs 8 fake devices")
    from score_tpu.checkpoint import CheckpointManager
    from score_tpu.serve import ScoringService
    from score_tpu.sharding import make_mesh, shard_state
    cfg = configs3()
    g = device_graph(tiny_dataset.graph)
    model = build_model(cfg, tiny_dataset.num_users, tiny_dataset.num_items)
    state = init_state(cfg, model, g, jax.random.PRNGKey(0))
    mesh = make_mesh(jax.devices()[:8])
    sharded = shard_state(mesh, state)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save("best", sharded, (0, 0), 0.7, 10, block=True)
    svc1 = ScoringService(cfg, tiny_dataset, state.params)
    svc = ScoringService.from_checkpoint(cfg, tiny_dataset, str(tmp_path),
                                         mesh=mesh)
    ut = svc.params["tables"]["user_table"]
    assert not ut.sharding.is_fully_replicated
    items = np.array([1, 2, 3, 4], np.int32)
    np.testing.assert_allclose(svc.score(3, items), svc1.score(3, items),
                               rtol=1e-5, atol=1e-5)
