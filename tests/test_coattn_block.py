"""CrossCoAttention (candidates path and per-pair path) against the plain
references, over a shape grid with fully padded slots: `cross_coattn_ref`
per candidate, and the candidates-form oracle `cross_coattn_cand_ref`
below."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from score_tpu.nn.coattn import CrossCoAttention, cross_coattn_ref

_NEG = -1e9


def cross_coattn_cand_ref(Eu, Ei, mu, mi, Wr, eu, ei,
                          target_aware: bool = True):
    """Plain (non-reassociated, non-unrolled) candidates-form sum-pool
    co-attention: Eu [B,T,n,d], Ei [B,C,T,m,d], mu [B,T,n], mi [B,C,T,m],
    Wr [d,d], eu [B,d], ei [B,C,d] (targets already projected) ->
    cu, ci [B,C,T,d]."""
    d = Eu.shape[-1]
    scale = 1.0 / jnp.sqrt(jnp.asarray(d, jnp.float32))
    Eu = Eu.astype(jnp.float32)
    Ei = Ei.astype(jnp.float32)
    muf = mu.astype(jnp.float32)
    mif = mi.astype(jnp.float32)
    EuW = jnp.einsum("btnd,de->btne", Eu, Wr.astype(jnp.float32))
    EuW_sum = jnp.sum(EuW * muf[..., None], axis=2)             # [B,T,d]
    Ei_sum = jnp.sum(Ei * mif[..., None], axis=3)               # [B,C,T,d]
    su = jnp.einsum("btnd,bctd->bctn", EuW, Ei_sum) * scale
    si = jnp.einsum("bctmd,btd->bctm", Ei, EuW_sum) * scale
    if target_aware:
        su = su + jnp.einsum("btnd,bcd->bctn", Eu,
                             ei.astype(jnp.float32)) * scale
        si = si + jnp.einsum("bctmd,bd->bctm", Ei,
                             eu.astype(jnp.float32)) * scale

    def smax(s, mask):
        s = jnp.where(mask > 0, s, _NEG)
        s = s - jnp.max(s, axis=-1, keepdims=True)
        e = jnp.exp(s) * mask
        return e / jnp.maximum(jnp.sum(e, axis=-1, keepdims=True), 1e-20)

    a = smax(su, muf[:, None])
    b = smax(si, mif)
    cu = jnp.einsum("bctn,btnd->bctd", a, Eu)
    ci = jnp.einsum("bctm,bctmd->bctd", b, Ei)
    return cu, ci


def _cand_inputs(rng, B, C, T, n, m, d):
    Eu = jnp.asarray(rng.normal(size=(B, T, n, d)).astype(np.float32))
    Ei = jnp.asarray(rng.normal(size=(B, C, T, m, d)).astype(np.float32))
    mu = rng.random((B, T, n)) > 0.35
    mi = rng.random((B, C, T, m)) > 0.35
    mu[0, 0] = False                      # fully padded slots on both sides
    if B > 1 and T > 1:
        mi[1, :, 1] = False
    eu = jnp.asarray(rng.normal(size=(B, d)).astype(np.float32))
    ei = jnp.asarray(rng.normal(size=(B, C, d)).astype(np.float32))
    return Eu, Ei, jnp.asarray(mu), jnp.asarray(mi), eu, ei


def _params(rng, blk):
    """The block's params moved off their zero init."""
    return jax.tree.map(
        lambda x: jnp.asarray(rng.normal(size=x.shape).astype(np.float32))
        * 0.3, blk.init(jax.random.PRNGKey(0)))


def _per_candidate_ref(p, Eu, Ei, mu, mi, eu, ei, pool, target_aware):
    """cross_coattn_ref per candidate on the block's projected targets."""
    if target_aware:
        eu = jnp.einsum("de,be->bd", p["wti"], eu)
        ei = jnp.einsum("de,bce->bcd", p["wtu"], ei)
    outs = [cross_coattn_ref(Eu, Ei[:, c], mu, mi[:, c], p["wr"], eu,
                             ei[:, c], pool=pool, target_aware=target_aware)
            for c in range(Ei.shape[1])]
    return (jnp.stack([o[0] for o in outs], 1),
            jnp.stack([o[1] for o in outs], 1))


# B*T below / equal / above the old tile sizes, odd everything
SHAPES = [
    (2, 3, 5, 6, 8),
    (4, 8, 10, 10, 16),
    (3, 7, 9, 11, 32),
]


@pytest.mark.parametrize("B,T,n,m,d", SHAPES)
@pytest.mark.parametrize("pool", ["sum", "mean", "max"])
@pytest.mark.parametrize("target_aware", [True, False])
def test_coattn_block_matches_ref(rng, B, T, n, m, d, pool, target_aware):
    """sum/mean run the candidates path, max the per-pair path."""
    C = 2
    Eu, Ei, mu, mi, eu, ei = _cand_inputs(rng, B, C, T, n, m, d)
    blk = CrossCoAttention(dim=d, pool=pool, target_aware=target_aware)
    p = _params(rng, blk)
    got = blk(p, Eu, Ei, mu, mi, eu, ei)
    want = _per_candidate_ref(p, Eu, Ei, mu, mi, eu, ei, pool, target_aware)
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("pool", ["sum", "mean", "max"])
@pytest.mark.parametrize("target_aware", [True, False])
def test_coattn_block_grads_match_ref(rng, pool, target_aware):
    """Grads wrt the neighbor tensors, the targets and every param."""
    B, C, T, n, m, d = 2, 2, 4, 6, 7, 16
    Eu, Ei, mu, mi, eu, ei = _cand_inputs(rng, B, C, T, n, m, d)
    blk = CrossCoAttention(dim=d, pool=pool, target_aware=target_aware)
    p = _params(rng, blk)

    def loss(fn):
        def f(p_, Eu_, Ei_, eu_, ei_):
            cu, ci = fn(p_, Eu_, Ei_, mu, mi, eu_, ei_)
            return jnp.sum(cu ** 2) + jnp.sum(ci * cu)
        return f

    ref = lambda p_, *a: _per_candidate_ref(p_, *a, pool, target_aware)
    args = (p, Eu, Ei, eu, ei)
    g_blk = jax.grad(loss(blk), argnums=(0, 1, 2, 3, 4))(*args)
    g_ref = jax.grad(loss(ref), argnums=(0, 1, 2, 3, 4))(*args)
    for a, b in zip(jax.tree.leaves(g_blk), jax.tree.leaves(g_ref)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=5e-4, atol=5e-5)


@pytest.mark.parametrize("B,C,T,n,m,d,ta",
                         [(4, 2, 3, 5, 6, 8, True),
                          (4, 2, 3, 5, 6, 8, False),
                          (3, 4, 2, 4, 3, 16, True),
                          (5, 1, 4, 6, 5, 8, True),     # C == 1 (flat pairs)
                          (3, 12, 2, 4, 3, 8, True)])   # C > 8: generic path
def test_candidates_path_matches_cand_ref(rng, B, C, T, n, m, d, ta):
    Eu, Ei, mu, mi, eu, ei = _cand_inputs(rng, B, C, T, n, m, d)
    blk = CrossCoAttention(dim=d, pool="sum", target_aware=ta)
    p = _params(rng, blk)
    got = blk(p, Eu, Ei, mu, mi, eu, ei)
    if ta:
        eu = jnp.einsum("de,be->bd", p["wti"], eu)
        ei = jnp.einsum("de,bce->bcd", p["wtu"], ei)
    want = cross_coattn_cand_ref(Eu, Ei, mu, mi, p["wr"], eu, ei,
                                 target_aware=ta)
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("ta", [True, False])
def test_candidates_path_grads_match_cand_ref(rng, ta):
    """All five input grads (Eu, Ei, Wr, eu, ei) through the raw-target
    form: the block's target projections are pinned to identity."""
    B, C, T, n, m, d = 5, 2, 3, 4, 6, 8
    Eu, Ei, mu, mi, eu, ei = _cand_inputs(rng, B, C, T, n, m, d)
    Wr = jnp.asarray(rng.normal(size=(d, d)).astype(np.float32)) * 0.3
    blk = CrossCoAttention(dim=d, pool="sum", target_aware=ta)
    eye = jnp.eye(d, dtype=jnp.float32)
    dcu = jnp.asarray(rng.normal(size=(B, C, T, d)).astype(np.float32))
    dci = jnp.asarray(rng.normal(size=(B, C, T, d)).astype(np.float32))

    def b_fn(Eu_, Ei_, Wr_, eu_, ei_):
        p = {"wr": Wr_, "wtu": eye, "wti": eye} if ta else {"wr": Wr_}
        return blk(p, Eu_, Ei_, mu, mi, eu_, ei_)

    def r_fn(Eu_, Ei_, Wr_, eu_, ei_):
        return cross_coattn_cand_ref(Eu_, Ei_, mu, mi, Wr_, eu_, ei_,
                                     target_aware=ta)

    _, b_vjp = jax.vjp(b_fn, Eu, Ei, Wr, eu, ei)
    _, r_vjp = jax.vjp(r_fn, Eu, Ei, Wr, eu, ei)
    for g, w_, name in zip(b_vjp((dcu, dci)), r_vjp((dcu, dci)),
                           ("dEu", "dEi", "dWr", "deu", "dei")):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w_),
                                   rtol=1e-4, atol=1e-5, err_msg=name)


def test_pairflat_switch_matches_candidates_path(rng):
    """force_pairflat (tile the shared side, per-pair ref) == the unrolled
    candidates path."""
    B, C, T, n, m, d = 3, 3, 4, 5, 6, 8
    Eu, Ei, mu, mi, eu, ei = _cand_inputs(rng, B, C, T, n, m, d)
    p = _params(rng, CrossCoAttention(dim=d))
    got = CrossCoAttention(dim=d, force_pairflat=True)(
        p, Eu, Ei, mu, mi, eu, ei)
    want = CrossCoAttention(dim=d)(p, Eu, Ei, mu, mi, eu, ei)
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                   rtol=1e-5, atol=1e-5)


def test_coattn_block_under_jit(rng):
    B, C, T, n, m, d = 2, 2, 5, 4, 6, 8
    Eu, Ei, mu, mi, eu, ei = _cand_inputs(rng, B, C, T, n, m, d)
    blk = CrossCoAttention(dim=d)
    p = _params(rng, blk)
    got = jax.jit(blk)(p, Eu, Ei, mu, mi, eu, ei)
    want = blk(p, Eu, Ei, mu, mi, eu, ei)
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                   rtol=1e-5, atol=1e-5)
