"""GRU / pooling vs hand-rolled numpy recurrence (SURVEY.md §4.2)."""

import jax
import jax.numpy as jnp
import numpy as np

from score_tpu.nn.encoder import GRU, AttnPool, last_pool


def np_gru(xs, mask, Wx, Wh, b):
    """Numpy mirror of the documented cell (linear-before-reset variant)."""
    B, T, d = xs.shape
    f = Wh.shape[0]
    sig = lambda v: 1.0 / (1.0 + np.exp(-v))
    h = np.zeros((B, f))
    out = np.zeros((B, T, f))
    for t in range(T):
        gx = xs[:, t] @ Wx + b
        gh = h @ Wh
        xz, xr, xc = np.split(gx, 3, axis=-1)
        hz, hr, hc = np.split(gh, 3, axis=-1)
        z = sig(xz + hz)
        r = sig(xr + hr)
        c = np.tanh(xc + r * hc)
        h_new = (1 - z) * h + z * c
        h = np.where(mask[:, t][:, None], h_new, h)
        out[:, t] = h
    return out


def test_gru_vs_numpy(rng):
    B, T, d, f = 3, 6, 5, 7
    xs = rng.normal(size=(B, T, d)).astype(np.float32)
    mask = rng.random((B, T)) > 0.3
    mask[0] = True
    mask[1, 3:] = False
    gru = GRU(in_dim=d, features=f)
    p = gru.init(jax.random.PRNGKey(0))
    hs = gru(p, jnp.asarray(xs), jnp.asarray(mask))
    ref = np_gru(xs, mask, np.asarray(p["wx"]), np.asarray(p["wh"]),
                 np.asarray(p["b"]))
    np.testing.assert_allclose(np.asarray(hs), ref, rtol=1e-4, atol=1e-5)


def test_gru_masked_steps_carry_state(rng):
    """Padded steps must carry h through unchanged AND be input-invariant."""
    B, T, d, f = 2, 5, 4, 6
    xs = rng.normal(size=(B, T, d)).astype(np.float32)
    mask = np.ones((B, T), dtype=bool)
    mask[:, 2] = False
    gru = GRU(in_dim=d, features=f)
    params = gru.init(jax.random.PRNGKey(1))
    hs = np.asarray(gru(params, jnp.asarray(xs), jnp.asarray(mask)))
    np.testing.assert_array_equal(hs[:, 2], hs[:, 1])
    xs2 = xs.copy()
    xs2[:, 2] = 99.0
    hs2 = np.asarray(gru(params, jnp.asarray(xs2), jnp.asarray(mask)))
    np.testing.assert_allclose(hs, hs2, atol=1e-6)


def test_attn_pool_masked(rng):
    # candidates form: hs [B,1,T,f] shared, query [B,C,dq]
    B, C, T, f, dq = 3, 2, 5, 6, 4
    hs = rng.normal(size=(B, 1, T, f)).astype(np.float32)
    q = rng.normal(size=(B, C, dq)).astype(np.float32)
    mask = np.ones((B, T), dtype=bool)
    mask[1, 2:] = False
    mask[2] = False
    pool = AttnPool(features=f, query_dim=dq)
    params = pool.init(jax.random.PRNGKey(0))
    assert params["w"].shape == (f, dq)
    # zero-init W -> replace with random for a meaningful numpy check
    W = rng.normal(size=(f, dq)).astype(np.float32)
    params = {"w": jnp.asarray(W)}
    out = np.asarray(pool(params, jnp.asarray(hs), jnp.asarray(q),
                                jnp.asarray(mask)))
    assert out.shape == (B, C, f)
    assert np.all(out[2] == 0.0)                       # all-masked -> zero
    # numpy check for row 1, candidate 0 (2 valid slots)
    scores = (hs[1, 0] @ W @ q[1, 0]) / np.sqrt(dq)
    v = scores[:2]
    e = np.exp(v - v.max())
    a = e / e.sum()
    np.testing.assert_allclose(out[1, 0], a @ hs[1, 0, :2],
                               rtol=1e-4, atol=1e-5)
    # padded values must not affect the pooled output
    hs2 = hs.copy()
    hs2[1, :, 2:] = 1e3
    out2 = np.asarray(pool(params, jnp.asarray(hs2), jnp.asarray(q),
                                 jnp.asarray(mask)))
    np.testing.assert_allclose(out[1], out2[1], atol=1e-5)
    # per-candidate hs path agrees with shared path on tiled input
    hs_t = np.broadcast_to(hs, (B, C, T, f))
    out3 = np.asarray(pool(params, jnp.asarray(hs_t), jnp.asarray(q),
                                 jnp.asarray(mask)))
    np.testing.assert_allclose(out, out3, rtol=1e-5, atol=1e-6)


def test_last_pool(rng):
    B, T, f = 3, 4, 5
    hs = rng.normal(size=(B, T, f)).astype(np.float32)
    mask = np.array([[True, True, False, False],
                     [True, True, True, True],
                     [False, False, False, False]])
    out = np.asarray(last_pool(jnp.asarray(hs), jnp.asarray(mask)))
    np.testing.assert_allclose(out[0], hs[0, 1])
    np.testing.assert_allclose(out[1], hs[1, 3])
    assert np.all(out[2] == 0.0)
