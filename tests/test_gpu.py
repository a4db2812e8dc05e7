"""Tests that need an NVIDIA GPU. Marked `gpu`: they skip on a machine
without one, and `python chip_smoke.py` runs them on the card as one of its
phases (calling each with the card as `gpu_device`)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu_device():
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("no GPU here; runs on the card through chip_smoke.py")


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def test_f32_matmul_precision_on_card(gpu_device):
    """An f32 product at 'highest' matches float64 to f32 noise; at
    'tensorfloat32' it does not. This is why every on-card reference check
    pins the precision."""
    rng = np.random.default_rng(0)
    a = rng.standard_normal((512, 1024)).astype(np.float32)
    b = rng.standard_normal((1024, 256)).astype(np.float32)
    want = a.astype(np.float64) @ b.astype(np.float64)
    da, db = jax.device_put((a, b), gpu_device)
    with jax.default_matmul_precision("highest"):
        hi = jax.jit(jnp.dot)(da, db)
    with jax.default_matmul_precision("tensorfloat32"):
        tf = jax.jit(jnp.dot)(da, db)
    assert _rel(hi, want) < 1e-5, _rel(hi, want)
    assert _rel(tf, want) > 1e-4, _rel(tf, want)


def test_coattn_block_card_matches_host(gpu_device):
    """The candidates-form co-attention block at the flagship widths gives
    the host CPU's values on the card (f32, 'highest')."""
    from score_tpu.nn.coattn import CrossCoAttention

    rng = np.random.default_rng(1)
    B, C, T, n, d = 64, 3, 9, 10, 32
    args = (rng.standard_normal((B, T, n, d)).astype(np.float32),
            rng.standard_normal((B, C, T, n, d)).astype(np.float32),
            rng.random((B, T, n)) > 0.3, rng.random((B, C, T, n)) > 0.3,
            rng.standard_normal((B, d)).astype(np.float32),
            rng.standard_normal((B, C, d)).astype(np.float32))
    blk = CrossCoAttention(dim=d)
    p = jax.tree.map(lambda x: (0.1 * rng.standard_normal(x.shape)
                                ).astype(np.float32),
                     blk.init(jax.random.PRNGKey(0)))
    cpu = jax.devices("cpu")[0]
    with jax.default_matmul_precision("highest"):
        want = jax.jit(blk)(*jax.device_put((p,) + args, cpu))
        got = jax.jit(blk)(*jax.device_put((p,) + args, gpu_device))
    for g, w in zip(got, want):
        assert _rel(g, w) < 2e-5, _rel(g, w)
