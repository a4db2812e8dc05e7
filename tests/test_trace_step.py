"""The HLO side of scripts/trace_step.py: attributing compiled ops to the
model's named scopes, forward and backward, in exclusive buckets."""

import os
import sys

import jax
import jax.numpy as jnp
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts"))
import trace_step  # noqa: E402


def _compiled_hlo():
    def loss(table, w, ids):
        with jax.named_scope("table_gather"):
            e = table[ids]
        with jax.named_scope("coattn"):
            h = jnp.tanh(e @ w)
        return jnp.sum(h * h)

    args = (jnp.ones((64, 8)), jnp.ones((8, 8)),
            jnp.arange(16, dtype=jnp.int32) % 64)
    return jax.jit(jax.grad(loss, argnums=(0, 1))).lower(
        *args).compile().as_text()


def test_hlo_scopes_tag_forward_and_backward_ops():
    tags = set().union(*trace_step.hlo_scopes(_compiled_hlo()).values())
    assert {"coattn", "coattn.fwd", "coattn.bwd",
            "table_gather", "table_gather.bwd"} <= tags


@pytest.mark.parametrize("tags, want", [
    (set(), "unscoped"),
    ({"coattn", "coattn.fwd"}, "coattn fwd"),
    ({"coattn", "coattn.fwd", "coattn.bwd"}, "coattn bwd+fwd"),
    ({"coattn", "coattn.bwd", "table_gather", "table_gather.bwd"},
     "coattn+table_gather bwd"),
])
def test_category_is_one_exclusive_bucket(tags, want):
    assert trace_step.category(tags) == want
