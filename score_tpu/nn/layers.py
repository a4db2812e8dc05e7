"""Plain-JAX building blocks.

Every block is a frozen dataclass holding its static shape: `init(key)`
builds its parameter dict and `__call__(params, ...)` is the pure forward.
Parameter names and initializer distributions follow the common
conventions (`kernel`/`bias` for affine maps, LeCun-normal kernels, zero
biases, unit LayerNorm scales), so a param tree reads the same as it did
when the model was written against a module library.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Optional

import jax
import jax.numpy as jnp

lecun_normal = jax.nn.initializers.lecun_normal()
zeros = jax.nn.initializers.zeros
ones = jax.nn.initializers.ones


def subkey(key: jax.Array, name: str) -> jax.Array:
    """Key for a named child: a fold of the name's CRC, so each parameter's
    draw depends on its name only, never on the order blocks are built."""
    return jax.random.fold_in(key, zlib.crc32(name.encode()))


def _promote(dtype: Optional[str], *xs) -> jnp.dtype:
    """Compute dtype: the explicit one, else the promotion of inputs and
    params (a bf16 activation meeting an f32 param computes in f32)."""
    return jnp.dtype(dtype) if dtype else jnp.result_type(*xs)


@dataclasses.dataclass(frozen=True)
class Dense:
    """y = x @ kernel + bias over the last axis."""

    in_dim: int
    features: int
    dtype: Optional[str] = None

    def init(self, key):
        return {"kernel": lecun_normal(key, (self.in_dim, self.features)),
                "bias": zeros(key, (self.features,))}

    def __call__(self, p, x):
        dt = _promote(self.dtype, x, p["kernel"])
        return (jnp.asarray(x, dt) @ jnp.asarray(p["kernel"], dt)
                + jnp.asarray(p["bias"], dt))


@dataclasses.dataclass(frozen=True)
class LayerNorm:
    """Normalize over the last axis (statistics in at least f32)."""

    dim: int
    eps: float = 1e-6

    def init(self, key):
        return {"scale": ones(key, (self.dim,)),
                "bias": zeros(key, (self.dim,))}

    def __call__(self, p, x):
        dt = _promote(None, x, p["scale"])
        xf = x.astype(jnp.promote_types(dt, jnp.float32))
        mean = jnp.mean(xf, axis=-1, keepdims=True)
        var = jnp.mean(jnp.square(xf - mean), axis=-1, keepdims=True)
        y = (xf - mean) * jax.lax.rsqrt(var + self.eps)
        return (y * p["scale"] + p["bias"]).astype(dt)


def dropout(x, rate: float, key: Optional[jax.Array], train: bool):
    """Inverted dropout; identity unless training with rate > 0."""
    if not train or rate <= 0.0:
        return x
    if key is None:
        raise ValueError("dropout with rate > 0 needs an rng key in training")
    keep = jax.random.bernoulli(key, 1.0 - rate, x.shape)
    return jnp.where(keep, x / (1.0 - rate), jnp.zeros_like(x))


@dataclasses.dataclass(frozen=True)
class CausalConv:
    """1-D convolution over axis 1, left-padded so output t sees inputs
    <= t only. x: [B, T, in_dim] -> [B, T, features]."""

    in_dim: int
    features: int
    width: int

    def init(self, key):
        return {"kernel": lecun_normal(
                    key, (self.width, self.in_dim, self.features)),
                "bias": zeros(key, (self.features,))}

    def __call__(self, p, x):
        dt = _promote(None, x, p["kernel"])
        T = x.shape[1]
        xp = jnp.pad(jnp.asarray(x, dt),
                     ((0, 0), (self.width - 1, 0), (0, 0)))
        k = jnp.asarray(p["kernel"], dt)
        out = sum(jnp.einsum("btd,df->btf", xp[:, j:j + T], k[j])
                  for j in range(self.width))
        return out + jnp.asarray(p["bias"], dt)


@dataclasses.dataclass(frozen=True)
class MultiHeadAttention:
    """Multi-head dot-product self-attention with input and output
    projections. x: [B, T, dim], mask: [B, 1|H, T, T] bool -> [B, T, dim]."""

    dim: int
    num_heads: int

    def init(self, key):
        h, hd = self.num_heads, self.dim // self.num_heads

        def proj(name):
            return {"kernel": lecun_normal(subkey(key, name),
                                           (self.dim, self.dim)
                                           ).reshape(self.dim, h, hd),
                    "bias": zeros(key, (h, hd))}
        return {"query": proj("query"), "key": proj("key"),
                "value": proj("value"),
                "out": {"kernel": lecun_normal(subkey(key, "out"),
                                               (self.dim, self.dim)
                                               ).reshape(h, hd, self.dim),
                        "bias": zeros(key, (self.dim,))}}

    def __call__(self, p, x, mask):
        dt = _promote(None, x, p["query"]["kernel"])
        x = jnp.asarray(x, dt)

        def proj(name):
            k = jnp.asarray(p[name]["kernel"], dt)
            return (jnp.einsum("btd,dhk->bthk", x, k)
                    + jnp.asarray(p[name]["bias"], dt))
        q, k, v = proj("query"), proj("key"), proj("value")
        q = q / jnp.sqrt(jnp.asarray(q.shape[-1], dt))
        logits = jnp.einsum("bqhd,bkhd->bhqk", q, k)
        logits = jnp.where(mask, logits, jnp.finfo(dt).min)
        w = jax.nn.softmax(logits, axis=-1)
        y = jnp.einsum("bhqk,bkhd->bqhd", w, v)
        out = jnp.asarray(p["out"]["kernel"], dt)
        return (jnp.einsum("bqhd,hdf->bqf", y, out)
                + jnp.asarray(p["out"]["bias"], dt))
