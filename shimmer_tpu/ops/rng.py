"""Counter-based, stateless RNG primitives.

The reference threads a stateful ``SmallRng`` through the render and admits a
determinism hole (start_pixel_sample is a no-op — /root/reference/
src/sampler.rs:117-121; LayeredBxDF draws from an unseeded RNG —
src/bxdf.rs:1011).  This renderer instead derives every random number from a
pure hash of ``(pixel, sample_index, depth, dimension, seed)``:

* fully deterministic and order-independent — required for path-replay
  backprop (the backward pass regenerates identical decisions);
* no sequential state to thread through ``lax`` loops;
* vectorizes perfectly on the VPU (integer mul/xor/shift only).

Mixers are the PCG-family hashes from Jarzynski & Olano, "Hash Functions for
GPU Rendering" (JCGT 2020) — public domain constructions in wide production
use for exactly this purpose.
"""

from __future__ import annotations

import jax.numpy as jnp

from shimmer_tpu.config import ONE_MINUS_EPSILON

_U32 = jnp.uint32


def _u32(x):
    return jnp.asarray(x).astype(_U32)


def pcg_hash(x):
    """pcg32-style permutation of a uint32 word."""
    x = _u32(x)
    state = x * _U32(747796405) + _U32(2891336453)
    word = ((state >> ((state >> _U32(28)) + _U32(4))) ^ state) * _U32(277803737)
    return (word >> _U32(22)) ^ word


def hash_combine(*xs):
    """Mix several uint32 words into one (boost-style combine + pcg finalize)."""
    h = _U32(0x9E3779B9)
    for x in xs:
        h = pcg_hash(h ^ _u32(x))
    return h


def pcg3d(v0, v1, v2):
    """3-in/3-out correlated-free hash (Jarzynski & Olano pcg3d)."""
    x, y, z = _u32(v0), _u32(v1), _u32(v2)
    x = x * _U32(1664525) + _U32(1013904223)
    y = y * _U32(1664525) + _U32(1013904223)
    z = z * _U32(1664525) + _U32(1013904223)
    x = x + y * z
    y = y + z * x
    z = z + x * y
    x = x ^ (x >> _U32(16))
    y = y ^ (y >> _U32(16))
    z = z ^ (z >> _U32(16))
    x = x + y * z
    y = y + z * x
    z = z + x * y
    return x, y, z


def pcg4d(v0, v1, v2, v3):
    """4-in/4-out hash (Jarzynski & Olano pcg4d)."""
    x, y, z, w = _u32(v0), _u32(v1), _u32(v2), _u32(v3)
    x = x * _U32(1664525) + _U32(1013904223)
    y = y * _U32(1664525) + _U32(1013904223)
    z = z * _U32(1664525) + _U32(1013904223)
    w = w * _U32(1664525) + _U32(1013904223)
    x = x + y * w
    y = y + z * x
    z = z + x * y
    w = w + y * z
    x = x ^ (x >> _U32(16))
    y = y ^ (y >> _U32(16))
    z = z ^ (z >> _U32(16))
    w = w ^ (w >> _U32(16))
    x = x + y * w
    y = y + z * x
    z = z + x * y
    w = w + y * z
    return x, y, z, w


def u32_to_unit_float(u):
    """Map uint32 → float32 in [0, 1).

    Uses the top 24 bits so every value is exactly representable; clamps to
    ONE_MINUS_EPSILON to keep samples strictly < 1 (the reference does the
    same clamp for its uniform draws).
    """
    f = (_u32(u) >> _U32(8)).astype(jnp.float32) * jnp.float32(1.0 / (1 << 24))
    return jnp.minimum(f, ONE_MINUS_EPSILON)


def uniform_1d(pixel_hash, sample_index, dim):
    """One uniform float per lane from the (pixel, sample, dim) counter."""
    x, _, _ = pcg3d(pixel_hash, sample_index, dim)
    return u32_to_unit_float(x)


def uniform_2d(pixel_hash, sample_index, dim):
    """Two uniform floats per lane."""
    x, y, _ = pcg3d(pixel_hash, sample_index, dim)
    return u32_to_unit_float(x), u32_to_unit_float(y)


def uniform_3d(pixel_hash, sample_index, dim):
    x, y, z = pcg3d(pixel_hash, sample_index, dim)
    return u32_to_unit_float(x), u32_to_unit_float(y), u32_to_unit_float(z)
