"""Scalar math helpers, vectorized over arrays.

TPU-native reimplementation of the reference's math substrate
(/root/reference/src/math.rs, src/float.rs).  Everything here is shape-
polymorphic jnp code usable inside jit/pallas; no Python branching on traced
values.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from shimmer_tpu.config import MACHINE_EPSILON


def sqr(x):
    return x * x


def lerp(t, a, b):
    """(1-t)*a + t*b  (reference: src/math.rs lerp)."""
    return (1.0 - t) * a + t * b


@jax.custom_jvp
def safe_sqrt(x):
    """sqrt clamped to non-negative input (src/math.rs safe_sqrt).

    Custom derivative: clamped near 0 so masked dead lanes cannot poison
    gradients with 0·inf = NaN (forward value is exact)."""
    return jnp.sqrt(jnp.maximum(x, 0.0))


@safe_sqrt.defjvp
def _safe_sqrt_jvp(primals, tangents):
    (x,) = primals
    (dx,) = tangents
    y = jnp.sqrt(jnp.maximum(x, 0.0))
    deriv = jnp.where(x > 1e-12, 0.5 / jnp.maximum(y, 1e-12), 0.0)
    return y, deriv * dx


@jax.custom_jvp
def safe_asin(x):
    return jnp.arcsin(jnp.clip(x, -1.0, 1.0))


@safe_asin.defjvp
def _safe_asin_jvp(primals, tangents):
    (x,) = primals
    (dx,) = tangents
    xc = jnp.clip(x, -1.0, 1.0)
    denom = jnp.sqrt(jnp.maximum(1.0 - xc * xc, 1e-12))
    inside = jnp.abs(x) < 1.0 - 1e-7
    return jnp.arcsin(xc), jnp.where(inside, dx / denom, 0.0)


@jax.custom_jvp
def safe_acos(x):
    return jnp.arccos(jnp.clip(x, -1.0, 1.0))


@safe_acos.defjvp
def _safe_acos_jvp(primals, tangents):
    (x,) = primals
    (dx,) = tangents
    xc = jnp.clip(x, -1.0, 1.0)
    denom = jnp.sqrt(jnp.maximum(1.0 - xc * xc, 1e-12))
    inside = jnp.abs(x) < 1.0 - 1e-7
    return jnp.arccos(xc), jnp.where(inside, -dx / denom, 0.0)


def safe_div(a, b):
    """a/b with 0 where b == 0 (SampledSpectrum::safe_div,
    src/spectra/sampled_spectrum.rs)."""
    return jnp.where(b != 0.0, a / jnp.where(b != 0.0, b, 1.0), 0.0)


def difference_of_products(a, b, c, d):
    """a*b - c*d with an FMA-style error correction term.

    Reference: src/math.rs difference_of_products — keeps cross products and
    determinants robust near cancellation.  Where the compiler contracts
    ``-c * d + cd`` into an FMA the correction term is exact; without
    contraction it is zero and the result is the plain difference.
    """
    cd = c * d
    diff = jnp.float32(a * b - cd)
    err = jnp.float32(-c * d + cd)  # rounding error of c*d
    return diff + err


def sum_of_products(a, b, c, d):
    cd = c * d
    s = a * b + cd
    err = c * d - cd
    return s + err


def quadratic(a, b, c):
    """Solve a*t^2 + b*t + c = 0 robustly.

    Returns (has_solution, t0, t1) with t0 <= t1.  Uses the numerically
    stable form with difference_of_products for the discriminant
    (reference: src/math.rs quadratic).
    """
    disc = difference_of_products(b, b, 4.0 * a, c)
    has = (disc >= 0.0) & (a != 0.0)
    root = safe_sqrt(disc)
    q = -0.5 * (b + jnp.sign(b) * root)
    # sign(0) == 0 would zero q when b == 0; treat b == 0 as positive.
    q = jnp.where(b == 0.0, -0.5 * root, q)
    a_safe = jnp.where(a != 0.0, a, 1.0)
    q_safe = jnp.where(q != 0.0, q, 1.0)
    t0 = q / a_safe
    t1 = jnp.where(q != 0.0, c / q_safe, t0)
    lo = jnp.minimum(t0, t1)
    hi = jnp.maximum(t0, t1)
    # Linear fallback when a == 0: b*t + c = 0.
    lin_ok = (a == 0.0) & (b != 0.0)
    b_safe = jnp.where(b != 0.0, b, 1.0)
    t_lin = -c / b_safe
    has = has | lin_ok
    lo = jnp.where(lin_ok, t_lin, lo)
    hi = jnp.where(lin_ok, t_lin, hi)
    return has, lo, hi


def find_interval(xs, x):
    """Index i such that xs[i] <= x < xs[i+1], clamped to [0, n-2].

    Vectorized binary search (reference: src/math.rs find_interval).  ``xs``
    is a sorted 1-D knot array; ``x`` may have any shape.
    """
    n = xs.shape[-1]
    idx = jnp.searchsorted(xs, x, side="right") - 1
    return jnp.clip(idx, 0, n - 2)


def smooth_step(x, a, b):
    """Hermite smoothstep on [a, b] (src/math.rs smooth_step)."""
    t = jnp.clip(safe_div(x - a, b - a), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def sinc(x):
    """Normalized sinc sin(pi x)/(pi x) (src/math.rs sinc)."""
    px = jnp.pi * x
    small = jnp.abs(x) < 1e-5
    px_safe = jnp.where(small, 1.0, px)
    return jnp.where(small, 1.0, jnp.sin(px_safe) / px_safe)


def windowed_sinc(x, radius, tau):
    """Lanczos-windowed sinc (src/math.rs windowed_sinc)."""
    out = sinc(x) * sinc(x / tau)
    return jnp.where(jnp.abs(x) > radius, 0.0, out)


def next_float_up(x):
    """Next representable f32 above x (src/float.rs:53-74)."""
    return jnp.nextafter(x, jnp.inf)


def next_float_down(x):
    """Next representable f32 below x (src/float.rs:76-97)."""
    return jnp.nextafter(x, -jnp.inf)


def gamma_bound(n):
    """Conservative rounding-error bound gamma(n) (src/float.rs:131-136)."""
    n = jnp.asarray(n, jnp.float32)
    return n * MACHINE_EPSILON / (1.0 - n * MACHINE_EPSILON)


def fast_exp(x):
    return jnp.exp(x)


def log2_int(v):
    """floor(log2(v)) for positive ints."""
    return 31 - jax.lax.clz(jnp.asarray(v, jnp.int32))


def round_up_pow2(v: int) -> int:
    """Next power of two >= v (host-side helper)."""
    v = int(v)
    if v <= 1:
        return 1
    return 1 << (v - 1).bit_length()


def erf_inv(x):
    return jax.scipy.special.erfinv(x)


def logistic(x, s):
    """Logistic distribution pdf (src/math.rs logistic)."""
    x = jnp.abs(x)
    e = jnp.exp(-x / s)
    return e / (s * sqr(1.0 + e))


def logistic_cdf(x, s):
    return 1.0 / (1.0 + jnp.exp(-x / s))


def trimmed_logistic(x, s, a, b):
    return logistic(x, s) / (logistic_cdf(b, s) - logistic_cdf(a, s))


def i0(x):
    """Modified Bessel function of the first kind, order 0 (series)."""
    return jax.scipy.special.i0(x)


def log_i0(x):
    return jnp.where(x > 12.0, x + 0.5 * (jnp.log(1.0 / (2.0 * jnp.pi * x))),
                     jnp.log(i0(x)))


def small_gather(table, idx, limit: int = 32):
    """``table[idx]`` for tables with a tiny leading dim, without a
    per-lane gather: a broadcast one-hot contraction fuses into one
    elementwise pass.  Falls back to real indexing for larger tables."""
    import jax.numpy as jnp

    k = table.shape[0]
    if k > limit:
        return table[idx]
    # Match jit gather semantics: out-of-range ids CLAMP into the table
    # (miss lanes carry id -1; returning zeros instead would NaN the
    # masked-branch gradients of downstream divisions).
    idx = jnp.clip(idx, 0, k - 1)
    oh = idx[..., None] == jnp.arange(k, dtype=idx.dtype)   # (..., K)
    if table.dtype == bool:
        return jnp.any(oh & table, axis=-1)
    shape = oh.shape + (1,) * (table.ndim - 1)
    sel = jnp.where(
        oh.reshape(shape), table, jnp.zeros((), table.dtype)
    )
    return jnp.sum(sel, axis=len(idx.shape), dtype=table.dtype)
