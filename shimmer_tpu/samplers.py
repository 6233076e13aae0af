"""Samplers: per-lane random number streams.

TPU-native analog of /root/reference/src/sampler.rs.  The reference has one
sampler (IndependentSampler over a stateful SmallRng, with an acknowledged
per-pixel determinism hole, sampler.rs:117-121).  Here a sampler is a pure
function of (pixel, sample_index, dimension): IndependentSampler hashes the
counter (pcg3d); ZSobolSampler (added per BASELINE config #2 — net-new vs
the reference, SURVEY.md §2.1) evaluates Owen-scrambled base-2 Sobol' points
indexed along a randomized Morton curve, following pbrt-v4's design.

All samplers share the functional interface:
    state = sampler.start_pixel_sample(pixel_xy, sample_index)
    u, state = sampler.get_1d(state)
    u2, state = sampler.get_2d(state)
Dimension allocation is a traced counter; replaying the same call sequence
reproduces the same values exactly (required for path-replay backprop).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from shimmer_tpu.ops import rng as srng
from shimmer_tpu.ops.rng import _U32
from shimmer_tpu.utils.pytree import pytree_dataclass
from shimmer_tpu.ops.vecmath import vec2


@pytree_dataclass
class SamplerState:
    pixel_hash: jnp.ndarray   # uint32 (...,) — hash of pixel + seed
    sample_index: jnp.ndarray  # uint32 (...,)
    dim: jnp.ndarray          # uint32 (...,) — next dimension to consume


class IndependentSampler:
    """Counter-hash uniform sampler (analog of src/sampler.rs:82-137,
    with the determinism hole fixed)."""

    def __init__(self, samples_per_pixel: int, seed: int = 0):
        self.samples_per_pixel = int(samples_per_pixel)
        self.seed = int(seed)

    def start_pixel_sample(self, pixel_xy, sample_index, dim0: int = 0) -> SamplerState:
        px = jnp.asarray(pixel_xy[..., 0], jnp.uint32)
        py = jnp.asarray(pixel_xy[..., 1], jnp.uint32)
        ph = srng.hash_combine(px, py, jnp.uint32(self.seed))
        return SamplerState(
            pixel_hash=ph,
            sample_index=jnp.asarray(sample_index, jnp.uint32)
            * jnp.ones_like(ph),
            dim=jnp.full_like(ph, dim0),
        )

    def get_1d(self, state: SamplerState):
        u = srng.uniform_1d(state.pixel_hash, state.sample_index, state.dim)
        return u, SamplerState(
            pixel_hash=state.pixel_hash,
            sample_index=state.sample_index,
            dim=state.dim + _U32(1),
        )

    def get_2d(self, state: SamplerState):
        ux, uy = srng.uniform_2d(state.pixel_hash, state.sample_index, state.dim)
        return vec2(ux, uy), SamplerState(
            pixel_hash=state.pixel_hash,
            sample_index=state.sample_index,
            dim=state.dim + _U32(2),
        )

    def get_pixel_2d(self, state: SamplerState):
        return self.get_2d(state)


# --- Sobol' machinery (pbrt-v4 ZSobolSampler design) ---


def _sobol_matrices_dim2() -> np.ndarray:
    """Generator matrices (as 32 uint32 column masks) for the first two
    Sobol' dimensions.  Dim 0 is the van der Corput sequence (identity
    matrix = bit reversal); dim 1 uses the standard direction numbers from
    the primitive polynomial x^2+x+1 with m = (1, 3, 5, 15, 17, ...)."""
    cols = np.zeros((2, 32), np.uint32)
    # dim 0: v_j = 2^(31-j)
    for j in range(32):
        cols[0, j] = np.uint32(1) << np.uint32(31 - j)
    # dim 1: poly x^2+x+1 (a=1): m_j = 2 m_{j-1} XOR 4 m_{j-2} XOR m_{j-2}
    m = [1, 3]
    for j in range(2, 32):
        m.append((2 * m[j - 1]) ^ (4 * m[j - 2]) ^ m[j - 2])
    for j in range(32):
        cols[1, j] = np.uint32(m[j] << (31 - j))
    return cols


# Column masks as PYTHON ints: indexing a closed-over device array in a
# python loop emits per-element dynamic-slices that defeat fusion.
_SOBOL_COLS = [[int(c) for c in row] for row in _sobol_matrices_dim2()]


def sobol_sample_u32(index, dim_cols, max_bits: int = 32):
    """Multiply index (uint32 lanes) by a Sobol' generator matrix.

    index: (...,) uint32; dim_cols: list of 32 python-int column masks →
    (...,) uint32 sample (radical-inverse bits).  max_bits bounds the
    loop when the caller knows the index width.

    Vectorized: one (..., bits) broadcast + XOR reduction instead of an
    unrolled 32-op chain (compiles ~30x smaller; the constants ride as a
    single array, never python-indexed — see module note above).
    """
    nb = min(32, max_bits)
    cols = jnp.asarray(np.asarray(dim_cols[:nb], np.uint32))
    shifts = jnp.arange(nb, dtype=jnp.uint32)
    bits = (index[..., None] >> shifts) & _U32(1)
    terms = jnp.where(bits != 0, cols, _U32(0))
    return jax.lax.reduce(
        terms, np.uint32(0), jax.lax.bitwise_xor, (terms.ndim - 1,)
    )


def fast_owen_scramble(v, seed):
    """Laine-Karras style hash-based Owen scrambling (pbrt FastOwenScrambler)."""
    v = jnp.asarray(v, jnp.uint32)
    seed = jnp.asarray(seed, jnp.uint32)
    v = _reverse_bits32(v)
    v = v ^ (v * _U32(0x3D20ADEA))
    v = v + seed
    v = v * ((seed >> _U32(16)) | _U32(1))
    v = v ^ (v * _U32(0x05526C56))
    v = v ^ (v * _U32(0x53A22864))
    return _reverse_bits32(v)


def _reverse_bits32(v):
    v = ((v >> _U32(1)) & _U32(0x55555555)) | ((v & _U32(0x55555555)) << _U32(1))
    v = ((v >> _U32(2)) & _U32(0x33333333)) | ((v & _U32(0x33333333)) << _U32(2))
    v = ((v >> _U32(4)) & _U32(0x0F0F0F0F)) | ((v & _U32(0x0F0F0F0F)) << _U32(4))
    v = ((v >> _U32(8)) & _U32(0x00FF00FF)) | ((v & _U32(0x00FF00FF)) << _U32(8))
    return (v >> _U32(16)) | (v << _U32(16))


def _encode_morton2(x, y):
    """Interleave bits of 16-bit x, y into a 32-bit Morton code."""

    def spread(v):
        v = (v | (v << _U32(8))) & _U32(0x00FF00FF)
        v = (v | (v << _U32(4))) & _U32(0x0F0F0F0F)
        v = (v | (v << _U32(2))) & _U32(0x33333333)
        v = (v | (v << _U32(1))) & _U32(0x55555555)
        return v

    return (spread(jnp.asarray(y, jnp.uint32)) << _U32(1)) | spread(
        jnp.asarray(x, jnp.uint32)
    )


# Base-4 digit permutations used by the randomized Morton ordering
# (pbrt-v4 ZSobolSampler::GetSampleIndex).
_PERMUTATIONS_NP = np.array(
    [
        [0, 1, 2, 3], [0, 1, 3, 2], [0, 2, 1, 3], [0, 2, 3, 1],
        [0, 3, 2, 1], [0, 3, 1, 2], [1, 0, 2, 3], [1, 0, 3, 2],
        [1, 2, 0, 3], [1, 2, 3, 0], [1, 3, 2, 0], [1, 3, 0, 2],
        [2, 1, 0, 3], [2, 1, 3, 0], [2, 0, 1, 3], [2, 0, 3, 1],
        [2, 3, 0, 1], [2, 3, 1, 0], [3, 1, 2, 0], [3, 1, 0, 2],
        [3, 2, 1, 0], [3, 2, 0, 1], [3, 0, 2, 1], [3, 0, 1, 2],
    ],
    np.uint32,
)
# Each permutation packed 2 bits/digit so the whole row is one select:
# a 24-entry table lookup as a broadcast compare+select chain fuses into
# the surrounding elementwise code, where a per-lane gather would not.
_PERM_PACKED = [
    int(sum(int(row[d]) << (2 * d) for d in range(4)))
    for row in _PERMUTATIONS_NP
]


def _perm_digit(p, digit):
    """_PERMUTATIONS[p, digit] via packed constants + one-hot reduce."""
    table = jnp.asarray(np.asarray(_PERM_PACKED, np.uint32))
    oh = p[..., None] == jnp.arange(24, dtype=p.dtype)
    packed = jnp.sum(
        jnp.where(oh, table, _U32(0)), axis=-1, dtype=jnp.uint32
    )
    return (packed >> (digit << _U32(1))) & _U32(3)


class ZSobolSampler:
    """Z-order (Morton) scrambled Sobol' sampler — pbrt-v4's default-quality
    sampler; blue-noise-ish error distribution from randomized Morton
    ordering + Owen-scrambled base-2 Sobol' points."""

    def __init__(self, samples_per_pixel: int, resolution, seed: int = 0):
        spp = int(samples_per_pixel)
        self.samples_per_pixel = spp
        self.seed = int(seed)
        self.log2_spp = max(0, (spp - 1).bit_length())
        res = int(max(resolution))
        log4_spp = (self.log2_spp + 1) // 2
        self.n_base4_digits = max(1, (res - 1).bit_length()) + log4_spp
        # sample indices carry at most this many bits — bounds the Sobol
        # matrix loop (every skipped iteration is 3 vector ops saved).
        self._index_bits = min(32, 2 * self.n_base4_digits)

    def start_pixel_sample(self, pixel_xy, sample_index, dim0: int = 0) -> SamplerState:
        px = jnp.asarray(pixel_xy[..., 0], jnp.uint32)
        py = jnp.asarray(pixel_xy[..., 1], jnp.uint32)
        morton = (_encode_morton2(px, py) << _U32(self.log2_spp)) | jnp.asarray(
            sample_index, jnp.uint32
        )
        return SamplerState(
            pixel_hash=morton,  # reuse field: morton index
            sample_index=jnp.asarray(sample_index, jnp.uint32) * jnp.ones_like(px),
            dim=jnp.full_like(px, dim0),
        )

    def _sample_index(self, state: SamplerState):
        """Randomized Morton index (pbrt ZSobolSampler::GetSampleIndex).

        Each base-4 digit's permutation depends only on (morton, dim), not
        on the other digits — so all rounds evaluate as ONE batched
        (..., D) computation + an OR reduction instead of a sequential
        unrolled chain (12x less program, full VPU width)."""
        morton = state.pixel_hash
        dim = state.dim
        pow2_samples = (self.log2_spp & 1) == 1
        last_digit = 1 if pow2_samples else 0
        i_vals = np.arange(self.n_base4_digits - 1, last_digit - 1, -1)
        shifts = jnp.asarray(
            (2 * i_vals - (1 if pow2_samples else 0)).astype(np.uint32)
        )
        m = morton[..., None]
        digit = (m >> shifts) & _U32(3)
        higher = m >> (shifts + _U32(2))
        # p = hash % 24 without integer division: fixed-point scale of
        # the top 16 bits.
        h = srng.hash_combine(higher, dim[..., None], _U32(self.seed))
        p = ((h >> _U32(16)) * _U32(24)) >> _U32(16)
        dig = _perm_digit(p, digit)                       # (..., D)
        sample_index = jax.lax.reduce(
            dig << shifts, np.uint32(0), jax.lax.bitwise_or,
            (dig.ndim - 1,),
        )
        if pow2_samples:
            digit0 = morton & _U32(1)
            sample_index = sample_index | (
                digit0
                ^ (
                    srng.hash_combine(
                        morton >> _U32(1), dim, _U32(self.seed)
                    )
                    & _U32(1)
                )
            )
        return sample_index

    def get_1d(self, state: SamplerState):
        idx = self._sample_index(state)
        h = srng.hash_combine(state.dim, _U32(self.seed))
        v = sobol_sample_u32(idx, _SOBOL_COLS[0], self._index_bits)
        v = fast_owen_scramble(v, h)
        u = srng.u32_to_unit_float(v)
        return u, SamplerState(
            pixel_hash=state.pixel_hash,
            sample_index=state.sample_index,
            dim=state.dim + _U32(1),
        )

    def get_2d(self, state: SamplerState):
        idx = self._sample_index(state)
        h = srng.hash_combine(state.dim, _U32(self.seed))
        vx = fast_owen_scramble(
            sobol_sample_u32(idx, _SOBOL_COLS[0], self._index_bits), h
        )
        vy = fast_owen_scramble(
            sobol_sample_u32(idx, _SOBOL_COLS[1], self._index_bits),
            h ^ _U32(0x55555555),
        )
        u = vec2(srng.u32_to_unit_float(vx), srng.u32_to_unit_float(vy))
        return u, SamplerState(
            pixel_hash=state.pixel_hash,
            sample_index=state.sample_index,
            dim=state.dim + _U32(2),
        )

    def get_pixel_2d(self, state: SamplerState):
        return self.get_2d(state)


class StratifiedSampler:
    """Jittered stratified sampler (pbrt-v4; net-new vs the reference,
    SURVEY.md §2.1).  spp must be x_samples * y_samples."""

    def __init__(self, x_samples: int, y_samples: int, jitter: bool = True, seed: int = 0):
        self.x_samples = int(x_samples)
        self.y_samples = int(y_samples)
        self.samples_per_pixel = self.x_samples * self.y_samples
        self.jitter = bool(jitter)
        self.seed = int(seed)

    def start_pixel_sample(self, pixel_xy, sample_index, dim0: int = 0) -> SamplerState:
        px = jnp.asarray(pixel_xy[..., 0], jnp.uint32)
        py = jnp.asarray(pixel_xy[..., 1], jnp.uint32)
        ph = srng.hash_combine(px, py, jnp.uint32(self.seed))
        return SamplerState(
            pixel_hash=ph,
            sample_index=jnp.asarray(sample_index, jnp.uint32) * jnp.ones_like(ph),
            dim=jnp.full_like(ph, dim0),
        )

    def _stratum(self, state):
        """Per-dimension shuffled stratum index."""
        n = _U32(self.samples_per_pixel)
        h = srng.hash_combine(state.pixel_hash, state.dim)
        return (state.sample_index + h) % n

    def get_1d(self, state: SamplerState):
        s = self._stratum(state)
        jit = (
            srng.uniform_1d(state.pixel_hash, state.sample_index, state.dim)
            if self.jitter
            else 0.5
        )
        u = (s.astype(jnp.float32) + jit) / self.samples_per_pixel
        return u, SamplerState(
            pixel_hash=state.pixel_hash,
            sample_index=state.sample_index,
            dim=state.dim + _U32(1),
        )

    def get_2d(self, state: SamplerState):
        s = self._stratum(state)
        x = s % _U32(self.x_samples)
        y = s // _U32(self.x_samples)
        if self.jitter:
            jx, jy = srng.uniform_2d(
                state.pixel_hash, state.sample_index, state.dim
            )
        else:
            jx = jy = 0.5
        u = vec2(
            (x.astype(jnp.float32) + jx) / self.x_samples,
            (y.astype(jnp.float32) + jy) / self.y_samples,
        )
        return u, SamplerState(
            pixel_hash=state.pixel_hash,
            sample_index=state.sample_index,
            dim=state.dim + _U32(2),
        )

    def get_pixel_2d(self, state: SamplerState):
        return self.get_2d(state)


def create_sampler(name: str, samples_per_pixel: int, resolution=(1280, 720), seed: int = 0):
    """Factory mirroring Sampler::create (src/sampler.rs:40-46 + gaps)."""
    name = name.lower()
    if name == "independent":
        return IndependentSampler(samples_per_pixel, seed)
    if name in ("zsobol", "sobol", "paddedsobol"):
        return ZSobolSampler(samples_per_pixel, resolution, seed)
    if name == "stratified":
        n = int(np.sqrt(samples_per_pixel))
        return StratifiedSampler(n, max(1, samples_per_pixel // n), True, seed)
    raise ValueError(f"unknown sampler: {name}")
