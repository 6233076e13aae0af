"""Homogeneous participating media (VolPath, BASELINE config #5).

The reference's ``Medium`` is an empty stub (/root/reference/src/media.rs:3-5);
this implements the pbrt-v4 homogeneous-medium semantics the scene format
implies, shaped for batched lanes: per-lane masked closed-form distance sampling inside
the existing batched path loop (no delta/ratio tracking needed for
homogeneous media), hero-wavelength spectral sigma with channel-0 distance
sampling, Henyey-Greenstein phase (materials/scattering.py), NEE from
medium vertices with phase<->light MIS, and exponential transmittance on
shadow segments.

Scope: a homogeneous exterior (camera) medium plus per-shape
MediumInterface boundaries with per-lane medium tracking — rays and NEE
shadow segments cross declared, material-less interface shapes, switching
the lane's medium per sub-segment (integrators/path.py: the interface
block and shadow_march_interfaces).  Media are homogeneous only; spatial
(grid) media are future work.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from shimmer_tpu.spectra.spectrum import (
    Spectrum,
    dense_sample_rows,
)
from shimmer_tpu.utils.pytree import pytree_dataclass


@pytree_dataclass
class MediumData:
    sigma_a: jnp.ndarray   # (M, 471) dense absorption spectra (pre-scaled)
    sigma_s: jnp.ndarray   # (M, 471) dense scattering spectra (pre-scaled)
    g: jnp.ndarray         # (M,) HG asymmetry


def _to_dense(v, colorspace) -> np.ndarray:
    """Spectrum | rgb triple | scalar → (471,) dense samples.

    RGB coefficients use the unbounded uplift (pbrt RgbUnboundedSpectrum:
    fit rgb / (2 max) as an albedo polynomial, scale by 2 max)."""
    if isinstance(v, Spectrum):
        return np.asarray(v.to_dense(), np.float64)
    arr = np.asarray(v, np.float64).reshape(-1)
    if arr.size == 1:
        return np.full(471, float(arr[0]))
    assert arr.size == 3, f"sigma must be scalar, rgb, or Spectrum: {v!r}"
    from shimmer_tpu.spectra.rgb2spec import fit_rgb_coeffs, sigmoid_poly_sample

    m = float(arr.max())
    if m <= 0.0:
        return np.zeros(471)
    coeffs = fit_rgb_coeffs((arr / (2.0 * m))[None], colorspace)[0]
    lam = np.arange(360.0, 831.0)
    return 2.0 * m * np.asarray(
        sigmoid_poly_sample(jnp.asarray(coeffs), jnp.asarray(lam))
    )


def make_media_table(media: list[dict], colorspace) -> MediumData:
    """Host bake: list of medium dicts → device tables.

    Each dict: ``sigma_a`` / ``sigma_s`` (Spectrum, rgb triple, or
    scalar; default 1/1), ``scale`` (multiplies both, pbrt semantics),
    ``g`` (HG asymmetry, default 0)."""
    m = len(media)
    sa = np.zeros((m, 471), np.float32)
    ss = np.zeros((m, 471), np.float32)
    g = np.zeros(m, np.float32)
    for i, md in enumerate(media):
        scale = float(md.get("scale", 1.0))
        sa[i] = scale * _to_dense(md.get("sigma_a", 1.0), colorspace)
        ss[i] = scale * _to_dense(md.get("sigma_s", 1.0), colorspace)
        g[i] = float(md.get("g", 0.0))
    return MediumData(
        sigma_a=jnp.asarray(sa), sigma_s=jnp.asarray(ss), g=jnp.asarray(g)
    )


def medium_sigma(media: MediumData, mid, lam):
    """Spectral sigma_a, sigma_s, g at hero wavelengths for per-lane
    medium ids (mid < 0 → zeros: vacuum)."""
    midc = jnp.maximum(mid, 0)
    sa = dense_sample_rows(media.sigma_a, midc, lam)
    ss = dense_sample_rows(media.sigma_s, midc, lam)
    on = (mid >= 0)[..., None]
    return (
        jnp.where(on, sa, 0.0),
        jnp.where(on, ss, 0.0),
        media.g[midc],
    )
