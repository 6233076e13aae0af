"""Image-based infinite (environment) light.

TPU-native analog of ImageInfiniteLight (/root/reference/src/light.rs:
805-981): an equal-area octahedral environment map with a 2-D
piecewise-constant importance distribution (plus the mean-compensated
variant for MIS).  The reference looks up an RgbIlluminantSpectrum per
texel at shading time; here the RGB→spectrum uplift is *precomputed* — the
map is baked to sigmoid-polynomial coefficient + scale images at scene
build, so the device eval is a gather + closed-form sigmoid (no tables in
the hot path).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from shimmer_tpu.ops.sampling import (
    PiecewiseConstant2D,
    build_piecewise_constant_2d,
)
from shimmer_tpu.ops.vecmath import (
    equal_area_sphere_to_square,
    equal_area_square_to_sphere,
    normalize,
)
from shimmer_tpu.spectra.rgb2spec import fit_rgb_coeffs, sigmoid_poly_sample
from shimmer_tpu.spectra.spectrum import dense_sample
from shimmer_tpu.utils.pytree import pytree_dataclass


@pytree_dataclass
class EnvLightData:
    coeffs: jnp.ndarray        # (H, W, 3) sigmoid coefficients per texel
    texel_scale: jnp.ndarray   # (H, W) 2*max(rgb) per texel
    illum_dense: jnp.ndarray   # (471,) colorspace illuminant
    scale: jnp.ndarray         # () overall light scale
    render_from_light: jnp.ndarray  # (4, 4)
    light_from_render: jnp.ndarray  # (4, 4)
    distribution: PiecewiseConstant2D
    compensated: PiecewiseConstant2D
    scene_radius: jnp.ndarray  # ()


def _equal_area_square_to_sphere_np(u, v):
    """Numpy equal-area octahedral square→sphere (vecmath.py:220, host
    version so map baking never touches the device)."""
    u = 2.0 * u - 1.0
    v = 2.0 * v - 1.0
    up, vp = np.abs(u), np.abs(v)
    sd = 1.0 - (up + vp)
    d = np.abs(sd)
    r = 1.0 - d
    phi = np.where(r == 0.0, 1.0, (vp - up) / np.maximum(r, 1e-12) + 1.0) * (
        np.pi / 4.0
    )
    z = np.copysign(1.0 - r * r, sd)
    cos_phi = np.copysign(np.cos(phi), u)
    sin_phi = np.copysign(np.sin(phi), v)
    s = r * np.sqrt(np.maximum(2.0 - r * r, 0.0))
    return cos_phi * s, sin_phi * s, z


def equirect_to_equal_area(img: np.ndarray, out_res: int | None = None):
    """Resample a lat-long (equirectangular) map into the equal-area
    octahedral square layout the light uses (pbrt-v4 does the same
    conversion at image load; the reference only reads square maps,
    light.rs:805-981).  Bilinear with longitude wrap-around."""
    h, w, c = img.shape
    s = int(out_res or min(max(h, 64), 2048))
    uv = (np.arange(s, dtype=np.float64) + 0.5) / s
    uu, vv = np.meshgrid(uv, uv, indexing="xy")   # uu→x(col), vv→y(row)
    x, y, z = _equal_area_square_to_sphere_np(uu, vv)
    theta = np.arccos(np.clip(z, -1.0, 1.0))
    phi = np.mod(np.arctan2(y, x), 2.0 * np.pi)
    fx = phi / (2.0 * np.pi) * w - 0.5
    fy = theta / np.pi * h - 0.5
    x0 = np.floor(fx).astype(np.int64)
    y0 = np.floor(fy).astype(np.int64)
    tx = (fx - x0)[..., None]
    ty = (fy - y0)[..., None]
    x0w, x1w = x0 % w, (x0 + 1) % w            # longitude wraps
    y0c = np.clip(y0, 0, h - 1)                # latitude clamps at poles
    y1c = np.clip(y0 + 1, 0, h - 1)
    im = np.asarray(img, np.float64)
    out = (
        im[y0c, x0w] * (1 - tx) * (1 - ty)
        + im[y0c, x1w] * tx * (1 - ty)
        + im[y1c, x0w] * (1 - tx) * ty
        + im[y1c, x1w] * tx * ty
    )
    return out


def build_env_light(
    image_rgb: np.ndarray,
    colorspace,
    scale: float = 1.0,
    render_from_light=None,
    scene_radius: float = 100.0,
    photometric: bool = True,
) -> EnvLightData:
    """Bake an equal-area env map (H=W) into device tables.

    image_rgb: (H, W, 3) linear RGB in ``colorspace``.  Uses the same
    photometric normalization as the reference (scale /= photometric(L),
    light.rs:130-221, with L = the colorspace illuminant for RGB maps).
    """
    from shimmer_tpu.ops.transform import Transform
    from shimmer_tpu.spectra.spectrum import spectrum_to_photometric

    img = np.asarray(image_rgb, np.float64)
    h, w, _ = img.shape
    if h != w:
        # pbrt-format scenes commonly ship lat-long maps; convert.
        img = equirect_to_equal_area(img)
        h, w, _ = img.shape
    m = np.max(img, axis=-1)
    texel_scale = 2.0 * m
    base = np.where(
        texel_scale[..., None] > 0.0, img / np.maximum(texel_scale[..., None], 1e-12), 0.0
    )
    # Fit unique colors only (8-bit sources repeat texels heavily).
    flat = base.reshape(-1, 3).astype(np.float32)
    uniq, inverse = np.unique(flat, axis=0, return_inverse=True)
    coeffs = fit_rgb_coeffs(uniq.astype(np.float64), colorspace)[inverse].reshape(
        h, w, 3
    )

    if photometric:
        scale = scale / spectrum_to_photometric(colorspace.illuminant)

    # Importance distribution over the scalar image (luminance-ish mean),
    # domain [0,1]^2 (light.rs:850-880).
    lum = img.mean(axis=-1)
    dist = build_piecewise_constant_2d(lum)
    comp = build_piecewise_constant_2d(np.maximum(lum - lum.mean(), 0.0))

    rfl = render_from_light or Transform.identity()
    return EnvLightData(
        coeffs=jnp.asarray(coeffs),
        texel_scale=jnp.asarray(texel_scale, jnp.float32),
        illum_dense=jnp.asarray(colorspace.illuminant.to_dense()),
        scale=jnp.float32(scale),
        render_from_light=jnp.asarray(rfl.m, jnp.float32),
        light_from_render=jnp.asarray(rfl.m_inv, jnp.float32),
        distribution=dist,
        compensated=comp,
        scene_radius=jnp.float32(scene_radius),
    )


def _dir_to_uv(env: EnvLightData, d_render):
    d = jnp.einsum(
        "ij,...j->...i", env.light_from_render[:3, :3], d_render,
        precision=jax.lax.Precision.HIGHEST,
    )
    return equal_area_sphere_to_square(normalize(d))


def env_le(env: EnvLightData, ray_d, swl):
    """Escaped-ray radiance (ImageInfiniteLight::le, light.rs:930-945):
    nearest-texel lookup like the reference's image_le."""
    uv = _dir_to_uv(env, ray_d)
    h, w = env.texel_scale.shape
    x = jnp.clip((uv[..., 0] * w).astype(jnp.int32), 0, w - 1)
    y = jnp.clip((uv[..., 1] * h).astype(jnp.int32), 0, h - 1)
    coeffs = env.coeffs[y, x]
    tscale = env.texel_scale[y, x]
    refl = sigmoid_poly_sample(coeffs, swl.lam)
    illum = dense_sample(env.illum_dense, swl.lam)
    return env.scale * tscale[..., None] * refl * illum


def env_sample_li(env: EnvLightData, ref_p, u, swl, allow_incomplete_pdf=False):
    """Importance-sample a direction from the env map
    (ImageInfiniteLight::sample_li, light.rs:884-928).

    Returns (l, wi, pdf, p_light)."""
    dist = env.compensated if allow_incomplete_pdf else env.distribution
    uv, map_pdf = dist.sample(u)
    d_light = equal_area_square_to_sphere(uv)
    wi = jnp.einsum(
        "ij,...j->...i", env.render_from_light[:3, :3], d_light,
        precision=jax.lax.Precision.HIGHEST,
    )
    pdf = map_pdf / (4.0 * jnp.pi)
    h, w = env.texel_scale.shape
    x = jnp.clip((uv[..., 0] * w).astype(jnp.int32), 0, w - 1)
    y = jnp.clip((uv[..., 1] * h).astype(jnp.int32), 0, h - 1)
    refl = sigmoid_poly_sample(env.coeffs[y, x], swl.lam)
    illum = dense_sample(env.illum_dense, swl.lam)
    l = env.scale * env.texel_scale[y, x][..., None] * refl * illum
    p_light = ref_p + wi * (2.0 * env.scene_radius)
    return l, wi, pdf, p_light


def env_pdf_li(env: EnvLightData, wi, allow_incomplete_pdf=False):
    """pdf of sample_li producing wi (light.rs pdf_li)."""
    uv = _dir_to_uv(env, wi)
    dist = env.compensated if allow_incomplete_pdf else env.distribution
    return dist.pdf_at(uv) / (4.0 * jnp.pi)
