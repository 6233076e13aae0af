"""Sphere shape, batched SoA.

TPU-native analog of /root/reference/src/shape/sphere.rs.  Spheres live in a
flat table (SphereData); intersection runs rays × spheres fully vectorized
(the robust-quadratic formulation replaces the reference's interval
arithmetic; stable ``difference_of_products`` keeps the discriminant exact
enough in f32 for the scales the test scenes use).  Supports partial spheres
(z_min/z_max, phi_max) and the reference's full sampling interface:
uniform-area ``sample`` and cone-based ``sample_with_context`` /
``pdf_with_context`` (sphere.rs:229-430).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from shimmer_tpu.ops.math import quadratic, safe_acos, safe_sqrt, sqr, lerp
from shimmer_tpu.ops.sampling import (
    sample_uniform_sphere,
    sample_uniform_cone,
)
from shimmer_tpu.ops.transform import Transform
from shimmer_tpu.ops.vecmath import (
    Frame,
    cross,
    distance_squared,
    dot,
    length,
    normalize,
    spherical_phi,
    vec,
)
from shimmer_tpu.shapes.interaction import SurfaceInteraction
from shimmer_tpu.utils.pytree import pytree_dataclass


@pytree_dataclass
class SphereData:
    """Flat sphere table: (S,) parameter arrays + (S, 4, 4) transforms."""

    radius: jnp.ndarray
    z_min: jnp.ndarray
    z_max: jnp.ndarray
    theta_z_min: jnp.ndarray
    theta_z_max: jnp.ndarray
    phi_max: jnp.ndarray
    object_to_render: jnp.ndarray  # (S, 4, 4)
    render_to_object: jnp.ndarray  # (S, 4, 4)
    reverse_orientation: jnp.ndarray  # (S,) bool
    material_id: jnp.ndarray  # (S,) int32
    area_light_id: jnp.ndarray  # (S,) int32


def make_sphere_data(spheres: list[dict]) -> SphereData:
    """Host: build SphereData from dicts with keys radius, z_min, z_max,
    phi_max (deg), object_to_render (Transform), reverse_orientation,
    material_id, area_light_id."""
    n = len(spheres)
    g = lambda k, d: np.array([s.get(k, d) for s in spheres], np.float32)
    radius = g("radius", 1.0)
    z_min = np.maximum(
        np.array(
            [s.get("z_min", -s.get("radius", 1.0)) for s in spheres], np.float32
        ),
        -radius,
    )
    z_max = np.minimum(
        np.array(
            [s.get("z_max", s.get("radius", 1.0)) for s in spheres], np.float32
        ),
        radius,
    )
    o2r = np.stack(
        [
            np.asarray(s.get("object_to_render", Transform.identity()).m)
            for s in spheres
        ]
    )
    r2o = np.stack(
        [
            np.asarray(s.get("object_to_render", Transform.identity()).m_inv)
            for s in spheres
        ]
    )
    return SphereData(
        radius=jnp.asarray(radius),
        z_min=jnp.asarray(z_min),
        z_max=jnp.asarray(z_max),
        theta_z_min=jnp.asarray(np.arccos(np.clip(z_min / radius, -1, 1))),
        theta_z_max=jnp.asarray(np.arccos(np.clip(z_max / radius, -1, 1))),
        phi_max=jnp.asarray(np.deg2rad(g("phi_max", 360.0))),
        object_to_render=jnp.asarray(o2r),
        render_to_object=jnp.asarray(r2o),
        reverse_orientation=jnp.asarray(
            np.array([bool(s.get("reverse_orientation", False)) for s in spheres])
        ),
        material_id=jnp.asarray(g("material_id", -1).astype(np.int32)),
        area_light_id=jnp.asarray(g("area_light_id", -1).astype(np.int32)),
    )


def _apply_m(m, p, w):
    ph = jnp.concatenate([p, jnp.full_like(p[..., :1], w)], axis=-1)
    out = jnp.einsum("...ij,...j->...i", m, ph, precision=jax.lax.Precision.HIGHEST)
    return out[..., :3]


def sphere_intersect(data: SphereData, ray_o, ray_d, t_max):
    """Intersect a ray batch against every sphere; return the closest hit.

    ray_o, ray_d: (N, 3); t_max: (N,) → SurfaceInteraction (N,).
    Mirrors Sphere::basic_intersect + interaction_from_intersection
    (sphere.rs:95-220) with a lanes×spheres broadcast instead of the
    reference's per-primitive virtual dispatch.
    """
    n_rays = ray_o.shape[0]
    s = data.radius.shape[0]
    # (N, S, 3) object-space rays.
    m_inv = data.render_to_object  # (S,4,4)
    o = _apply_m(m_inv[None], ray_o[:, None, :], 1.0)
    d = _apply_m(m_inv[None], ray_d[:, None, :], 0.0)

    a = jnp.sum(d * d, axis=-1)
    b = 2.0 * jnp.sum(o * d, axis=-1)
    c = jnp.sum(o * o, axis=-1) - sqr(data.radius)[None]
    has, t0, t1 = quadratic(a, b, c)

    def hit_ok(t):
        p = o + t[..., None] * d
        # Reproject for robustness (sphere.rs refine).
        p = p * (data.radius[None] / jnp.maximum(length(p), 1e-20))[..., None]
        phi = spherical_phi(p)
        z_ok = (p[..., 2] >= data.z_min[None] - 1e-6) & (
            p[..., 2] <= data.z_max[None] + 1e-6
        )
        full_z = (data.z_min <= -data.radius + 1e-7) & (
            data.z_max >= data.radius - 1e-7
        )
        z_ok = z_ok | full_z[None]
        phi_ok = phi <= data.phi_max[None] + 1e-6
        return (t > 1e-6) & (t < t_max[:, None]) & z_ok & phi_ok, p, phi

    ok0, p0, phi0 = hit_ok(t0)
    ok1, p1, phi1 = hit_ok(t1)
    use1 = (~ok0) & ok1
    t_hit = jnp.where(ok0, t0, jnp.where(use1, t1, jnp.inf))
    p_obj = jnp.where(use1[..., None], p1, p0)
    phi = jnp.where(use1, phi1, phi0)
    hit = has & (ok0 | ok1)
    t_hit = jnp.where(hit, t_hit, jnp.inf)

    # Closest sphere per ray.
    best = jnp.argmin(t_hit, axis=-1)  # (N,)
    t_best = jnp.take_along_axis(t_hit, best[:, None], axis=1)[:, 0]
    valid = jnp.isfinite(t_best)
    take = lambda arr: jnp.take_along_axis(
        arr, best[:, None, None] if arr.ndim == 3 else best[:, None], axis=1
    ).squeeze(1)
    p_obj = take(p_obj)
    phi = take(phi)
    sphere_idx = best

    # Per-hit sphere parameters.
    gidx = lambda arr: arr[sphere_idx]
    radius = gidx(data.radius)
    phi_max = gidx(data.phi_max)
    theta_z_min = gidx(data.theta_z_min)
    theta_z_max = gidx(data.theta_z_max)
    o2r = gidx(data.object_to_render)
    r2o = gidx(data.render_to_object)

    # uv + partials in object space (sphere.rs interaction construction).
    theta = safe_acos(p_obj[..., 2] / radius)
    u = phi / phi_max
    v = (theta - theta_z_min) / jnp.where(
        theta_z_max != theta_z_min, theta_z_max - theta_z_min, 1.0
    )
    z_radius = jnp.sqrt(
        jnp.maximum(sqr(p_obj[..., 0]) + sqr(p_obj[..., 1]), 1e-20)
    )
    cos_phi = p_obj[..., 0] / z_radius
    sin_phi = p_obj[..., 1] / z_radius
    dpdu = jnp.stack(
        [-phi_max * p_obj[..., 1], phi_max * p_obj[..., 0], jnp.zeros_like(phi)],
        axis=-1,
    )
    sin_theta = safe_sqrt(1.0 - sqr(p_obj[..., 2] / radius))
    dpdv = (theta_z_max - theta_z_min)[..., None] * jnp.stack(
        [
            p_obj[..., 2] * cos_phi,
            p_obj[..., 2] * sin_phi,
            -radius * sin_theta,
        ],
        axis=-1,
    )

    # To render space.
    p = _apply_m(o2r, p_obj, 1.0)
    n_obj = normalize(p_obj)
    # normal transform: inverse transpose of o2r = transpose of r2o
    n = normalize(
        jnp.einsum("...ji,...j->...i", r2o[..., :3, :3], n_obj, precision=jax.lax.Precision.HIGHEST)
    )
    rev = gidx(data.reverse_orientation)
    n = jnp.where(rev[..., None], -n, n)
    dpdu_r = _apply_m(o2r, dpdu, 0.0)
    dpdv_r = _apply_m(o2r, dpdv, 0.0)

    return SurfaceInteraction.make(
        valid=valid,
        t=jnp.where(valid, t_best, jnp.inf),
        p=p,
        n=n,
        uv=jnp.stack([u, v], axis=-1),
        wo=-normalize(ray_d),
        dpdu=dpdu_r,
        dpdv=dpdv_r,
        material_id=jnp.where(valid, gidx(data.material_id), -1),
        area_light_id=jnp.where(valid, gidx(data.area_light_id), -1),
    )


def sphere_intersect_predicate(data: SphereData, ray_o, ray_d, t_max):
    """Any-hit shadow test (sphere.rs intersect_predicate)."""
    si = sphere_intersect(data, ray_o, ray_d, t_max)
    return si.valid


def sphere_area(data: SphereData):
    """(S,) surface areas: phi_max * r * (z_max - z_min) (sphere.rs area)."""
    return data.phi_max * data.radius * (data.z_max - data.z_min)


def sphere_sample(data: SphereData, idx, u):
    """Uniform area sampling of sphere ``idx`` lanes (sphere.rs sample).

    idx: (...,) int; u: (..., 2) → (p, n, pdf_area)."""
    radius = data.radius[idx]
    o2r = data.object_to_render[idx]
    r2o = data.render_to_object[idx]
    p_obj = radius[..., None] * sample_uniform_sphere(u)
    p = _apply_m(o2r, p_obj, 1.0)
    n = normalize(
        jnp.einsum("...ji,...j->...i", r2o[..., :3, :3], p_obj, precision=jax.lax.Precision.HIGHEST)
    )
    n = jnp.where(data.reverse_orientation[idx][..., None], -n, n)
    pdf = 1.0 / sphere_area(data)[idx]
    return p, n, pdf


def sphere_sample_with_context(data: SphereData, idx, ref_p, ref_ns, u):
    """Solid-angle sampling toward the sphere from a reference point
    (sphere.rs sample_with_context): cone sampling when the reference is
    outside, uniform-area fallback inside.

    Returns (p, n, pdf_solid_angle)."""
    radius = data.radius[idx]
    o2r = data.object_to_render[idx]
    center = _apply_m(o2r, jnp.zeros_like(ref_p), 1.0)
    dc2 = distance_squared(ref_p, center)
    outside = dc2 > sqr(radius) * (1.0 + 1e-4)

    # --- outside: sample the subtended cone (pbrt 6.8.3) ---
    dc = jnp.sqrt(jnp.maximum(dc2, 1e-20))
    inv_dc = 1.0 / dc
    # Sampling frame z-axis points from the sphere center TOWARD the
    # reference point: sampled normals lie on the near hemisphere.
    frame = Frame.from_z((ref_p - center) * inv_dc[..., None])
    sin2_theta_max = sqr(radius) / dc2
    cos_theta_max = safe_sqrt(1.0 - sin2_theta_max)
    cos_theta = (cos_theta_max - 1.0) * u[..., 0] + 1.0
    sin2_theta = 1.0 - sqr(cos_theta)
    # Small-angle expansion (sphere.rs / pbrt for numerical stability).
    small = sin2_theta_max < 0.00068523
    sin2_theta = jnp.where(small, sin2_theta_max * u[..., 0], sin2_theta)
    cos_theta = jnp.where(small, safe_sqrt(1.0 - sin2_theta), cos_theta)
    # cosα = sin²θ/sinθmax + cosθ·sqrt(1 − sin²θ/sin²θmax), sinθmax = r/dc
    cos_alpha = sin2_theta * dc / radius + cos_theta * safe_sqrt(
        1.0 - sin2_theta * sqr(dc) / sqr(radius)
    )
    sin_alpha = safe_sqrt(1.0 - sqr(cos_alpha))
    phi = u[..., 1] * 2.0 * jnp.pi
    w_dir = jnp.stack(
        [sin_alpha * jnp.cos(phi), sin_alpha * jnp.sin(phi), cos_alpha],
        axis=-1,
    )
    n_out = frame.from_local(w_dir)
    p_out = center + radius[..., None] * n_out
    pdf_out = 1.0 / (2.0 * jnp.pi * jnp.maximum(1.0 - cos_theta_max, 1e-9))

    # --- inside: uniform area, converted to solid angle ---
    p_in, n_in, pdf_area = sphere_sample(data, idx, u)
    wi = p_in - ref_p
    dist2 = jnp.sum(wi * wi, axis=-1)
    wi_n = normalize(wi)
    cos_surf = jnp.abs(dot(n_in, -wi_n))
    pdf_in = pdf_area * dist2 / jnp.maximum(cos_surf, 1e-9)
    pdf_in = jnp.where(cos_surf <= 1e-9, 0.0, pdf_in)

    rev = data.reverse_orientation[idx]
    n_out = jnp.where(rev[..., None], -n_out, n_out)
    p = jnp.where(outside[..., None], p_out, p_in)
    n = jnp.where(outside[..., None], n_out, n_in)
    pdf = jnp.where(outside, pdf_out, pdf_in)
    return p, n, pdf


def sphere_pdf_with_context(data: SphereData, idx, ref_p, wi, si_p, si_n):
    """Solid-angle pdf of sampling direction wi toward sphere idx
    (sphere.rs pdf_with_context)."""
    radius = data.radius[idx]
    o2r = data.object_to_render[idx]
    center = _apply_m(o2r, jnp.zeros_like(ref_p), 1.0)
    dc2 = distance_squared(ref_p, center)
    outside = dc2 > sqr(radius) * (1.0 + 1e-4)

    sin2_theta_max = sqr(radius) / dc2
    cos_theta_max = safe_sqrt(1.0 - sin2_theta_max)
    pdf_out = 1.0 / (2.0 * jnp.pi * jnp.maximum(1.0 - cos_theta_max, 1e-9))

    # Inside: area pdf → solid angle using provided hit point.
    dist2 = distance_squared(ref_p, si_p)
    cos_surf = jnp.abs(dot(si_n, -normalize(si_p - ref_p)))
    pdf_area = 1.0 / sphere_area(data)[idx]
    pdf_in = jnp.where(
        cos_surf > 1e-9, pdf_area * dist2 / jnp.maximum(cos_surf, 1e-9), 0.0
    )
    return jnp.where(outside, pdf_out, pdf_in)
