"""Bilinear patches (pbrt-v4 "bilinearmesh").

TPU-native analog of /root/reference/src/shape/bilinear_patch.rs: the
patch p(u,v) = (1-u)(1-v)p00 + u(1-v)p10 + (1-u)v p01 + uv p11 with
quadratic ray intersection (intersect_blp, bilinear_patch.rs:144),
corner-area-weighted sampling (SampleBilinear over the corner normal
magnitudes) and solid-angle pdfs for NEE/MIS.

Design differences from the reference (batched device code, not a port):

* SoA batch of all patches; intersection is a vectorized (N rays x B
  patches) test — patch counts in pbrt scenes are small (quad lights,
  ground planes); meshes of many quads come in through the triangle
  path (the parser may also triangulate, scene_builder option).
* Both quadratic roots are evaluated branch-free and the nearer valid
  one selected per lane.
* Area is integrated numerically at build time (16-point tensor Gauss)
  instead of the reference's special-cases.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from shimmer_tpu.ops.math import difference_of_products, lerp, quadratic
from shimmer_tpu.ops.sampling import bilinear_pdf, sample_bilinear
from shimmer_tpu.ops.vecmath import (
    cross,
    distance_squared,
    dot,
    length,
    normalize,
)
from shimmer_tpu.shapes.interaction import SurfaceInteraction
from shimmer_tpu.utils.pytree import pytree_dataclass, static_field

_EPS_T = 1e-4


@pytree_dataclass
class BilinearPatchData:
    p00: jnp.ndarray          # (B, 3) render-space corners
    p10: jnp.ndarray
    p01: jnp.ndarray
    p11: jnp.ndarray
    uv: jnp.ndarray           # (B, 4, 2) corner uvs [00, 10, 01, 11]
    material_id: jnp.ndarray  # (B,) int32
    area_light_id: jnp.ndarray  # (B,) int32, -1 = none
    reverse: jnp.ndarray      # (B,) bool reverse_orientation^handedness
    area: jnp.ndarray         # (B,) surface area (numeric)
    has_uv: bool = static_field(default=False)


def _bilerp(u, v, p00, p10, p01, p11):
    return (
        (1 - u) * (1 - v) * p00
        + u * (1 - v) * p10
        + (1 - u) * v * p01
        + u * v * p11
    )


def make_bilinear_data(patches: list[dict], render_from_object=None
                       ) -> BilinearPatchData:
    """patches: dicts with p00 p10 p01 p11 (object/world space, (3,)),
    optional 'uv' (4,2), 'material_id', 'area_light_id', 'reverse',
    'object_to_world' (Transform)."""
    from shimmer_tpu.ops.transform import Transform

    c = {k: [] for k in ("p00", "p10", "p01", "p11")}
    uvs, mids, alids, revs = [], [], [], []
    any_uv = False
    for s in patches:
        o2w = s.get("object_to_world")
        m = None
        if o2w is not None or render_from_object is not None:
            t = render_from_object or Transform.identity()
            if o2w is not None:
                t = t @ o2w
            m = np.asarray(t.m)
        for k in c:
            p = np.asarray(s[k], np.float64)
            if m is not None:
                ph = m @ np.append(p, 1.0)
                p = ph[:3] / ph[3]
            c[k].append(p.astype(np.float32))
        uv = s.get("uv")
        if uv is not None:
            any_uv = True
            uvs.append(np.asarray(uv, np.float32))
        else:
            uvs.append(
                np.asarray([[0, 0], [1, 0], [0, 1], [1, 1]], np.float32)
            )
        mids.append(int(s.get("material_id", -1)))
        alids.append(int(s.get("area_light_id", -1)))
        revs.append(bool(s.get("reverse", False)))
    p00 = np.stack(c["p00"])
    p10 = np.stack(c["p10"])
    p01 = np.stack(c["p01"])
    p11 = np.stack(c["p11"])
    # 4x4 tensor Gauss-Legendre area integration.
    gx, gw = np.polynomial.legendre.leggauss(4)
    gu = 0.5 * (gx + 1.0)
    gw = 0.5 * gw
    area = np.zeros(len(patches), np.float64)
    for iu in range(4):
        for iv in range(4):
            u, v = gu[iu], gu[iv]
            dpdu = (1 - v) * (p10 - p00) + v * (p11 - p01)
            dpdv = (1 - u) * (p01 - p00) + u * (p11 - p10)
            j = np.linalg.norm(np.cross(dpdu, dpdv), axis=-1)
            area += gw[iu] * gw[iv] * j
    return BilinearPatchData(
        p00=jnp.asarray(p00),
        p10=jnp.asarray(p10),
        p01=jnp.asarray(p01),
        p11=jnp.asarray(p11),
        uv=jnp.asarray(np.stack(uvs)),
        material_id=jnp.asarray(mids, jnp.int32),
        area_light_id=jnp.asarray(alids, jnp.int32),
        reverse=jnp.asarray(revs),
        area=jnp.asarray(area, jnp.float32),
        has_uv=any_uv,
    )


def _intersect_uv(data: BilinearPatchData, ray_o, ray_d, t_max):
    """Core quadratic intersection, all rays x all patches.

    ray_o/ray_d: (N, 3); returns (hit (N,B), t, u, v) with t=inf on miss.
    The patch point for parameter u lies on the segment
    pa(u)=lerp(u,p00,p10) .. pb(u)=lerp(u,p01,p11); the ray meets the
    surface where cross(pb-pa, d) . (pa-o) = 0, a quadratic in u
    (bilinear_patch.rs:144 intersect_blp)."""
    o = ray_o[:, None, :]                    # (N, 1, 3)
    d = ray_d[:, None, :]
    p00 = data.p00[None]                     # (1, B, 3)
    p10 = data.p10[None]
    p01 = data.p01[None]
    p11 = data.p11[None]
    e0 = p01 - p00                           # v edge at u=0
    e1 = p11 - p01 - p10 + p00               # twist
    f0 = p00 - o
    f1 = p10 - p00
    c0d = cross(e0, d)
    c1d = cross(e1, d)
    a = dot(c1d, f1)
    b = dot(c0d, f1) + dot(c1d, f0)
    c = dot(c0d, f0)
    has_root, u_lo, u_hi = quadratic(a, b, c)
    # Parallelogram patches have e1 == 0 exactly -> a == 0: the equation
    # degenerates to linear (pbrt's Quadratic handles this; ours flags
    # no-solution, so recover the single root here).
    lin = (a == 0.0) & (b != 0.0)
    u_lin = -c / jnp.where(b != 0.0, b, 1.0)
    has_root = has_root | lin
    u_lo = jnp.where(lin, u_lin, u_lo)
    u_hi = jnp.where(lin, u_lin, u_hi)

    def eval_root(u):
        u_ = u[..., None]
        pa = p00 + u_ * (p10 - p00)
        pb = p01 + u_ * (p11 - p01)
        ud = pb - pa
        deltao = pa - o
        perp = cross(d, ud)
        p2 = dot(perp, perp)
        ok = p2 > 0.0
        inv = 1.0 / jnp.where(ok, p2, 1.0)
        # t d - v ud = deltao; cross with ud resp. d (Cramer):
        v = dot(cross(deltao, d), perp) * inv
        t = dot(cross(deltao, ud), perp) * inv
        good = (
            ok
            & (u >= 0.0)
            & (u <= 1.0)
            & (v >= 0.0)
            & (v <= 1.0)
            & (t > _EPS_T)
            & (t < t_max[:, None])
        )
        return good, t, v

    g_lo, t_lo, v_lo = eval_root(u_lo)
    g_hi, t_hi, v_hi = eval_root(u_hi)
    take_hi = g_hi & (~g_lo | (t_hi < t_lo))
    hit = has_root & (g_lo | g_hi)
    t = jnp.where(take_hi, t_hi, t_lo)
    u = jnp.where(take_hi, u_hi, u_lo)
    v = jnp.where(take_hi, v_hi, v_lo)
    return hit, jnp.where(hit, t, jnp.inf), u, v


def bilinear_intersect(data: BilinearPatchData, ray_o, ray_d, t_max
                       ) -> SurfaceInteraction:
    """Closest-hit over all patches; same contract as sphere_intersect."""
    t_max = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32),
                             ray_o.shape[:-1])
    hit, t, u, v = _intersect_uv(data, ray_o, ray_d, t_max)
    best = jnp.argmin(t, axis=1)             # (N,)
    n_lane = jnp.arange(ray_o.shape[0])
    valid = hit[n_lane, best]
    t_b = t[n_lane, best]
    u_b = u[n_lane, best]
    v_b = v[n_lane, best]
    idx = best

    u_ = u_b[:, None]
    v_ = v_b[:, None]
    p00 = data.p00[idx]
    p10 = data.p10[idx]
    p01 = data.p01[idx]
    p11 = data.p11[idx]
    p = _bilerp(u_, v_, p00, p10, p01, p11)
    dpdu = (1 - v_) * (p10 - p00) + v_ * (p11 - p01)
    dpdv = (1 - u_) * (p01 - p00) + u_ * (p11 - p10)
    ng = normalize(cross(dpdu, dpdv))
    ng = jnp.where(data.reverse[idx][:, None], -ng, ng)

    uvc = data.uv[idx]                       # (N, 4, 2)
    uv_out = _bilerp(u_, v_, uvc[:, 0], uvc[:, 1], uvc[:, 2], uvc[:, 3])
    if data.has_uv:
        # Chain rule through the uv bilerp (bilinear_patch.rs uv remap):
        # solve [dpdu dpdv] = [dp/du' dp/dv'] * J for the render-space
        # derivatives wrt the *texture* uv.
        duvdu = (1 - v_) * (uvc[:, 1] - uvc[:, 0]) + v_ * (
            uvc[:, 3] - uvc[:, 2]
        )
        duvdv = (1 - u_) * (uvc[:, 2] - uvc[:, 0]) + u_ * (
            uvc[:, 3] - uvc[:, 1]
        )
        det = difference_of_products(
            duvdu[:, 0], duvdv[:, 1], duvdu[:, 1], duvdv[:, 0]
        )
        ok = jnp.abs(det) > 1e-12
        inv = 1.0 / jnp.where(ok, det, 1.0)
        dpdu_t = jnp.where(
            ok[:, None],
            (duvdv[:, 1:2] * dpdu - duvdu[:, 1:2] * dpdv) * inv[:, None],
            dpdu,
        )
        dpdv_t = jnp.where(
            ok[:, None],
            (duvdu[:, 0:1] * dpdv - duvdv[:, 0:1] * dpdu) * inv[:, None],
            dpdv,
        )
        dpdu, dpdv = dpdu_t, dpdv_t

    return SurfaceInteraction.make(
        valid=valid,
        t=jnp.where(valid, t_b, jnp.inf),
        p=p,
        n=ng,
        uv=uv_out,
        wo=-ray_d,
        dpdu=dpdu,
        dpdv=dpdv,
        ns=ng,
        dpdus=dpdu,
        material_id=jnp.where(valid, data.material_id[idx], -1),
        area_light_id=jnp.where(valid, data.area_light_id[idx], -1),
    )


def bilinear_occluded(data: BilinearPatchData, ray_o, ray_d, t_max):
    t_max = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32),
                             ray_o.shape[:-1])
    hit, _, _, _ = _intersect_uv(data, ray_o, ray_d, t_max)
    return jnp.any(hit, axis=1)


def _corner_weights(data: BilinearPatchData, idx):
    p00, p10 = data.p00[idx], data.p10[idx]
    p01, p11 = data.p01[idx], data.p11[idx]
    w = jnp.stack(
        [
            length(cross(p10 - p00, p01 - p00)),
            length(cross(p10 - p00, p11 - p10)),
            length(cross(p01 - p00, p11 - p01)),
            length(cross(p11 - p10, p11 - p01)),
        ],
        axis=-1,
    )
    return w


def bilinear_light_sample(data: BilinearPatchData, idx, ref_p, ref_ns, u):
    """Area sampling ∝ local area distortion (SampleBilinear over the
    corner-normal magnitudes, bilinear_patch.rs Sample) converted to a
    solid-angle pdf.  Returns (p, n, pdf_solid_angle)."""
    w = _corner_weights(data, idx)
    uv = sample_bilinear(u, w)
    pdf_uv = bilinear_pdf(uv, w)
    u_ = uv[..., 0:1]
    v_ = uv[..., 1:2]
    p00, p10 = data.p00[idx], data.p10[idx]
    p01, p11 = data.p01[idx], data.p11[idx]
    p = _bilerp(u_, v_, p00, p10, p01, p11)
    dpdu = (1 - v_) * (p10 - p00) + v_ * (p11 - p01)
    dpdv = (1 - u_) * (p01 - p00) + u_ * (p11 - p10)
    cr = cross(dpdu, dpdv)
    jac = length(cr)
    n = normalize(cr)
    n = jnp.where(data.reverse[idx][..., None], -n, n)
    pdf_area = pdf_uv / jnp.maximum(jac, 1e-12)
    wi = p - ref_p
    dist2 = jnp.sum(wi * wi, -1)
    cos = jnp.abs(dot(n, -normalize(wi)))
    pdf = jnp.where(
        (cos > 1e-9) & (dist2 > 0.0),
        pdf_area * dist2 / jnp.maximum(cos, 1e-9),
        0.0,
    )
    return p, n, pdf


def bilinear_light_pdf(data: BilinearPatchData, idx, ref_p, ref_ns, wi,
                       si_p, si_n):
    """pdf_with_context for MIS: re-intersect (ref_p, wi) with the patch
    to recover (u, v), then the same area->solid-angle conversion."""
    lane = jnp.arange(ref_p.shape[0])
    hit, t, u, v = _intersect_uv(
        data, ref_p, wi, jnp.full(ref_p.shape[0], jnp.inf)
    )
    hit_i = hit[lane, idx]
    u_b = u[lane, idx][..., None]
    v_b = v[lane, idx][..., None]
    w = _corner_weights(data, idx)
    pdf_uv = bilinear_pdf(
        jnp.concatenate([u_b, v_b], axis=-1), w
    )
    p00, p10 = data.p00[idx], data.p10[idx]
    p01, p11 = data.p01[idx], data.p11[idx]
    dpdu = (1 - v_b) * (p10 - p00) + v_b * (p11 - p01)
    dpdv = (1 - u_b) * (p01 - p00) + u_b * (p11 - p10)
    jac = length(cross(dpdu, dpdv))
    pdf_area = pdf_uv / jnp.maximum(jac, 1e-12)
    dist2 = distance_squared(ref_p, si_p)
    cos = jnp.abs(dot(normalize(si_n), -normalize(si_p - ref_p)))
    pdf = jnp.where(
        hit_i & (cos > 1e-9),
        pdf_area * dist2 / jnp.maximum(cos, 1e-9),
        0.0,
    )
    return pdf
