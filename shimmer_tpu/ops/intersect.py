"""Ray-triangle intersection and bit helpers shared by the XLA traversal
(shapes/triangle.py, shapes/instanced.py) and the GPU traversal kernel
(ops/traverse_gpu.py)."""

from __future__ import annotations

import jax.numpy as jnp

from shimmer_tpu.ops.math import difference_of_products


def _permute_to_max_z(v, kz):
    """Cyclic-permute a 3-tuple of components so component ``kz`` lands
    in z.

    kz in {0,1,2}; (kx, ky) = (kz+1, kz+2) mod 3.  Implemented as pure
    lane-wise selects rather than per-lane gathers."""
    vx, vy, vz = v
    is0 = kz == 0
    is1 = kz == 1
    ox = jnp.where(is0, vy, jnp.where(is1, vz, vx))
    oy = jnp.where(is0, vz, jnp.where(is1, vx, vy))
    oz = jnp.where(is0, vx, jnp.where(is1, vy, vz))
    return ox, oy, oz


def intersect_triangle(ray_o, ray_d, t_max, p0, p1, p2):
    """Watertight ray-triangle intersection (triangle.rs:173-302).

    Points and directions are (..., 3), t_max (...,).  Returns
    (hit, t, b0, b1, b2)."""

    def xyz(v):
        return v[..., 0], v[..., 1], v[..., 2]

    return intersect_triangle_xyz(
        xyz(ray_o), xyz(ray_d), t_max, xyz(p0), xyz(p1), xyz(p2)
    )


def intersect_triangle_xyz(ray_o, ray_d, t_max, p0, p1, p2):
    """``intersect_triangle`` on component tuples ``(x, y, z)`` of
    broadcastable arrays.  This form is shared by the XLA traversal and
    the GPU traversal kernel, whose tensors cannot have a width-3 axis."""
    # Translate to ray origin.
    p0t = tuple(p - o for p, o in zip(p0, ray_o))
    p1t = tuple(p - o for p, o in zip(p1, ray_o))
    p2t = tuple(p - o for p, o in zip(p2, ray_o))
    # Permute so |d_z| is the largest component (first maximum on ties,
    # as argmax).
    ax, ay, az = (jnp.abs(c) for c in ray_d)
    kz = jnp.where(
        (ax >= ay) & (ax >= az), 0, jnp.where(ay >= az, 1, 2)
    )
    dx, dy, dz = _permute_to_max_z(ray_d, kz)
    p0x, p0y, p0z = _permute_to_max_z(p0t, kz)
    p1x, p1y, p1z = _permute_to_max_z(p1t, kz)
    p2x, p2y, p2z = _permute_to_max_z(p2t, kz)
    # Shear to align the ray with +z.
    dz_safe = jnp.where(dz == 0.0, 1.0, dz)
    sx = -dx / dz_safe
    sy = -dy / dz_safe
    sz = 1.0 / dz_safe
    p0x = p0x + sx * p0z
    p0y = p0y + sy * p0z
    p1x = p1x + sx * p1z
    p1y = p1y + sy * p1z
    p2x = p2x + sx * p2z
    p2y = p2y + sy * p2z
    # Signed edge functions (compensated products for watertightness).
    e0 = difference_of_products(p1x, p2y, p1y, p2x)
    e1 = difference_of_products(p2x, p0y, p2y, p0x)
    e2 = difference_of_products(p0x, p1y, p0y, p1x)
    same_sign = ((e0 >= 0) & (e1 >= 0) & (e2 >= 0)) | (
        (e0 <= 0) & (e1 <= 0) & (e2 <= 0)
    )
    det = e0 + e1 + e2
    det_ok = det != 0.0
    # Scaled hit distance.
    p0z = p0z * sz
    p1z = p1z * sz
    p2z = p2z * sz
    t_scaled = e0 * p0z + e1 * p1z + e2 * p2z
    neg = det < 0.0
    t_ok = jnp.where(
        neg,
        (t_scaled <= 1e-7 * det) & (t_scaled > t_max * det),
        (t_scaled >= 1e-7 * det) & (t_scaled < t_max * det),
    )
    hit = same_sign & det_ok & t_ok & (dz != 0.0)
    inv_det = 1.0 / jnp.where(det_ok, det, 1.0)
    t = t_scaled * inv_det
    b0 = e0 * inv_det
    b1 = e1 * inv_det
    b2 = e2 * inv_det
    return hit, jnp.where(hit, t, jnp.inf), b0, b1, b2


def popcount8(v):
    """Popcount of a value in [0, 255] (int32 lanes, elementwise ops only)."""
    v = v - ((v >> 1) & 0x55)
    v = (v & 0x33) + ((v >> 2) & 0x33)
    return (v + (v >> 4)) & 0x0F
