"""Two-level BVH for instanced geometry (ObjectInstance).

TPU-native analog of the reference's TransformedPrimitive + per-instance
BVHs (/root/reference/src/primitive.rs:136-176,
src/loading/scene.rs:814-866): each *object* (the shapes recorded
between ObjectBegin/End) gets its own BVH8; a top-level BVH8 over the
instances' world-space bounds selects instances; entering an instance
transforms the ray into object space (affine, so the t parameterization
is invariant — pbrt's un-normalized-direction trick) and traversal
continues inside the object tree; a restore marker on the per-lane
stack switches the lane back to world space when the subtree is
exhausted.

Memory: N instances of a T-triangle object cost ONE object BVH + N
(transform + instance-entry row) — not N*T triangles (VERDICT r2 #7).

Layout (extends ops/bvh8.py rows):

* combined row table = [top tree + instance-entry rows | object trees],
  object child_base / leaf tri ids offset at pack time;
* instance-entry row: col 80 = 9 (sentinel), col 48 = object root row,
  col 72 = instance id — reached only as a child slot of top-tree
  internal rows whose boxes are the instances' world AABBs.

World (non-instanced) geometry stays in the untouched single-level
TriangleSceneData fast path; scene.scene_intersect merges the two
closest hits.  Area lights inside instances are not supported (pbrt
itself ignores them with a warning).
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from shimmer_tpu.ops.bvh8 import MAX_LEAF8, build_bvh8, pack_bvh8
from shimmer_tpu.ops.intersect import intersect_triangle, popcount8
from shimmer_tpu.shapes.triangle import (
    _attr_for,
    _concat_meshes,
    build_triangle_interaction,
)
from shimmer_tpu.utils.pytree import pytree_dataclass, static_field

_INST_SENTINEL = 9       # col-80 value tagging an instance-entry row
_MARKER = -1             # stack entry: restore to world space

TRAVERSE_CHUNK = 8


@pytree_dataclass
class InstancedTriangles:
    rows8: jnp.ndarray       # (R, 128) combined row table
    attr_rows: jnp.ndarray   # (T_total, 32) BVH-order attrs, concat objs
    inst_inv: jnp.ndarray    # (I, 12) world->object affine (row-major 3x4)
    inst_fwd: jnp.ndarray    # (I, 12) object->world affine
    world_min: jnp.ndarray   # (3,)
    world_max: jnp.ndarray   # (3,)
    stack_depth: int = static_field(default=24)
    has_normals: bool = static_field(default=False)
    has_uv: bool = static_field(default=False)


def _affine12(m4: np.ndarray) -> np.ndarray:
    return np.asarray(m4, np.float64)[:3, :4].astype(np.float32).reshape(12)


def _apply12(a12, p, w=1.0):
    """Apply (..., 12) row-major 3x4 affines to (..., 3) points (w=1) or
    vectors (w=0)."""
    m = a12.reshape(a12.shape[:-1] + (3, 4))
    return (
        jnp.einsum("...ij,...j->...i", m[..., :3], p, precision=jax.lax.Precision.HIGHEST)
        + w * m[..., 3]
    )


def _pack_object(meshes: list[dict], builder: str) -> dict:
    """One object's BVH8 + attr rows (object space)."""
    cat = _concat_meshes(meshes)
    assert (cat["area_light_id"] < 0).all(), (
        "area lights inside object instances are not supported"
    )
    bvh8 = pack_bvh8(cat["lo"], cat["hi"], cat["tri_p"], builder=builder)
    return {
        "rows": bvh8.rows,
        "attr": _attr_for(cat, bvh8.perm),
        "max_depth": bvh8.max_depth,
        "lo": cat["lo"].min(axis=0),
        "hi": cat["hi"].max(axis=0),
        "has_normals": cat["has_normals"],
        "has_uv": cat["has_uv"],
    }


def build_instanced(
    objects: list[list[dict]],
    instances: list[tuple[int, np.ndarray]],
    builder: str = "auto",
) -> InstancedTriangles:
    """objects: per object, a list of mesh scene-dicts in OBJECT space.
    instances: (object_id, object_to_render 4x4 np array) pairs."""
    obj_packed = [_pack_object(m, builder) for m in objects]

    n_inst = len(instances)
    inst_lo = np.zeros((n_inst, 3), np.float32)
    inst_hi = np.zeros((n_inst, 3), np.float32)
    inst_fwd = np.zeros((n_inst, 12), np.float32)
    inst_inv = np.zeros((n_inst, 12), np.float32)
    for i, (oid, o2r) in enumerate(instances):
        lo, hi = obj_packed[oid]["lo"], obj_packed[oid]["hi"]
        cs = np.array(
            [
                [x, y, z, 1.0]
                for x in (lo[0], hi[0])
                for y in (lo[1], hi[1])
                for z in (lo[2], hi[2])
            ]
        )
        m = np.asarray(o2r, np.float64)
        w = (m @ cs.T).T
        w = w[:, :3] / w[:, 3:4]
        inst_lo[i] = w.min(axis=0).astype(np.float32)
        inst_hi[i] = w.max(axis=0).astype(np.float32)
        inst_fwd[i] = _affine12(m)
        inst_inv[i] = _affine12(np.linalg.inv(m))

    top_arrs, top_leaf_rows = build_bvh8(inst_lo, inst_hi, builder="lbvh")
    rows_top = top_arrs.rows.copy()
    n_top = top_arrs.n_rows
    perm = top_arrs.perm
    # Convert each top leaf row (count perm-ordered instances) into an
    # internal row whose children are instance-entry rows.
    entry = []   # (row, instance_id)
    next_row = n_top
    for (r, first, count, _s) in top_leaf_rows:
        base = next_row
        rows_top[r, :] = 0.0
        rows_top[r, 48] = float(base)
        for j in range(count):
            inst = int(perm[first + j])
            rows_top[r, 0 + j] = inst_lo[inst, 0]
            rows_top[r, 8 + j] = inst_lo[inst, 1]
            rows_top[r, 16 + j] = inst_lo[inst, 2]
            rows_top[r, 24 + j] = inst_hi[inst, 0]
            rows_top[r, 32 + j] = inst_hi[inst, 1]
            rows_top[r, 40 + j] = inst_hi[inst, 2]
            rows_top[r, 88 + j] = 1.0
            entry.append((base + j, inst))
            next_row += 1

    rows0 = np.zeros((next_row, 128), np.float32)
    rows0[:n_top] = rows_top
    for er, inst in entry:
        rows0[er, 80] = float(_INST_SENTINEL)
        rows0[er, 72] = float(inst)

    # Append object blocks with row/tri offsets.
    blocks = [rows0]
    attr_all = []
    obj_root_abs = []
    row_off = next_row
    tri_off = 0
    max_obj_depth = 0
    for packed in obj_packed:
        orows = packed["rows"].copy()
        is_int = orows[:, 80] == 0.0
        orows[is_int, 48] += row_off
        is_leaf = orows[:, 80] > 0.0
        for k in range(MAX_LEAF8):
            orows[is_leaf, 72 + k] += tri_off
        blocks.append(orows)
        attr_all.append(packed["attr"])
        obj_root_abs.append(row_off)
        row_off += orows.shape[0]
        tri_off += packed["attr"].shape[0]
        max_obj_depth = max(max_obj_depth, packed["max_depth"])
    rows = np.concatenate(blocks, axis=0)
    for er, inst in entry:
        rows[er, 48] = float(obj_root_abs[instances[inst][0]])

    return InstancedTriangles(
        rows8=jnp.asarray(rows),
        attr_rows=jnp.asarray(np.concatenate(attr_all, axis=0)),
        inst_inv=jnp.asarray(inst_inv),
        inst_fwd=jnp.asarray(inst_fwd),
        world_min=jnp.asarray(inst_lo.min(axis=0)),
        world_max=jnp.asarray(inst_hi.max(axis=0)),
        stack_depth=int(top_arrs.max_depth) + max_obj_depth + 4,
        has_normals=any(p["has_normals"] for p in obj_packed),
        has_uv=any(p["has_uv"] for p in obj_packed),
    )


def _traverse_inst(
    data: InstancedTriangles, ray_o, ray_d, t_max, any_hit=False
):
    """Two-level lock-step bitstack traversal.

    Like triangle.py::_traverse (lowest-bit-first order — the ordered
    descent is left to the single-level fast path) plus per-lane
    current-space ray state: entering an instance-entry row transforms
    the ray into object space and pushes a restore marker.

    Returns (t, tri_idx, b0, b1, b2, verts_obj, inst_idx).
    """
    n = ray_o.shape[0]
    rows_tab = data.rows8
    depth = data.stack_depth + 2
    want_any = jnp.broadcast_to(jnp.asarray(any_hit, bool), (n,))
    lane8 = jnp.arange(MAX_LEAF8, dtype=jnp.int32)
    stack_iota = jnp.arange(depth, dtype=jnp.int32)
    bit_pow = (1 << lane8).astype(jnp.int32)

    def lane_active(group, sp, tri_best):
        alive = ((group & 255) > 0) | (sp > 0)
        return alive & ~(want_any & (tri_best >= 0))

    def step(state):
        (group, sp, stack, t_best, tri_best, b0, b1, verts,
         o_cur, d_cur, inst_cur, inst_best) = state

        active = lane_active(group, sp, tri_best)

        # Pop when the current group is empty; markers restore world.
        need_pop = active & ((group & 255) == 0)
        sp_p = sp - need_pop.astype(jnp.int32)
        sel = stack_iota[None, :] == sp_p[:, None]
        popped = jnp.sum(jnp.where(sel, stack, 0), axis=1)
        is_marker = need_pop & (popped == _MARKER)
        o_cur = jnp.where(is_marker[:, None], ray_o, o_cur)
        d_cur = jnp.where(is_marker[:, None], ray_d, d_cur)
        inst_cur = jnp.where(is_marker, -1, inst_cur)
        group = jnp.where(
            need_pop, jnp.where(is_marker, 0, popped), group
        )
        sp = sp_p
        active = active & ~is_marker

        inv_cur = 1.0 / jnp.where(d_cur == 0.0, 1e-30, d_cur)

        mask = group & 255
        t_low = mask & -mask
        k = popcount8(t_low - 1)
        row_idx = (group >> 8) + k
        group_rem = group - t_low
        row_idx = jnp.where(active, row_idx, 0)
        row = rows_tab[row_idx]                  # THE gather (N, 128)

        count = row[:, 80].astype(jnp.int32)
        is_leaf = active & (count > 0) & (count <= MAX_LEAF8)
        is_int = active & (count == 0)
        is_inst = active & (count == _INST_SENTINEL)

        # Internal: slab test in the lane's current space.
        ox, oy, oz = o_cur[:, 0:1], o_cur[:, 1:2], o_cur[:, 2:3]
        ix, iy, iz = inv_cur[:, 0:1], inv_cur[:, 1:2], inv_cur[:, 2:3]
        t0x = (row[:, 0:8] - ox) * ix
        t1x = (row[:, 24:32] - ox) * ix
        t0y = (row[:, 8:16] - oy) * iy
        t1y = (row[:, 32:40] - oy) * iy
        t0z = (row[:, 16:24] - oz) * iz
        t1z = (row[:, 40:48] - oz) * iz
        t_near = jnp.maximum(
            jnp.maximum(jnp.minimum(t0x, t1x), jnp.minimum(t0y, t1y)),
            jnp.minimum(t0z, t1z),
        )
        t_far = jnp.minimum(
            jnp.minimum(jnp.maximum(t0x, t1x), jnp.maximum(t0y, t1y)),
            jnp.maximum(t0z, t1z),
        )
        hit8 = (
            (t_near <= t_far * 1.0001)
            & (t_far > 0.0)
            & (t_near < t_best[:, None])
            & (row[:, 88:96] > 0.0)
            & is_int[:, None]
        )
        hmask = jnp.sum(jnp.where(hit8, bit_pow[None, :], 0), axis=1)
        child_base = row[:, 48].astype(jnp.int32)
        child_group = (child_base << 8) | hmask

        # Leaf: watertight intersect in the current space (t invariant
        # under the affine map since d is unnormalized, primitive.rs:150).
        p0 = jnp.stack([row[:, 0:8], row[:, 8:16], row[:, 16:24]], axis=-1)
        p1 = jnp.stack([row[:, 24:32], row[:, 32:40], row[:, 40:48]], axis=-1)
        p2 = jnp.stack([row[:, 48:56], row[:, 56:64], row[:, 64:72]], axis=-1)
        h, t, bb0, bb1, bb2 = intersect_triangle(
            o_cur[:, None, :], d_cur[:, None, :], t_best[:, None], p0, p1, p2
        )
        in_leaf = is_leaf[:, None] & (lane8[None, :] < count[:, None])
        t = jnp.where(h & in_leaf, t, jnp.inf)
        k_best = jnp.argmin(t, axis=-1)
        oh = lane8[None, :] == k_best[:, None]
        t_new = jnp.min(t, axis=-1)
        closer = t_new < t_best
        pick = lambda x: jnp.sum(jnp.where(oh, x, 0.0), axis=-1)
        t_best = jnp.where(closer, t_new, t_best)
        tri_best = jnp.where(
            closer, pick(row[:, 72:80]).astype(jnp.int32), tri_best
        )
        inst_best = jnp.where(closer, inst_cur, inst_best)
        b0 = jnp.where(closer, pick(bb0), b0)
        b1 = jnp.where(closer, pick(bb1), b1)
        verts_new = jnp.concatenate(
            [
                jnp.sum(jnp.where(oh[:, :, None], v, 0.0), axis=1)
                for v in (p0, p1, p2)
            ],
            axis=-1,
        )
        verts = jnp.where(closer[:, None], verts_new, verts)

        # Instance entry: switch to object space, push restore marker.
        inst_id = row[:, 72].astype(jnp.int32)
        inv12 = data.inst_inv[jnp.where(is_inst, inst_id, 0)]
        o_inst = _apply12(inv12, ray_o, 1.0)
        d_inst = _apply12(inv12, ray_d, 0.0)
        o_cur = jnp.where(is_inst[:, None], o_inst, o_cur)
        d_cur = jnp.where(is_inst[:, None], d_inst, d_cur)
        inst_cur = jnp.where(is_inst, inst_id, inst_cur)
        root_group = (row[:, 48].astype(jnp.int32) << 8) | 1

        # Transition: internal descends into hit children as one group;
        # instance pushes marker then descends into the object root.
        descend_int = is_int & (hmask > 0)
        push_rem = (descend_int | is_inst) & ((group_rem & 255) > 0)
        push_marker = is_inst
        pos1 = sp
        pos2 = sp + push_rem.astype(jnp.int32)
        oh1 = (stack_iota[None, :] == pos1[:, None]) & push_rem[:, None]
        stack = jnp.where(oh1, group_rem[:, None], stack)
        oh2 = (stack_iota[None, :] == pos2[:, None]) & push_marker[:, None]
        stack = jnp.where(oh2, jnp.int32(_MARKER), stack)
        sp = sp + push_rem.astype(jnp.int32) + push_marker.astype(jnp.int32)
        group_next = jnp.where(
            is_inst,
            root_group,
            jnp.where(descend_int, child_group, group_rem),
        )
        group = jnp.where(active, group_next, group)
        return (group, sp, stack, t_best, tri_best, b0, b1, verts,
                o_cur, d_cur, inst_cur, inst_best)

    def cond(state):
        return jnp.any(lane_active(state[0], state[1], state[4]))

    def chunk(state):
        return jax.lax.fori_loop(
            0, TRAVERSE_CHUNK, lambda i, s: step(s), state
        )

    state = (
        jnp.ones(n, jnp.int32),            # group: row 0, mask=1
        jnp.zeros(n, jnp.int32),           # sp
        jnp.zeros((n, depth), jnp.int32),  # stack
        jnp.asarray(jnp.broadcast_to(t_max, (n,)), jnp.float32),
        jnp.full(n, -1, jnp.int32),        # tri_best
        jnp.zeros(n, jnp.float32),         # b0
        jnp.zeros(n, jnp.float32),         # b1
        jnp.zeros((n, 9), jnp.float32),    # verts (object space)
        ray_o,                             # o_cur
        ray_d,                             # d_cur
        jnp.full(n, -1, jnp.int32),        # inst_cur
        jnp.full(n, -1, jnp.int32),        # inst_best
    )
    state = jax.lax.while_loop(cond, chunk, state)
    (_, _, _, t_best, tri_best, b0, b1, verts, _, _, _, inst_best) = state
    b2 = jnp.where(tri_best >= 0, 1.0 - b0 - b1, 0.0)
    t_best = jnp.where(tri_best >= 0, t_best, jnp.inf)
    return t_best, tri_best, b0, b1, b2, verts, inst_best


def instanced_intersect(data: InstancedTriangles, ray_o, ray_d, t_max,
                        want_any=False):
    """Closest hit against the instanced geometry; SurfaceInteraction in
    WORLD space (TransformedPrimitive::intersect semantics,
    primitive.rs:136-176)."""
    t, tri, b0, b1, b2, verts_obj, inst = _traverse_inst(
        data,
        jax.lax.stop_gradient(ray_o),
        jax.lax.stop_gradient(ray_d),
        jax.lax.stop_gradient(t_max),
        any_hit=want_any,
    )
    inst_c = jnp.maximum(inst, 0)
    fwd = data.inst_fwd[inst_c]
    p0 = _apply12(fwd, verts_obj[..., 0:3], 1.0)
    p1 = _apply12(fwd, verts_obj[..., 3:6], 1.0)
    p2 = _apply12(fwd, verts_obj[..., 6:9], 1.0)
    inv = data.inst_inv[inst_c]

    def ns_transform(ns):
        # normals map by the inverse transpose: n_w = A^-T n_o, i.e.
        # n_w[i] = sum_j inv[j, i] * n_o[j].
        m = inv.reshape(inv.shape[:-1] + (3, 4))[..., :3]
        return jnp.einsum("...ji,...j->...i", m, ns, precision=jax.lax.Precision.HIGHEST)

    return build_triangle_interaction(
        data.attr_rows, data.has_normals, ray_o, ray_d,
        t, tri, b0, b1, b2, p0, p1, p2,
        ns_transform=ns_transform,
    )


def instanced_occluded(data: InstancedTriangles, ray_o, ray_d, t_max):
    _, tri, *_ = _traverse_inst(
        data,
        jax.lax.stop_gradient(ray_o),
        jax.lax.stop_gradient(ray_d),
        jax.lax.stop_gradient(t_max),
        any_hit=True,
    )
    return tri >= 0
