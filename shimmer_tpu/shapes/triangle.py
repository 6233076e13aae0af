"""Triangle meshes: watertight intersection, 8-wide bitstack BVH
traversal, solid-angle sampling.

TPU-native analog of /root/reference/src/shape/triangle.rs + mesh.rs +
aggregate.rs.  All scene triangle meshes are concatenated into one vertex
pool + index table, pre-transformed to render space at build (the reference
does the same per mesh, mesh.rs:39-46).  Intersection implements the
watertight translate-permute-shear algorithm (triangle.rs:173-302 —
algorithm only; the f64 edge-function fallback is omitted, f32 edge
functions use difference_of_products compensation instead).

Traversal: each step fetches ONE 512-byte row of the 8-wide BVH
(ops/bvh8.py) that is either 8 child boxes (slab-tested as an (N, 8)
tile) or 8 inline triangles (intersected as an (N, 8) tile), so a ray
needs about log8 levels of dependent row fetches.  Traversal state is a
per-lane int32 "group" = child_base*256 + pending-hit mask plus a short
explicit stack; the reference's ordered stack walk (aggregate.rs:71-139)
becomes pop-lowest-bit / push-remainder.  Closest-hit and any-hit
(shadow) lanes share one traversal via a per-lane ``want_any`` flag so a
path-tracing bounce costs a single traversal dispatch.  ``_traverse`` is
the plain XLA form and the reference; on a GPU ``_traverse_raw`` runs
the same algorithm as a kernel (ops/traverse_gpu.py).

Integer topology fields are stored as exact small floats (< 2^24) — no bit
casts, so NaN canonicalization or denormal flushing cannot corrupt the
tree (advisor r1).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from shimmer_tpu.ops.bvh8 import MAX_LEAF8, pack_bvh8
from shimmer_tpu.ops.intersect import intersect_triangle, popcount8
from shimmer_tpu.ops.math import difference_of_products
from shimmer_tpu.ops.sampling import (
    sample_spherical_triangle,
    sample_uniform_triangle,
)
from shimmer_tpu.ops.vecmath import (
    cross,
    distance_squared,
    dot,
    length,
    length_squared,
    normalize,
    spherical_triangle_area,
)
from shimmer_tpu.shapes.interaction import SurfaceInteraction
from shimmer_tpu.utils.pytree import pytree_dataclass, static_field

# Solid-angle sampling thresholds (triangle.rs:548-560 / pbrt).
MIN_SPHERICAL_SAMPLE_AREA = 3e-4
MAX_SPHERICAL_SAMPLE_AREA = 6.22

# Attribute-row columns (one (32,) f32 row per BVH-sorted triangle).
_ATTR_W = 32
_A_UV = 0        # 0:6   uv0, uv1, uv2
_A_NS = 6        # 6:15  n0, n1, n2 (zeros when the mesh has no normals)
_A_MAT = 15      # material id (may be -1)
_A_ALI = 16      # area light id (may be -1)
_A_REV = 17      # reverse_orientation flag (0/1)
_A_ORIG = 18     # original (pre-BVH-sort) triangle index
_A_P0 = 19       # 19:28 p0,p1,p2 render-space vertices — the fast
#                  interaction path reads ONE packed row per hit instead
#                  of an index gather + 3 vertex-pool gathers
_A_MI = 28       # MediumInterface inside id (-2 = undeclared, -1 = vacuum)
_A_MO = 29       # MediumInterface outside id

# Light-row columns (one (16,) f32 row per ORIGINAL-order triangle).
_LIGHT_W = 16    # 0:9 p0,p1,p2 | 9 rev


@pytree_dataclass
class TriangleSceneData:
    # Vertex pools (render space) — kept for sampling + the optional
    # differentiable re-intersection path.
    p: jnp.ndarray          # (V, 3)
    n: jnp.ndarray          # (V, 3) shading normals (zeros if absent)
    uv: jnp.ndarray         # (V, 2)
    # BVH-ordered triangle index table (differentiable re-gather path).
    indices: jnp.ndarray    # (T, 3) int32 into vertex pool
    # Original-order triangle table (light sampling by shape index):
    orig_indices: jnp.ndarray  # (T, 3)
    orig_rev: jnp.ndarray      # (T,) bool
    tri_area: jnp.ndarray      # (T,)
    # Hot-path packed tables:
    rows8: jnp.ndarray       # (R, 128) f32 — see ops/bvh8.py layout
    attr_rows: jnp.ndarray   # (T, 32) f32, BVH order
    light_rows: jnp.ndarray  # (T, 16) f32, original order
    world_min: jnp.ndarray   # (3,)
    world_max: jnp.ndarray   # (3,)
    stack_depth: int = static_field(default=16)
    # Traversal backend: "auto" = the GPU kernel (ops/traverse_gpu.py) on
    # a GPU, the XLA reference ``_traverse`` elsewhere; "xla" forces the
    # reference; "interpret" runs the kernel in Pallas interpret mode
    # (tests only).
    traversal: str = static_field(default="auto")
    has_normals: bool = static_field(default=False)
    has_uv: bool = static_field(default=False)
    # Any mesh declares a MediumInterface (attr cols _A_MI/_A_MO used).
    has_iface_media: bool = static_field(default=False)
    # When True, the chosen triangle is re-intersected differentiably from
    # the vertex pool after the (detached) traversal, so gradients flow to
    # vertex positions.  Costs ~4 extra row gathers per query.
    differentiable_hits: bool = static_field(default=False)


def _concat_meshes(meshes: list[dict]) -> dict:
    """Concatenate mesh dicts into one SoA pool (+ per-tri AABBs)."""
    ps, ns, uvs, idxs = [], [], [], []
    mats, ali, revs = [], [], []
    med_in, med_out = [], []
    v_off = 0
    any_n = any("n" in m and m["n"] is not None for m in meshes)
    any_uv = any("uv" in m and m["uv"] is not None for m in meshes)
    for m in meshes:
        p = np.asarray(m["p"], np.float32)
        idx = np.asarray(m["indices"], np.int32).reshape(-1, 3)
        v = p.shape[0]
        t = idx.shape[0]
        ps.append(p)
        n = m.get("n")
        ns.append(
            np.asarray(n, np.float32) if n is not None else np.zeros((v, 3), np.float32)
        )
        uv = m.get("uv")
        uvs.append(
            np.asarray(uv, np.float32)
            if uv is not None
            else np.zeros((v, 2), np.float32)
        )
        idxs.append(idx + v_off)
        mats.append(np.full(t, m.get("material_id", -1), np.int32))
        med_in.append(np.full(t, m.get("medium_inside", -2), np.int32))
        med_out.append(np.full(t, m.get("medium_outside", -2), np.int32))
        a = m.get("area_light_id", -1)
        ali.append(
            np.asarray(a, np.int32)
            if np.ndim(a) > 0
            else np.full(t, a, np.int32)
        )
        revs.append(np.full(t, bool(m.get("reverse_orientation", False))))
        v_off += v
    p = np.concatenate(ps)
    indices = np.concatenate(idxs)
    tri_p = p[indices]  # (T, 3, 3)
    return {
        "p": p,
        "n": np.concatenate(ns),
        "uv": np.concatenate(uvs),
        "indices": indices,
        "material_id": np.concatenate(mats),
        "medium_in": np.concatenate(med_in),
        "medium_out": np.concatenate(med_out),
        "area_light_id": np.concatenate(ali),
        "rev": np.concatenate(revs),
        "tri_p": tri_p,
        "lo": tri_p.min(axis=1),
        "hi": tri_p.max(axis=1),
        "has_normals": any_n,
        "has_uv": any_uv,
    }


def _attr_for(cat: dict, perm: np.ndarray) -> np.ndarray:
    """Pack the per-triangle shading attr rows in BVH (perm) order."""
    sorted_indices = cat["indices"][perm].astype(np.int32)
    t_n = sorted_indices.shape[0]
    attr = np.zeros((t_n, _ATTR_W), np.float32)
    tri_uv = cat["uv"][sorted_indices]  # (T, 3, 2)
    # Default UVs (0,0),(1,0),(1,1) when a triangle has none
    # (triangle.rs:361-369).
    no_uv = np.abs(tri_uv).sum(axis=(1, 2)) == 0.0
    tri_uv[no_uv] = np.array([[0.0, 0.0], [1.0, 0.0], [1.0, 1.0]], np.float32)
    attr[:, _A_UV : _A_UV + 6] = tri_uv.reshape(t_n, 6)
    attr[:, _A_NS : _A_NS + 9] = cat["n"][sorted_indices].reshape(t_n, 9)
    attr[:, _A_MAT] = cat["material_id"][perm].astype(np.float32)
    attr[:, _A_ALI] = cat["area_light_id"][perm].astype(np.float32)
    attr[:, _A_REV] = cat["rev"][perm].astype(np.float32)
    attr[:, _A_ORIG] = perm.astype(np.float32)
    attr[:, _A_P0 : _A_P0 + 9] = cat["tri_p"][perm].reshape(t_n, 9)
    attr[:, _A_MI] = cat["medium_in"][perm].astype(np.float32)
    attr[:, _A_MO] = cat["medium_out"][perm].astype(np.float32)
    return attr


def build_triangle_scene(
    meshes: list[dict],
    leaf_size: int = MAX_LEAF8,
    differentiable_hits: bool = False,
    traversal: str = "auto",
) -> TriangleSceneData:
    """Host: concatenate meshes, build the BVH, pack the fat tables.

    Each mesh dict: ``p`` (V,3 render-space vertices), ``indices`` (T,3),
    optional ``n`` (V,3), ``uv`` (V,2), ``material_id``, ``area_light_id``
    (per mesh scalar or per-tri array), ``reverse_orientation`` bool.
    """
    cat = _concat_meshes(meshes)
    p, n, uv = cat["p"], cat["n"], cat["uv"]
    indices, rev, tri_p = cat["indices"], cat["rev"], cat["tri_p"]
    any_n, any_uv = cat["has_normals"], cat["has_uv"]
    lo, hi = cat["lo"], cat["hi"]
    bvh8 = pack_bvh8(lo, hi, tri_p)

    # BVH-order permuted tables.
    perm = bvh8.perm
    sorted_indices = indices[perm].astype(np.int32)

    e1 = tri_p[:, 1] - tri_p[:, 0]
    e2 = tri_p[:, 2] - tri_p[:, 0]
    area = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1)

    t_n = sorted_indices.shape[0]
    attr = _attr_for(cat, perm)

    light_rows = np.zeros((t_n, _LIGHT_W), np.float32)
    light_rows[:, 0:9] = tri_p.reshape(t_n, 9)
    light_rows[:, 9] = rev.astype(np.float32)

    return TriangleSceneData(
        p=jnp.asarray(p),
        n=jnp.asarray(n),
        uv=jnp.asarray(uv),
        indices=jnp.asarray(sorted_indices),
        orig_indices=jnp.asarray(indices),
        orig_rev=jnp.asarray(rev),
        tri_area=jnp.asarray(area, jnp.float32),
        rows8=jnp.asarray(bvh8.rows),
        attr_rows=jnp.asarray(attr),
        light_rows=jnp.asarray(light_rows),
        world_min=jnp.asarray(lo.min(axis=0)),
        world_max=jnp.asarray(hi.max(axis=0)),
        stack_depth=bvh8.max_depth,
        traversal=traversal,
        has_normals=any_n,
        has_uv=any_uv,
        has_iface_media=bool(
            (cat["medium_in"] > -2).any() or (cat["medium_out"] > -2).any()
        ),
        differentiable_hits=differentiable_hits,
    )


def _gather_tri(tris: TriangleSceneData, tri_idx):
    idx = tris.indices[tri_idx]  # (..., 3)
    p0 = tris.p[idx[..., 0]]
    p1 = tris.p[idx[..., 1]]
    p2 = tris.p[idx[..., 2]]
    return idx, p0, p1, p2


# Inner fori steps per outer while iteration: the while predicate's
# any() reduction is evaluated once per chunk of unconditional steps.
TRAVERSE_CHUNK = 8


def _traverse(
    tris: TriangleSceneData, ray_o, ray_d, t_max, any_hit=False,
    with_stats=False, raw=False,
):
    """Lock-step 8-wide bitstack BVH traversal (see ops/bvh8.py).

    any_hit: python bool (whole call) OR a per-lane (N,) bool array —
    any-hit lanes terminate at their first accepted hit, so shadow rays
    and closest-hit rays share one traversal dispatch.

    Returns (t, tri_idx, b0, b1, b2, tri_verts) with tri_idx = -1 for
    misses and tri_verts (..., 9) the winning triangle's vertices (from
    the leaf row, so no post-traversal vertex gather is needed).
    With ``raw=True`` only (t, tri_idx) are computed — b0/b1/verts are
    dropped from the loop state entirely, matching the minimal contract
    of _traverse_raw (callers re-intersect the winner when they need
    barycentrics), which saves the dead pick work and loop-state
    memory traffic (advisor r3).

    Each step costs ONE (N, 128) row gather — the dominant cost — plus
    VPU tile work: an (N, 8) slab test or an (N, 8) watertight triangle
    intersect, both masked by row kind.

    Traversal order (aggregate.rs:92-136 near-child-first analog, adapted
    to the 8-wide layout): each internal visit descends directly into the
    *nearest* hit child and pushes the sibling remainder together with a
    conservative entry distance; popped groups whose stored distance is
    already beyond t_best are pruned without a gather.  Both cut the
    per-lane visit count — the sequential cost — roughly 2x on closest-hit
    rays vs lowest-bit-first order.
    """
    n = ray_o.shape[0]
    rows_tab = tris.rows8
    # Stack occupancy is bounded by one group per tree level plus slack:
    # push1 only re-pushes the popped level's remainder and push2 targets
    # the next level, so at most one in-flight remainder group exists per
    # level (advisor r2 — halves per-lane stack HBM vs the 2x bound).
    depth = tris.stack_depth + 2
    inv_d = 1.0 / jnp.where(ray_d == 0.0, 1e-30, ray_d)
    want_any = jnp.broadcast_to(jnp.asarray(any_hit, bool), (n,))
    lane8 = jnp.arange(MAX_LEAF8, dtype=jnp.int32)
    stack_iota = jnp.arange(depth, dtype=jnp.int32)
    bit_pow = (1 << lane8).astype(jnp.int32)

    def lane_active(group, sp, tri_best):
        alive = ((group & 255) > 0) | (sp > 0)
        return alive & ~(want_any & (tri_best >= 0))

    def step(state):
        # visits is only carried (and only traced) when with_stats is set —
        # XLA cannot DCE loop-carried state, so the stats counter must not
        # ride in the hot loop by default (advisor r2).
        (group, group_t, sp, stack, stack_t, t_best, tri_best) = state[:7]
        if not raw:
            b0, b1, verts = state[7:10]
        active = lane_active(group, sp, tri_best)

        # Pop when the current group has no pending bits; prune popped
        # groups whose conservative entry distance can no longer win.
        need_pop = active & ((group & 255) == 0)
        sp_p = sp - need_pop.astype(jnp.int32)
        sel = stack_iota[None, :] == sp_p[:, None]
        popped = jnp.sum(jnp.where(sel, stack, 0), axis=1)
        popped_t = jnp.sum(jnp.where(sel, stack_t, 0.0), axis=1)
        pruned = need_pop & (popped_t >= t_best)
        group = jnp.where(need_pop, jnp.where(pruned, 0, popped), group)
        group_t = jnp.where(need_pop, popped_t, group_t)
        sp = sp_p
        active = active & ~pruned

        # Lowest pending bit -> row index.
        mask = group & 255
        t_low = mask & -mask
        k = popcount8(t_low - 1)
        row_idx = (group >> 8) + k
        group_rem = group - t_low
        row_idx = jnp.where(active, row_idx, 0)
        row = rows_tab[row_idx]                  # THE gather (N, 128)
        if with_stats:
            visits = state[-1] + active.astype(jnp.int32)

        count = row[:, 80].astype(jnp.int32)
        is_leaf = active & (count > 0)
        is_int = active & (count == 0)

        # Internal: slab-test 8 child boxes as an (N, 8) tile
        # (bounding_box.rs:483-553 semantics, conservative t_far pad).
        ox, oy, oz = ray_o[:, 0:1], ray_o[:, 1:2], ray_o[:, 2:3]
        ix, iy, iz = inv_d[:, 0:1], inv_d[:, 1:2], inv_d[:, 2:3]
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
            & (row[:, 88:96] > 0.0)   # slot-valid flags (empty = 0 box)
            & is_int[:, None]
        )
        hmask = jnp.sum(jnp.where(hit8, bit_pow[None, :], 0), axis=1)
        child_base = row[:, 48].astype(jnp.int32)
        # Nearest hit child + remainder (ordered descent).
        tn = jnp.where(hit8, jnp.maximum(t_near, 0.0), jnp.inf)
        k_near = jnp.argmin(tn, axis=-1).astype(jnp.int32)
        near_t = jnp.min(tn, axis=-1)
        near_bit = (1 << k_near).astype(jnp.int32)
        child_rem = hmask & ~near_bit
        tn2 = jnp.where(lane8[None, :] == k_near[:, None], jnp.inf, tn)
        child_rem_t = jnp.min(tn2, axis=-1)
        child_group = ((child_base + k_near) << 8) | 1

        # Leaf: intersect 8 inline triangles as an (N, 8) tile.
        p0 = jnp.stack([row[:, 0:8], row[:, 8:16], row[:, 16:24]], axis=-1)
        p1 = jnp.stack([row[:, 24:32], row[:, 32:40], row[:, 40:48]], axis=-1)
        p2 = jnp.stack([row[:, 48:56], row[:, 56:64], row[:, 64:72]], axis=-1)
        h, t, bb0, bb1, bb2 = intersect_triangle(
            ray_o[:, None, :], ray_d[:, None, :], t_best[:, None], p0, p1, p2
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
        if not raw:
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

        # Transition: descend into the nearest hit child; push (a) the
        # current group's sibling remainder (conservative entry = the
        # group's own creation distance) and (b) the hit-children
        # remainder (exact second-nearest entry distance).
        descend = is_int & (hmask > 0)
        push1 = descend & ((group_rem & 255) > 0)
        push2 = descend & (child_rem > 0)
        pos1 = sp
        pos2 = sp + push1.astype(jnp.int32)
        oh1 = (stack_iota[None, :] == pos1[:, None]) & push1[:, None]
        stack = jnp.where(oh1, group_rem[:, None], stack)
        stack_t = jnp.where(oh1, group_t[:, None], stack_t)
        oh2 = (stack_iota[None, :] == pos2[:, None]) & push2[:, None]
        crem_group = (child_base << 8) | child_rem
        stack = jnp.where(oh2, crem_group[:, None], stack)
        stack_t = jnp.where(oh2, child_rem_t[:, None], stack_t)
        sp = sp + push1.astype(jnp.int32) + push2.astype(jnp.int32)
        group_next = jnp.where(descend, child_group, group_rem)
        group = jnp.where(active, group_next, group)
        group_t = jnp.where(descend, near_t, group_t)
        out = (group, group_t, sp, stack, stack_t, t_best, tri_best)
        if not raw:
            out = out + (b0, b1, verts)
        if with_stats:
            out = out + (visits,)
        return out

    def cond(state):
        return jnp.any(lane_active(state[0], state[2], state[6]))

    def chunk(state):
        return jax.lax.fori_loop(
            0, TRAVERSE_CHUNK, lambda i, s: step(s), state
        )

    state = (
        jnp.ones(n, jnp.int32),            # group: row 0, mask=1
        jnp.zeros(n, jnp.float32),         # group_t
        jnp.zeros(n, jnp.int32),           # sp
        jnp.zeros((n, depth), jnp.int32),  # stack
        jnp.zeros((n, depth), jnp.float32),  # stack_t
        jnp.asarray(jnp.broadcast_to(t_max, (n,)), jnp.float32),
        jnp.full(n, -1, jnp.int32),
    )
    if not raw:
        state = state + (
            jnp.zeros(n, jnp.float32),
            jnp.zeros(n, jnp.float32),
            jnp.zeros((n, 9), jnp.float32),
        )
    if with_stats:
        state = state + (jnp.zeros(n, jnp.int32),)  # visits
    state = jax.lax.while_loop(cond, chunk, state)
    t_best, tri_best = state[5], state[6]
    if raw:
        t_best = jnp.where(tri_best >= 0, t_best, jnp.inf)
        if with_stats:
            return t_best, tri_best, state[-1]
        return t_best, tri_best
    b0, b1, verts = state[7], state[8], state[9]
    b2 = jnp.where(tri_best >= 0, 1.0 - b0 - b1, 0.0)
    if with_stats:
        return t_best, tri_best, b0, b1, b2, verts, state[-1]
    return t_best, tri_best, b0, b1, b2, verts


TRAVERSALS = ("auto", "xla", "interpret")


def _traverse_raw(tris: TriangleSceneData, ray_o, ray_d, t_max, any_hit):
    """Backend dispatch, resolved at trace time.  Both paths return only
    ``(t, tri)`` with t = +inf on miss; barycentrics and vertices are
    re-derived by callers that need them (one attribute-row gather and a
    re-intersection), which keeps shadow-only queries cheap.

    ``tris.traversal``: "auto" takes the GPU kernel on a GPU and the XLA
    reference elsewhere; "xla" forces the reference; "interpret" runs the
    kernel in Pallas interpret mode (tests only).  A kernel that fails to
    compile fails the call: there is no silent fallback."""
    if tris.traversal not in TRAVERSALS:
        raise ValueError(f"unknown traversal {tris.traversal!r}")
    interpret = tris.traversal == "interpret"
    if interpret or (
        tris.traversal == "auto" and jax.default_backend() == "gpu"
    ):
        from shimmer_tpu.ops.traverse_gpu import traverse_gpu_raw

        return traverse_gpu_raw(
            tris, ray_o, ray_d, t_max, any_hit=any_hit, interpret=interpret
        )
    return _traverse(tris, ray_o, ray_d, t_max, any_hit=any_hit, raw=True)


def triangle_scene_intersect(
    tris: TriangleSceneData, ray_o, ray_d, t_max, want_any=False
) -> SurfaceInteraction:
    """Closest-hit + interaction construction
    (triangle.rs:305-504 interaction_from_intersection).

    want_any: per-lane any-hit flags (see scene.scene_intersect)."""
    # Traversal runs on detached rays (lax.while_loop is not reverse-mode
    # differentiable, and hit *topology* is discrete anyway).
    t, tri = _traverse_raw(
        tris,
        jax.lax.stop_gradient(ray_o),
        jax.lax.stop_gradient(ray_d),
        jax.lax.stop_gradient(t_max),
        any_hit=want_any,
    )
    return triangle_interaction_from_raw(tris, ray_o, ray_d, tri)


def triangle_interaction_from_raw(
    tris: TriangleSceneData, ray_o, ray_d, tri
) -> SurfaceInteraction:
    """Interaction from a raw traversal result (winning tri per lane).

    Re-intersects the winning triangle (identical watertight formulas,
    so the hit decision reproduces bit-for-bit given equal inputs).
    With differentiable_hits this is the standard detached-traversal
    construction for differentiable rendering: gradients flow through
    the re-intersection to ray and vertex positions (vertex-pool
    gathers); otherwise everything comes from ONE packed attr-row gather
    per hit (cols _A_P0+ hold the verts) and it is purely the
    (t, b0, b1, b2) rebuild."""
    tri_c = jnp.maximum(tri, 0)
    attr = None
    if tris.differentiable_hits:
        _, p0, p1, p2 = _gather_tri(tris, tri_c)
        ro, rd = ray_o, ray_d
    else:
        attr = tris.attr_rows[tri_c]                 # (N, 32) — THE gather
        p0 = attr[..., _A_P0 + 0 : _A_P0 + 3]
        p1 = attr[..., _A_P0 + 3 : _A_P0 + 6]
        p2 = attr[..., _A_P0 + 6 : _A_P0 + 9]
        ro = jax.lax.stop_gradient(ray_o)
        rd = jax.lax.stop_gradient(ray_d)
    _, t, b0, b1, b2 = intersect_triangle(
        ro, rd, jnp.full(ray_o.shape[:-1], jnp.inf), p0, p1, p2
    )
    # Miss lanes would otherwise carry finite-but-garbage barycentrics
    # derived from triangle 0; zero them so p/uv/n are benign for any
    # consumer that forgets to gate on si.valid (advisor r3).
    hit = tri >= 0
    b0 = jnp.where(hit, b0, 0.0)
    b1 = jnp.where(hit, b1, 0.0)
    b2 = jnp.where(hit, b2, 0.0)
    return build_triangle_interaction(
        tris.attr_rows, tris.has_normals, ray_o, ray_d,
        t, tri, b0, b1, b2, p0, p1, p2, attr=attr,
    )


def build_triangle_interaction(
    attr_rows, has_normals, ray_o, ray_d, t, tri, b0, b1, b2, p0, p1, p2,
    ns_transform=None, attr=None,
):
    """Interaction construction from a winning triangle
    (triangle.rs:305-504 interaction_from_intersection).  Shared by the
    single-level scene path and the two-level instanced path (which
    passes world-space verts + an object->world normal transform).
    attr: optional pre-gathered (N, 32) attr rows (skips the gather)."""
    valid = tri >= 0
    tri_c = jnp.maximum(tri, 0)
    t = jnp.where(valid, t, jnp.inf)
    p_hit = b0[..., None] * p0 + b1[..., None] * p1 + b2[..., None] * p2

    dp02 = p0 - p2
    dp12 = p1 - p2
    ng = cross(dp02, dp12)
    degenerate = length_squared(ng) < 1e-24
    n_geom = normalize(
        jnp.where(degenerate[..., None], jnp.array([0.0, 0.0, 1.0]), ng)
    )

    # Shading attributes: ONE packed row per hit.
    if attr is None:
        attr = attr_rows[tri_c]              # (N, 32)
    uv0 = attr[..., _A_UV + 0 : _A_UV + 2]
    uv1 = attr[..., _A_UV + 2 : _A_UV + 4]
    uv2 = attr[..., _A_UV + 4 : _A_UV + 6]
    uv_hit = b0[..., None] * uv0 + b1[..., None] * uv1 + b2[..., None] * uv2

    # dpdu/dpdv from UV deltas (triangle.rs:376-416).
    duv02 = uv0 - uv2
    duv12 = uv1 - uv2
    det_uv = difference_of_products(
        duv02[..., 0], duv12[..., 1], duv02[..., 1], duv12[..., 0]
    )
    uv_ok = jnp.abs(det_uv) >= 1e-9
    inv_det = 1.0 / jnp.where(uv_ok, det_uv, 1.0)
    dpdu = (
        duv12[..., 1:2] * dp02 - duv02[..., 1:2] * dp12
    ) * inv_det[..., None]
    dpdv = (
        -duv12[..., 0:1] * dp02 + duv02[..., 0:1] * dp12
    ) * inv_det[..., None]
    # Degenerate UV mapping: any frame around the geometric normal.
    from shimmer_tpu.ops.vecmath import coordinate_system

    fx, fy = coordinate_system(n_geom)
    bad_uv = ~uv_ok | (length_squared(cross(dpdu, dpdv)) < 1e-24)
    dpdu = jnp.where(bad_uv[..., None], fx, dpdu)
    dpdv = jnp.where(bad_uv[..., None], fy, dpdv)

    rev = attr[..., _A_REV] > 0.5
    n_geom = jnp.where(rev[..., None], -n_geom, n_geom)

    # Shading normals (triangle.rs:418-504).
    if has_normals:
        ns0 = attr[..., _A_NS + 0 : _A_NS + 3]
        ns1 = attr[..., _A_NS + 3 : _A_NS + 6]
        ns2 = attr[..., _A_NS + 6 : _A_NS + 9]
        ns = b0[..., None] * ns0 + b1[..., None] * ns1 + b2[..., None] * ns2
        if ns_transform is not None:
            ns = ns_transform(ns)
        has_ns = length_squared(ns) > 1e-12
        ns = jnp.where(has_ns[..., None], normalize(ns), n_geom)
        ns = jnp.where(rev[..., None], jnp.where(has_ns[..., None], -ns, ns), ns)
        # Orient geometric normal to the shading hemisphere
        # (pbrt: ng = FaceForward(ng, ns) when shading normals exist).
        n_geom = jnp.where(
            (has_ns & (dot(n_geom, ns) < 0.0))[..., None], -n_geom, n_geom
        )
        dpdus = dpdu
    else:
        ns = n_geom
        dpdus = dpdu

    material_id = attr[..., _A_MAT].astype(jnp.int32)
    area_light_id = attr[..., _A_ALI].astype(jnp.int32)
    return SurfaceInteraction.make(
        valid=valid,
        t=jnp.where(valid, t, jnp.inf),
        p=p_hit,
        n=n_geom,
        uv=uv_hit,
        wo=-normalize(ray_d),
        dpdu=dpdu,
        dpdv=dpdv,
        ns=ns,
        dpdus=dpdus,
        material_id=jnp.where(valid, material_id, -1),
        area_light_id=jnp.where(valid, area_light_id, -1),
        med_in=jnp.where(valid, attr[..., _A_MI].astype(jnp.int32), -2),
        med_out=jnp.where(valid, attr[..., _A_MO].astype(jnp.int32), -2),
    )


def triangle_scene_occluded(tris: TriangleSceneData, ray_o, ray_d, t_max):
    """Any-hit shadow query (aggregate.rs:141-203 intersect_predicate).
    Visibility is discrete — evaluated on detached rays."""
    _, tri = _traverse_raw(
        tris,
        jax.lax.stop_gradient(ray_o),
        jax.lax.stop_gradient(ray_d),
        jax.lax.stop_gradient(t_max),
        any_hit=True,
    )
    return tri >= 0


# --- area-light sampling over original triangle ids (triangle.rs:548-745) ---


def _orig_tri_verts(tris: TriangleSceneData, tri_idx):
    """Vertices of original-order triangle ``tri_idx`` — ONE packed-row
    gather (the light_rows table) instead of index + 3 vertex gathers."""
    row = tris.light_rows[tri_idx]
    return row[..., 0:3], row[..., 3:6], row[..., 6:9]


def triangle_light_sample(tris: TriangleSceneData, tri_idx, ref_p, ref_ns, u):
    """Solid-angle sampling of triangle ``tri_idx`` from ref_p
    (Triangle::sample_with_context).  Returns (p, n, pdf_solid_angle).

    Uses uniform spherical-triangle sampling between the reference's
    area thresholds (the bilinear cos-θ warp of triangle.rs:585-650 is a
    variance optimization we skip; sample & pdf stay consistent)."""
    p0, p1, p2 = _orig_tri_verts(tris, tri_idx)
    solid_angle = spherical_triangle_area(
        normalize(p0 - ref_p), normalize(p1 - ref_p), normalize(p2 - ref_p)
    )
    use_area = (solid_angle < MIN_SPHERICAL_SAMPLE_AREA) | (
        solid_angle > MAX_SPHERICAL_SAMPLE_AREA
    )

    ng = cross(p1 - p0, p2 - p0)
    rev = tris.light_rows[tri_idx][..., 9] > 0.5
    n_unnorm = jnp.where(rev[..., None], -ng, ng)

    # Area sampling path.
    bary_a = sample_uniform_triangle(u)
    p_a = (
        bary_a[..., 0:1] * p0 + bary_a[..., 1:2] * p1 + bary_a[..., 2:3] * p2
    )
    area = 0.5 * length(ng)
    wi_a = p_a - ref_p
    dist2_a = jnp.sum(wi_a * wi_a, -1)
    n_norm = normalize(n_unnorm)
    cos_a = jnp.abs(dot(n_norm, -normalize(wi_a)))
    pdf_a = jnp.where(
        (cos_a > 1e-9) & (dist2_a > 0.0),
        dist2_a / (jnp.maximum(cos_a, 1e-9) * jnp.maximum(area, 1e-12)),
        0.0,
    )

    # Spherical-triangle path.
    bary_s, pdf_s = sample_spherical_triangle(p0, p1, p2, ref_p, u)
    p_s = (
        bary_s[..., 0:1] * p0 + bary_s[..., 1:2] * p1 + bary_s[..., 2:3] * p2
    )

    p_out = jnp.where(use_area[..., None], p_a, p_s)
    pdf = jnp.where(use_area, pdf_a, pdf_s)
    return p_out, n_norm, pdf


def triangle_light_pdf(tris: TriangleSceneData, tri_idx, ref_p, ref_ns, wi, si_p, si_n):
    """pdf_with_context for MIS (triangle.rs:676-745)."""
    p0, p1, p2 = _orig_tri_verts(tris, tri_idx)
    solid_angle = spherical_triangle_area(
        normalize(p0 - ref_p), normalize(p1 - ref_p), normalize(p2 - ref_p)
    )
    use_area = (solid_angle < MIN_SPHERICAL_SAMPLE_AREA) | (
        solid_angle > MAX_SPHERICAL_SAMPLE_AREA
    )
    ng = cross(p1 - p0, p2 - p0)
    area = 0.5 * length(ng)
    dist2 = distance_squared(ref_p, si_p)
    cos_s = jnp.abs(dot(normalize(ng), -normalize(si_p - ref_p)))
    pdf_a = jnp.where(
        cos_s > 1e-9,
        dist2 / (jnp.maximum(cos_s, 1e-9) * jnp.maximum(area, 1e-12)),
        0.0,
    )
    pdf_s = jnp.where(solid_angle > 0.0, 1.0 / jnp.maximum(solid_angle, 1e-12), 0.0)
    return jnp.where(use_area, pdf_a, pdf_s)
