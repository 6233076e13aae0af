"""BVH8 traversal kernel for NVIDIA GPUs (Pallas, Triton route).

One program traverses a block of ``BLOCK`` rays.  Its ``while_loop`` runs
while any of its own rays is still active, so a block stops when its own
slowest ray is done (not the slowest ray of the whole dispatch), and
blocks whose rays are all dead (t_max <= 0 lanes of the wavefront's
merged trace) leave after the first predicate.  The whole traversal state
-- current group, its entry distance, the stack pointer, the best hit and
the two (BLOCK, D) stacks -- lives in registers; the only device-memory
traffic per step is one node-row gather per ray from ``rows8`` (the table
stays resident in L2 at production sizes).

The arithmetic is that of ``shapes/triangle.py::_traverse(raw=True)``:
the same slab test, the same watertight triangle test
(``intersect_triangle_xyz``), the same ordered descent and the same
per-lane any-hit flag, so the hit decision can be compared lane by lane.
Floating-point contraction (FMA) may differ between Triton's and XLA's
code, so near-edge hits and exact ties may flip.

Contract (``traverse_gpu_raw``): ``(t, tri)`` with ``tri = -1`` and
``t = +inf`` on a miss -- the contract of ``_traverse_raw``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from shimmer_tpu.ops.bvh8 import MAX_LEAF8
from shimmer_tpu.ops.intersect import intersect_triangle_xyz, popcount8

# Rays per program and warps per program.  Registers are the scarce
# resource: the two (BLOCK, D) stacks and the (BLOCK, 8) tile temporaries
# must fit without spilling.  Chosen on an H100 (700 W): raw traversal
# over BLOCK in {32, 64, 128} x num_warps in {1, 2, 4}, then the
# production frame end to end over the best four (PERF.md).
BLOCK = 32
NUM_WARPS = 4

# Ray table rows (SoA, one column per ray).
_OX, _OY, _OZ, _DX, _DY, _DZ, _TMAX, _ANY = range(8)


def _stack_depth(tris) -> int:
    """Stack slots: stack_depth + 2 (as in _traverse), padded to a power
    of two because Triton tensors need power-of-two shapes."""
    need = tris.stack_depth + 2
    return max(8, 1 << (need - 1).bit_length())


def _kernel(rays_ref, rows_ref, t_ref, tri_ref, *, depth):
    ox = rays_ref[_OX, :]
    oy = rays_ref[_OY, :]
    oz = rays_ref[_OZ, :]
    dx = rays_ref[_DX, :]
    dy = rays_ref[_DY, :]
    dz = rays_ref[_DZ, :]
    t_max = rays_ref[_TMAX, :]
    want_any = rays_ref[_ANY, :] > 0.0
    b = ox.shape[0]
    ix = 1.0 / jnp.where(dx == 0.0, 1e-30, dx)
    iy = 1.0 / jnp.where(dy == 0.0, 1e-30, dy)
    iz = 1.0 / jnp.where(dz == 0.0, 1e-30, dz)
    lane8 = jax.lax.broadcasted_iota(jnp.int32, (b, MAX_LEAF8), 1)
    stack_iota = jax.lax.broadcasted_iota(jnp.int32, (b, depth), 1)
    bit_pow = jnp.left_shift(1, lane8)
    o3 = (ox[:, None], oy[:, None], oz[:, None])
    d3 = (dx[:, None], dy[:, None], dz[:, None])

    def lane_active(group, sp, tri_best):
        alive = ((group & 255) > 0) | (sp > 0)
        return alive & ~(want_any & (tri_best >= 0))

    def cols(row_idx, c):
        return rows_ref[row_idx, pl.ds(c, MAX_LEAF8)]

    def cond(state):
        group, _, sp, _, _, _, tri_best = state
        live = lane_active(group, sp, tri_best).astype(jnp.int32)
        return jnp.max(live) > 0

    def step(state):
        group, group_t, sp, stack, stack_t, t_best, tri_best = state
        active = lane_active(group, sp, tri_best)

        # Pop when the current group has no pending bits; prune popped
        # groups whose entry distance can no longer win.
        need_pop = active & ((group & 255) == 0)
        sp_p = sp - need_pop.astype(jnp.int32)
        sel = stack_iota == sp_p[:, None]
        popped = jnp.sum(jnp.where(sel, stack, 0), axis=1)
        popped_t = jnp.sum(jnp.where(sel, stack_t, 0.0), axis=1)
        pruned = need_pop & (popped_t >= t_best)
        group = jnp.where(need_pop, jnp.where(pruned, 0, popped), group)
        group_t = jnp.where(need_pop, popped_t, group_t)
        sp = sp_p
        active = active & ~pruned

        # Lowest pending bit -> row index; one row gather per ray.
        mask = group & 255
        t_low = mask & -mask
        row_idx = (group >> 8) + popcount8(t_low - 1)
        group_rem = group - t_low
        row_idx = jnp.where(active, row_idx, 0)
        count = rows_ref[row_idx, 80].astype(jnp.int32)
        is_leaf = active & (count > 0)
        is_int = active & (count == 0)
        c0, c1, c2 = cols(row_idx, 0), cols(row_idx, 8), cols(row_idx, 16)
        c3, c4, c5 = cols(row_idx, 24), cols(row_idx, 32), cols(row_idx, 40)
        c6, c7, c8 = cols(row_idx, 48), cols(row_idx, 56), cols(row_idx, 64)
        ids = cols(row_idx, 72)
        valid = cols(row_idx, 88)

        # Internal: slab-test the 8 child boxes.
        t0x = (c0 - o3[0]) * ix[:, None]
        t1x = (c3 - o3[0]) * ix[:, None]
        t0y = (c1 - o3[1]) * iy[:, None]
        t1y = (c4 - o3[1]) * iy[:, None]
        t0z = (c2 - o3[2]) * iz[:, None]
        t1z = (c5 - o3[2]) * iz[:, None]
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
            & (valid > 0.0)
            & is_int[:, None]
        )
        hmask = jnp.sum(jnp.where(hit8, bit_pow, 0), axis=1)
        child_base = rows_ref[row_idx, 48].astype(jnp.int32)
        tn = jnp.where(hit8, jnp.maximum(t_near, 0.0), jnp.inf)
        k_near = jnp.argmin(tn, axis=1).astype(jnp.int32)
        near_t = jnp.min(tn, axis=1)
        child_rem = hmask & ~jnp.left_shift(1, k_near)
        tn2 = jnp.where(lane8 == k_near[:, None], jnp.inf, tn)
        child_rem_t = jnp.min(tn2, axis=1)
        child_group = ((child_base + k_near) << 8) | 1

        # Leaf: intersect the 8 inline triangles.
        h, t = intersect_triangle_xyz(
            o3, d3, t_best[:, None], (c0, c1, c2), (c3, c4, c5), (c6, c7, c8)
        )[:2]
        in_leaf = is_leaf[:, None] & (lane8 < count[:, None])
        t = jnp.where(h & in_leaf, t, jnp.inf)
        k_best = jnp.argmin(t, axis=1).astype(jnp.int32)
        t_new = jnp.min(t, axis=1)
        closer = t_new < t_best
        tri_new = jnp.sum(
            jnp.where(lane8 == k_best[:, None], ids, 0.0), axis=1
        ).astype(jnp.int32)
        t_best = jnp.where(closer, t_new, t_best)
        tri_best = jnp.where(closer, tri_new, tri_best)

        # Descend into the nearest hit child; push the group's sibling
        # remainder and the hit-children remainder.
        descend = is_int & (hmask > 0)
        push1 = descend & ((group_rem & 255) > 0)
        push2 = descend & (child_rem > 0)
        pos2 = sp + push1.astype(jnp.int32)
        oh1 = (stack_iota == sp[:, None]) & push1[:, None]
        stack = jnp.where(oh1, group_rem[:, None], stack)
        stack_t = jnp.where(oh1, group_t[:, None], stack_t)
        oh2 = (stack_iota == pos2[:, None]) & push2[:, None]
        stack = jnp.where(oh2, ((child_base << 8) | child_rem)[:, None], stack)
        stack_t = jnp.where(oh2, child_rem_t[:, None], stack_t)
        sp = pos2 + push2.astype(jnp.int32)
        group = jnp.where(
            active, jnp.where(descend, child_group, group_rem), group
        )
        group_t = jnp.where(descend, near_t, group_t)
        return (group, group_t, sp, stack, stack_t, t_best, tri_best)

    state = (
        # group: row 0, mask = 1.  Lanes that cannot hit (t_max <= 0, the
        # wavefront's dead lanes) start finished.
        jnp.where(t_max > 0.0, 1, 0).astype(jnp.int32),
        jnp.zeros((b,), jnp.float32),         # group_t
        jnp.zeros((b,), jnp.int32),           # sp
        jnp.zeros((b, depth), jnp.int32),     # stack
        jnp.zeros((b, depth), jnp.float32),   # stack_t
        t_max,
        jnp.full((b,), -1, jnp.int32),
    )
    state = jax.lax.while_loop(cond, step, state)
    t_best, tri_best = state[5], state[6]
    t_ref[...] = jnp.where(tri_best >= 0, t_best, jnp.inf)
    tri_ref[...] = tri_best


@functools.partial(jax.jit, static_argnames=("depth", "interpret"))
def _traverse_call(rows, rays, *, depth, interpret):
    n = rays.shape[1]
    return pl.pallas_call(
        functools.partial(_kernel, depth=depth),
        grid=(n // BLOCK,),
        in_specs=[
            pl.BlockSpec((8, BLOCK), lambda i: (0, i)),
            pl.BlockSpec(rows.shape, lambda i: (0, 0)),
        ],
        out_specs=[
            pl.BlockSpec((BLOCK,), lambda i: (i,)),
            pl.BlockSpec((BLOCK,), lambda i: (i,)),
        ],
        out_shape=[
            jax.ShapeDtypeStruct((n,), jnp.float32),
            jax.ShapeDtypeStruct((n,), jnp.int32),
        ],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS, num_stages=1),
        interpret=interpret,
        name="bvh8_traverse",
    )(rays, rows)


def traverse_gpu_raw(
    tris, ray_o, ray_d, t_max, any_hit=False, *, interpret=False
):
    """Closest-hit / any-hit traversal of ``tris.rows8``.

    ray_o, ray_d: (N, 3); t_max: scalar or (N,); any_hit: bool or (N,)
    per-lane flags.  Returns ``(t, tri)``, t = +inf where tri = -1.
    N need not be a multiple of ``BLOCK``: padded lanes carry
    t_max = -inf and start finished."""
    n = ray_o.shape[0]
    n_pad = -(-n // BLOCK) * BLOCK
    rays = jnp.concatenate(
        [
            jnp.asarray(ray_o, jnp.float32).T,
            jnp.asarray(ray_d, jnp.float32).T,
            jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (n,))[None],
            jnp.broadcast_to(jnp.asarray(any_hit, bool), (n,))[None].astype(
                jnp.float32
            ),
        ],
        axis=0,
    )
    if n_pad != n:
        pad = jnp.zeros((8, n_pad - n), jnp.float32).at[_TMAX].set(-jnp.inf)
        rays = jnp.concatenate([rays, pad], axis=1)
    # Traversal is discrete: nothing differentiates through the kernel,
    # and the node table's tangent (the scene is a differentiated input
    # of the replay VJP) must not reach it.
    t, tri = _traverse_call(
        jax.lax.stop_gradient(tris.rows8), jax.lax.stop_gradient(rays),
        depth=_stack_depth(tris), interpret=interpret,
    )
    return t[:n], tri[:n]
