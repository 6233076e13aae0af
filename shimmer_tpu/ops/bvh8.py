"""8-wide BVH ("BVH8") build + packed-row layout for traversal.

Wide redesign of the reference's binary BVH traversal
(/root/reference/src/aggregate.rs:71-139).  Every node visit is one
dependent row fetch, so the design goal is the minimum number of
sequential steps per ray, which an 8-wide tree with 8-triangle leaf rows
achieves: ~log8 levels, one 512-byte row per visit resolving either 8
child boxes or 8 inline triangles.

Layout (one (128,) f32 row per node, two kinds):

* **internal row**: cols 0:48 = the 8 child AABBs laid out SoA-in-row
  ``[lox*8 | loy*8 | loz*8 | hix*8 | hiy*8 | hiz*8]``; col 48 =
  ``child_base``; col 80 = 0; cols 88:96 = per-slot valid flags (1.0 for
  occupied slots — empty slots hold zero boxes and MUST be masked by the
  flag, so the table holds no inf/NaN).  A node's children occupy
  *contiguous* rows ``child_base + j`` for slot j — this is what makes the
  traversal's bitmask state work without re-gathering the parent.
* **leaf row**: cols 0:72 = up to 8 inline triangles SoA-in-row
  ``[p0x*8 | p0y*8 | p0z*8 | p1x*8 | ... | p2z*8]``; cols 72:80 = the 8
  BVH-sorted triangle ids; col 80 = triangle count in 1..8.

All indices/counts are stored as exact small floats (< 2^24): no bit
casts, so NaN canonicalization or denormal flushing cannot corrupt
topology (advisor finding r1).

Traversal (shapes/triangle.py::_traverse, ops/traverse_gpu.py) carries one
int32 "group" per lane — ``child_base * 256 + pending_hit_mask`` — plus a
short explicit stack of groups.  Each step pops the lowest pending bit,
gathers that one row, and either slab-tests 8 children (internal) or
intersects 8 triangles (leaf).

Build: binary hierarchy (native binned SAH, or ops/bvh.py's LBVH, Karras
2012) collapsed 8-wide by repeatedly expanding the child with the largest
triangle range — standard BVH2→BVH8 collapse.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from shimmer_tpu.ops.bvh import binary_hierarchy

W8 = 128          # row width (f32)
MAX_LEAF8 = 8     # max triangles per leaf row
_COL_BASE = 48    # internal: child_base
_COL_COUNT = 80   # both: leaf count (0 => internal)
_COL_IDS = 72     # leaf: 8 BVH-sorted triangle ids
_COL_VALID = 88   # internal: 8 slot-valid flags
MAX_GROUP_BASE = (1 << 23) - 1  # group packs base*256+mask into int32


@dataclasses.dataclass
class BVH8Arrays:
    rows: np.ndarray       # (R, 128) f32 packed node/leaf rows
    perm: np.ndarray       # (T,) int32 Morton-sorted triangle order
    n_rows: int
    max_depth: int         # max stack depth needed by the traversal


def _collapse8(h, leaf_size=MAX_LEAF8):
    """Collapse the binary hierarchy into 8-wide nodes.

    Returns (children, kinds) where children[i] is the slot list of
    wide-node i: each slot is ("node", wide_child_id) or
    ("leaf", first_tri, count).  Wide node 0 is the root.  Also returns
    the per-wide-node tri-range bounds for box lookup.
    """
    node_l, node_r = h["node_l"], h["node_r"]
    left, right = h["left"], h["right"]
    is_leaf = h["is_leaf"]

    def range_count(b):
        return node_r[b] - node_l[b] + 1

    wide_children = []   # list of slot lists
    wide_binary = []     # binary node id backing each wide node
    work = [0]           # binary ids pending wide-node creation
    wide_of_binary = {0: 0}
    wide_children.append(None)
    wide_binary.append(0)

    while work:
        b = work.pop()
        wid = wide_of_binary[b]
        # Expand up to 8 slots: repeatedly split the largest internal.
        slots = [b]
        while len(slots) < 8:
            best, best_n = -1, leaf_size
            for i, s in enumerate(slots):
                if not is_leaf[s]:
                    n = range_count(s)
                    if n > best_n:
                        best, best_n = i, n
            if best < 0:
                break
            s = slots.pop(best)
            slots.insert(best, left[s])
            slots.insert(best + 1, right[s])
        out = []
        for s in slots:
            if is_leaf[s] or range_count(s) <= leaf_size:
                out.append(("leaf", int(node_l[s]), int(range_count(s)), s))
            else:
                cid = len(wide_children)
                wide_children.append(None)
                wide_binary.append(s)
                wide_of_binary[s] = cid
                work.append(s)
                out.append(("node", cid, 0, s))
        wide_children[wid] = out
    return wide_children, wide_binary


def build_bvh8(lo: np.ndarray, hi: np.ndarray, builder: str = "auto") -> BVH8Arrays:
    """Build the wide-node structure over per-triangle AABBs.

    builder: "auto" (binned-SAH C++ when available, LBVH fallback),
    "sah", or "lbvh".  Triangle payloads are packed later (pack_bvh8
    needs sorted verts).
    """
    h = None
    if builder in ("auto", "sah"):
        from shimmer_tpu.native import build_sah_hierarchy

        h = build_sah_hierarchy(lo, hi, leaf_size=MAX_LEAF8)
        if h is None and builder == "sah":
            raise RuntimeError("native SAH builder unavailable")
    if h is None:
        h = binary_hierarchy(lo, hi, MAX_LEAF8)
    children, wide_binary = _collapse8(h)
    return _layout8(h, children, wide_binary)


def _layout8(h, children, wide_binary):
    blo, bhi = h["lo"], h["hi"]
    n_wide = len(children)

    # Row allocation: root row 0; then BFS, each wide node's child rows
    # (internal-node rows and leaf rows interleaved by slot) contiguous.
    row_of_wide = np.full(n_wide, -1, np.int64)
    row_of_wide[0] = 0
    next_row = 1
    depth_of = np.zeros(n_wide, np.int64)
    order = [0]
    qi = 0
    leaf_rows = []   # (row, first, count)
    child_base = np.zeros(n_wide, np.int64)
    while qi < len(order):
        wid = order[qi]
        qi += 1
        slots = children[wid]
        child_base[wid] = next_row
        for kind, a, cnt, s in slots:
            r = next_row
            next_row += 1
            if kind == "node":
                row_of_wide[a] = r
                depth_of[a] = depth_of[wid] + 1
                order.append(a)
            else:
                leaf_rows.append((r, a, cnt, s))
    n_rows = next_row
    assert n_rows <= MAX_GROUP_BASE, "scene too large for packed int32 groups"

    # All rows finite (zeros): empty internal slots are zero boxes gated
    # by the valid flag.
    rows = np.zeros((n_rows, W8), np.float32)

    # Internal rows: child boxes + base + slot-valid flags.
    for wid in order:
        r = row_of_wide[wid]
        slots = children[wid]
        rows[r, _COL_BASE] = float(child_base[wid])
        rows[r, _COL_COUNT] = 0.0
        for j, (kind, a, cnt, s) in enumerate(slots):
            l3 = blo[s]
            h3 = bhi[s]
            rows[r, 0 + j] = l3[0]
            rows[r, 8 + j] = l3[1]
            rows[r, 16 + j] = l3[2]
            rows[r, 24 + j] = h3[0]
            rows[r, 32 + j] = h3[1]
            rows[r, 40 + j] = h3[2]
            rows[r, _COL_VALID + j] = 1.0
    return BVH8Arrays(
        rows=rows,
        perm=h["order"],
        n_rows=n_rows,
        max_depth=int(depth_of.max()) + 2,
    ), leaf_rows


def pack_bvh8(lo, hi, tri_p, builder: str = "auto") -> BVH8Arrays:
    """Full build: hierarchy + collapse + pack triangle leaf rows.

    tri_p: (T, 3, 3) triangle vertices in ORIGINAL order; leaf rows store
    them in BVH (perm) order, ids are perm-order indices.
    """
    arrs, leaf_rows = build_bvh8(lo, hi, builder=builder)
    rows, perm = arrs.rows, arrs.perm
    tri_sorted = np.asarray(tri_p, np.float32)[perm]  # (T, 3, 3)
    t_total = tri_sorted.shape[0]
    assert t_total < (1 << 24), "triangle ids must stay exact in f32"
    if leaf_rows:
        lr = np.asarray([(r, f, c) for (r, f, c, _s) in leaf_rows], np.int64)
        r_ids, firsts, counts = lr[:, 0], lr[:, 1], lr[:, 2]
        rows[r_ids, _COL_COUNT] = counts.astype(np.float32)
        for k in range(MAX_LEAF8):
            m = counts > k
            if not m.any():
                break
            tri = firsts[m] + k
            v = tri_sorted[tri]  # (M, 3, 3)
            rr = r_ids[m]
            for vi in range(3):
                for ci in range(3):
                    rows[rr, (vi * 3 + ci) * 8 + k] = v[:, vi, ci]
            rows[rr, _COL_IDS + k] = tri.astype(np.float32)
        # Duplicate slot-0 triangles into unused slots so masked lanes
        # compute on real (finite) data; count gates their hits.
        for k in range(1, MAX_LEAF8):
            m = counts <= k
            if not m.any():
                continue
            rr = r_ids[m]
            for c in range(9):
                rows[rr, c * 8 + k] = rows[rr, c * 8]
    return BVH8Arrays(
        rows=rows, perm=perm, n_rows=arrs.n_rows, max_depth=arrs.max_depth,
    )


def bvh8_validate(arrs: BVH8Arrays, lo, hi) -> bool:
    """Host sanity check: every triangle appears exactly once in a leaf
    row, inside that leaf's box as seen from its parent slot."""
    rows = arrs.rows
    t = len(arrs.perm)
    seen = np.zeros(t, np.int32)
    for r in range(arrs.n_rows):
        cnt = int(rows[r, _COL_COUNT])
        if cnt > 0:
            for k in range(cnt):
                tri = int(rows[r, _COL_IDS + k])
                seen[arrs.perm[tri]] += 1
    return bool(np.all(seen == 1))
