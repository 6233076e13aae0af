"""BVH construction (host) for stackless device traversal.

TPU-native replacement for /root/reference/src/aggregate.rs.  The reference
builds a pointer tree recursively (Middle/EqualCounts splits,
aggregate.rs:304-419) and flattens it for an iterative *stack* traversal
(depth-64 stack, :71-139).  A per-lane stack is hostile to a vector
machine, and lock-step SIMD traversal pays for the worst lane, so tree
*quality* matters more than on a CPU.  The design:

* **Build**: LBVH with Karras-2012 radix splits over 60-bit Morton keys —
  every internal node splits its primitive range at the highest differing
  Morton bit (a spatial-median cut); subtrees with ≤ leaf_size primitives
  collapse into leaves.  The build (RMQ split search via a sparse table,
  level-synchronous hierarchy emission, bottom-up subtree counts, preorder
  layout, range-union bounds) is fully vectorized numpy: no Python
  recursion, O(T log T).
* **Layout**: nodes in *preorder* with a ``skip`` link (threaded BVH):
  traversal state is one int per lane — ``next = hit ? node+1 : skip`` —
  uniform control flow across lanes.
* **Fat packing** (``pack_fat_bvh``): every traversal step is one
  dependent row gather, so each step should fetch one 512-byte row that
  resolves as much work as possible.  Internal rows carry BOTH child
  boxes (so only nodes whose box hit are ever visited); leaf rows carry
  up to 8 triangles inline (vertices + ids), making leaf processing
  gather-free.  Integer fields are stored as exact small floats
  (|v| < 2^24) — no bit-casting, so NaN canonicalization or denormal
  flushing in any data path cannot corrupt topology.

The C++ builder (shimmer_tpu.native.sah) provides binned-SAH quality for
the same BVHArrays layout; this module's LBVH is the pure-numpy fallback.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class BVHArrays:
    """Flattened threaded BVH (numpy, host)."""

    node_lo: np.ndarray      # (B, 3) AABB min
    node_hi: np.ndarray      # (B, 3) AABB max
    leaf_first: np.ndarray   # (B,) int32: first sorted-tri index, -1 internal
    leaf_count: np.ndarray   # (B,) int32: triangles in leaf (0 internal)
    skip: np.ndarray         # (B,) int32: next preorder node if missed; B = end
    perm: np.ndarray         # (T,) int32: sorted tri order
    leaf_size: int           # max leaf occupancy actually produced
    n_nodes: int


def morton_encode_3d(q: np.ndarray) -> np.ndarray:
    """Interleave 20-bit x/y/z quantized coords into 60-bit Morton codes."""

    def spread(v):
        v = v.astype(np.uint64)
        v = (v | (v << np.uint64(32))) & np.uint64(0x1F00000000FFFF)
        v = (v | (v << np.uint64(16))) & np.uint64(0x1F0000FF0000FF)
        v = (v | (v << np.uint64(8))) & np.uint64(0x100F00F00F00F00F)
        v = (v | (v << np.uint64(4))) & np.uint64(0x10C30C30C30C30C3)
        v = (v | (v << np.uint64(2))) & np.uint64(0x1249249249249249)
        return v

    return (
        (spread(q[:, 2]) << np.uint64(2))
        | (spread(q[:, 1]) << np.uint64(1))
        | spread(q[:, 0])
    )


def _common_prefix_lengths(keys: np.ndarray) -> np.ndarray:
    """cpl[i] = number of leading common bits of keys[i], keys[i+1]
    (with index tie-break for equal keys, Karras §4)."""
    n = len(keys)
    x = keys[:-1] ^ keys[1:]
    cpl = np.full(n - 1, 64, np.int64)
    for b in range(63, -1, -1):
        has = ((x >> np.uint64(b)) & np.uint64(1)) == 1
        first = has & (cpl == 64)
        cpl[first] = 63 - b
    eq = x == 0
    if eq.any():
        idx = np.arange(n - 1, dtype=np.uint64)
        tie = idx ^ (idx + np.uint64(1))
        tcp = np.full(n - 1, 64, np.int64)
        for b in range(63, -1, -1):
            has = ((tie >> np.uint64(b)) & np.uint64(1)) == 1
            first = has & (tcp == 64)
            tcp[first] = 63 - b
        cpl = np.where(eq, 64 + tcp, cpl)
    return cpl


class _ArgminSparseTable:
    """Vectorized range-argmin over a fixed array (ties → leftmost)."""

    def __init__(self, values: np.ndarray):
        self.values = values
        n = len(values)
        self.tables = [np.arange(n, dtype=np.int64)]
        j = 1
        while (1 << j) <= n:
            h = 1 << (j - 1)
            prev = self.tables[-1]
            a = prev[: n - (1 << j) + 1]
            b = prev[h : h + n - (1 << j) + 1]
            take_a = values[a] <= values[b]
            self.tables.append(np.where(take_a, a, b))
            j += 1

    def query(self, l: np.ndarray, r: np.ndarray) -> np.ndarray:
        """argmin over [l, r] inclusive, vectorized; requires l <= r."""
        length = r - l + 1
        j = np.zeros_like(length)
        jl = np.floor(np.log2(length)).astype(np.int64)
        res = np.empty(len(l), np.int64)
        for jv in np.unique(jl):
            m = jl == jv
            t = self.tables[jv]
            a = t[l[m]]
            b = t[r[m] - (1 << jv) + 1]
            res[m] = np.where(self.values[a] <= self.values[b], a, b)
        return res


class _RangeUnion:
    """Vectorized AABB union over leaf ranges via overlapping power-of-two
    segments (min/max are idempotent, so overlap is harmless)."""

    def __init__(self, lo: np.ndarray, hi: np.ndarray):
        self.lo_t = [lo]
        self.hi_t = [hi]
        n = len(lo)
        j = 1
        while (1 << j) <= n:
            h = 1 << (j - 1)
            pl, ph = self.lo_t[-1], self.hi_t[-1]
            self.lo_t.append(np.minimum(pl[: len(pl) - h], pl[h:]))
            self.hi_t.append(np.maximum(ph[: len(ph) - h], ph[h:]))
            j += 1

    def query(self, l: np.ndarray, r: np.ndarray):
        length = r - l + 1
        jl = np.floor(np.log2(length)).astype(np.int64)
        lo = np.empty((len(l), 3), np.float32)
        hi = np.empty((len(l), 3), np.float32)
        for jv in np.unique(jl):
            m = jl == jv
            a = l[m]
            b = r[m] + 1 - (1 << jv)
            lo[m] = np.minimum(self.lo_t[jv][a], self.lo_t[jv][b])
            hi[m] = np.maximum(self.hi_t[jv][a], self.hi_t[jv][b])
        return lo, hi


def binary_hierarchy(lo: np.ndarray, hi: np.ndarray, leaf_size: int = 4):
    """Build the binary LBVH hierarchy (Karras radix splits) over
    per-primitive AABBs.  Returns a dict of flat arrays describing the
    *tree* (not yet laid out for traversal):

    ``order`` (T,) Morton sort permutation; ``node_l``/``node_r`` (B,)
    primitive ranges (in sorted order, inclusive); ``left``/``right`` (B,)
    child ids (-1 for leaves); ``is_leaf`` (B,); ``lo``/``hi`` (B, 3)
    bounds.  Node 0 is the root.  Used by both the threaded BVH2 layout
    (build_bvh) and the 8-wide collapse (ops/bvh8.py).
    """
    lo = np.asarray(lo, np.float32)
    hi = np.asarray(hi, np.float32)
    t = lo.shape[0]
    assert t > 0
    centroids = 0.5 * (lo + hi)
    cmin = centroids.min(axis=0)
    cext = np.maximum(centroids.max(axis=0) - cmin, 1e-12)
    q = np.clip(
        (centroids - cmin) / cext * float((1 << 20) - 1), 0, (1 << 20) - 1
    ).astype(np.uint64)
    order = np.argsort(morton_encode_3d(q), kind="stable").astype(np.int32)
    codes = morton_encode_3d(q)[order]

    tri_lo = lo[order]
    tri_hi = hi[order]

    if t <= leaf_size:
        return {
            "order": order,
            "node_l": np.array([0], np.int64),
            "node_r": np.array([t - 1], np.int64),
            "left": np.array([-1], np.int64),
            "right": np.array([-1], np.int64),
            "is_leaf": np.array([True]),
            "lo": tri_lo.min(0, keepdims=True),
            "hi": tri_hi.max(0, keepdims=True),
        }

    cpl = _common_prefix_lengths(codes)
    rmq = _ArgminSparseTable(cpl)
    union = _RangeUnion(tri_lo, tri_hi)

    # --- pass 1: level-synchronous top-down discovery ---
    # node records: l, r (triangle range), parent id, is_left flag
    nl = [np.array([0], np.int64)]
    nr = [np.array([t - 1], np.int64)]
    nparent = [np.array([-1], np.int64)]
    nleft = [np.array([True])]
    level_offsets = [0]
    total = 1
    cur_l, cur_r = nl[0], nr[0]
    cur_ids = np.array([0], np.int64)
    while True:
        internal = (cur_r - cur_l + 1) > leaf_size
        if not internal.any():
            break
        l_, r_ = cur_l[internal], cur_r[internal]
        pid = cur_ids[internal]
        split = rmq.query(l_, r_ - 1)  # left = [l, split], right = [split+1, r]
        child_l = np.concatenate([l_, split + 1])
        child_r = np.concatenate([split, r_])
        child_parent = np.concatenate([pid, pid])
        child_left = np.concatenate(
            [np.ones(len(l_), bool), np.zeros(len(l_), bool)]
        )
        ids = total + np.arange(len(child_l), dtype=np.int64)
        nl.append(child_l)
        nr.append(child_r)
        nparent.append(child_parent)
        nleft.append(child_left)
        level_offsets.append(total)
        total += len(child_l)
        cur_l, cur_r, cur_ids = child_l, child_r, ids

    node_l = np.concatenate(nl)
    node_r = np.concatenate(nr)
    parent = np.concatenate(nparent)
    is_left = np.concatenate(nleft)
    n_nodes = total
    is_leaf = (node_r - node_l + 1) <= leaf_size

    # children pointers (scatter from parent arrays)
    left_child = np.full(n_nodes, -1, np.int64)
    right_child = np.full(n_nodes, -1, np.int64)
    ids_all = np.arange(n_nodes, dtype=np.int64)
    has_parent = parent >= 0
    lmask = has_parent & is_left
    rmask = has_parent & ~is_left
    left_child[parent[lmask]] = ids_all[lmask]
    right_child[parent[rmask]] = ids_all[rmask]

    blo, bhi = union.query(node_l, node_r)
    return {
        "order": order,
        "node_l": node_l,
        "node_r": node_r,
        "left": np.where(is_leaf, -1, left_child),
        "right": np.where(is_leaf, -1, right_child),
        "is_leaf": is_leaf,
        "lo": blo,
        "hi": bhi,
        "_level_offsets": level_offsets,
        "_levels": len(nl),
    }


def build_bvh(lo: np.ndarray, hi: np.ndarray, leaf_size: int = 4) -> BVHArrays:
    """Build a threaded LBVH over per-primitive AABBs.

    Returns preorder node arrays; primitive payloads must be gathered
    through ``perm``.
    """
    h = binary_hierarchy(lo, hi, leaf_size)
    order = h["order"]
    node_l, node_r = h["node_l"], h["node_r"]
    left_child, right_child = h["left"], h["right"]
    is_leaf = h["is_leaf"]
    n_nodes = len(node_l)
    t = len(order)

    if n_nodes == 1:
        return BVHArrays(
            node_lo=h["lo"],
            node_hi=h["hi"],
            leaf_first=np.array([0], np.int32),
            leaf_count=np.array([t], np.int32),
            skip=np.array([1], np.int32),
            perm=order,
            leaf_size=t,
            n_nodes=1,
        )
    level_offsets = h["_level_offsets"]
    n_levels = h["_levels"]
    parent = np.full(n_nodes, -1, np.int64)
    ids_all = np.arange(n_nodes, dtype=np.int64)
    parent[left_child[left_child >= 0]] = ids_all[left_child >= 0]
    parent[right_child[right_child >= 0]] = ids_all[right_child >= 0]

    # --- pass 2: subtree node counts, bottom-up by level ---
    counts = np.ones(n_nodes, np.int64)
    for lev in range(n_levels - 1, 0, -1):
        start = level_offsets[lev]
        end = level_offsets[lev + 1] if lev + 1 < len(level_offsets) else n_nodes
        ids = np.arange(start, end, dtype=np.int64)
        np.add.at(counts, parent[ids], counts[ids])

    # --- pass 3: preorder + skip, top-down by level ---
    pre = np.zeros(n_nodes, np.int64)
    skp = np.zeros(n_nodes, np.int64)
    pre[0] = 0
    skp[0] = n_nodes
    for lev in range(0, n_levels - 1):
        start = level_offsets[lev]
        end = level_offsets[lev + 1] if lev + 1 < len(level_offsets) else n_nodes
        ids = np.arange(start, end, dtype=np.int64)
        ids = ids[~is_leaf[ids]]
        if len(ids) == 0:
            continue
        lc = left_child[ids]
        rc = right_child[ids]
        pre[lc] = pre[ids] + 1
        pre[rc] = pre[ids] + 1 + counts[lc]
        skp[lc] = pre[rc]
        skp[rc] = skp[ids]

    # --- bounds + scatter into preorder layout ---
    blo, bhi = h["lo"], h["hi"]
    node_lo_arr = np.empty((n_nodes, 3), np.float32)
    node_hi_arr = np.empty((n_nodes, 3), np.float32)
    node_lo_arr[pre] = blo
    node_hi_arr[pre] = bhi
    leaf_first = np.full(n_nodes, -1, np.int32)
    leaf_count = np.zeros(n_nodes, np.int32)
    leaf_first[pre[is_leaf]] = node_l[is_leaf].astype(np.int32)
    leaf_count[pre[is_leaf]] = (
        node_r[is_leaf] - node_l[is_leaf] + 1
    ).astype(np.int32)
    skip = np.empty(n_nodes, np.int32)
    skip[pre] = skp.astype(np.int32)

    return BVHArrays(
        node_lo=node_lo_arr,
        node_hi=node_hi_arr,
        leaf_first=leaf_first,
        leaf_count=leaf_count,
        skip=skip,
        perm=order,
        leaf_size=int(leaf_count.max()),
        n_nodes=n_nodes,
    )


# Fat-row column layout (one (128,) f32 row per node):
#   internal:  0:6 left-child box (lo,hi) | 6:12 right-child box
#              | 12 right-child idx | 13 skip | 14 leaf count (=0)
#   leaf:      13 skip | 14 count k in 1..8
#              | 16+9j : 25+9j  triangle j vertices p0,p1,p2 (9 f32)
#              | 88+j            triangle j id (BVH-sorted order)
# All indices/counts stored as exact small floats.
FAT_W = 128
FAT_MAX_LEAF = 8
_FAT_RIGHT = 12
_FAT_SKIP = 13
_FAT_COUNT = 14
_FAT_TRI0 = 16
_FAT_IDS = 88


def pack_fat_bvh(bvh: BVHArrays, tri_p_sorted: np.ndarray) -> np.ndarray:
    """Pack a threaded BVHArrays + BVH-sorted triangle vertices (T, 3, 3)
    into the fat (B, 128) f32 node table described above.

    Children are recovered from the preorder layout: left = i + 1,
    right = skip(left).  Leaves must have ≤ FAT_MAX_LEAF triangles.
    """
    n = bvh.n_nodes
    assert n < (1 << 24) and tri_p_sorted.shape[0] < (1 << 24), (
        "fat BVH float-encoded indices need |v| < 2^24"
    )
    assert bvh.leaf_size <= FAT_MAX_LEAF, (
        f"fat leaves hold at most {FAT_MAX_LEAF} tris, got {bvh.leaf_size}"
    )
    rows = np.zeros((n, FAT_W), np.float32)
    is_leaf = bvh.leaf_first >= 0
    ids = np.arange(n, dtype=np.int64)

    # Internal rows: child boxes + right/skip links.
    internal = ids[~is_leaf]
    if len(internal):
        left = internal + 1
        right = bvh.skip[left].astype(np.int64)
        rows[internal, 0:3] = bvh.node_lo[left]
        rows[internal, 3:6] = bvh.node_hi[left]
        rows[internal, 6:9] = bvh.node_lo[right]
        rows[internal, 9:12] = bvh.node_hi[right]
        rows[internal, _FAT_RIGHT] = right.astype(np.float32)
    rows[:, _FAT_SKIP] = bvh.skip.astype(np.float32)

    # Leaf rows: inline triangles.
    leaves = ids[is_leaf]
    if len(leaves):
        rows[leaves, _FAT_COUNT] = bvh.leaf_count[leaves].astype(np.float32)
        first = bvh.leaf_first[leaves].astype(np.int64)
        count = bvh.leaf_count[leaves].astype(np.int64)
        t_total = tri_p_sorted.shape[0]
        for k in range(FAT_MAX_LEAF):
            m = count > k
            if not m.any():
                break
            tri = first[m] + k
            assert tri.max() < t_total
            rows[leaves[m], _FAT_TRI0 + 9 * k : _FAT_TRI0 + 9 * (k + 1)] = (
                tri_p_sorted[tri].reshape(-1, 9)
            )
            rows[leaves[m], _FAT_IDS + k] = tri.astype(np.float32)
    return rows


def bvh_validate(bvh: BVHArrays, lo: np.ndarray, hi: np.ndarray) -> bool:
    """Host sanity check: primitives inside their leaf boxes, every
    primitive in exactly one leaf."""
    seen = np.zeros(lo.shape[0], np.int32)
    ok = True
    for pre in np.nonzero(bvh.leaf_first >= 0)[0]:
        first = int(bvh.leaf_first[pre])
        count = int(bvh.leaf_count[pre])
        for k in range(count):
            tri = int(bvh.perm[first + k])
            seen[tri] += 1
            ok &= bool(np.all(lo[tri] >= bvh.node_lo[pre] - 1e-4))
            ok &= bool(np.all(hi[tri] <= bvh.node_hi[pre] + 1e-4))
    ok &= bool(np.all(seen == 1))
    return ok
