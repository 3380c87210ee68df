"""Morton-coded octree encoding.

Reference: src/octTree.hpp — occupied voxels become 63-bit Morton codes
(21 bits/axis), sorted, and a flat node array is built by splitting sorted
ranges on the 3-bit octant digit per level.  Exact semantics preserved:

  * bitsPerAxis = ceil(log2(maxDim)) in double math, > 21 raises
    (octTree.hpp:578-585),
  * maxDepth = bitsPerAxis; root bounds inflated to the power-of-two cube
    bb.min + voxelSize * 2^bits (octTree.hpp:592-594),
  * items are one Morton code per (triangle, cell) SAT hit — duplicates
    are kept, sorted, and re-emitted by getAabbs (octTree.hpp:374-392),
  * a node is a leaf when depth >= maxDepth or count <= maxItemsPerLeaf
    (default 16, octTree.hpp:328-331, 489),
  * nodes are numbered in pre-order with children visited 0..7
    (buildNodeRecursive, octTree.hpp:319-358); INVALID child = 0xFFFFFFFF.

Differences: Morton encoding is magic-bits on device (no byte LUT
gathers); the item encode + sort runs ON DEVICE (jax.lax.sort over
(hi, lo) uint32 limb pairs, ops/morton.py:sort_codes_device) whenever a
non-CPU backend is active — non-hit slots are routed to an all-ones
sentinel that sorts last, so the voxelize -> sorted-codes pipeline never
leaves the device; node construction is a *level-order vectorized* sweep
over the sorted code array (one searchsorted batch per level, host side —
O(nodes), cheap) instead of 512-MiB-stack recursion — then renumbered to
the reference's pre-order for parity.  On CPU the native C++ sort/build
is used instead (bit-identical; tests pin all three paths).
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass, field
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.morton import (morton_decode3_np, morton_encode3,
                          morton_encode3_np, sort_codes_device)

__all__ = ["Octree", "build_nodes", "build_region_map", "INVALID_INDEX"]

INVALID_INDEX = np.uint32(0xFFFFFFFF)

# region_map encoding: empty region -> log2(cells per side); occupied
# leaf -> LEAF_FLAG | node_id << 5 | log2 (25-bit node id); mixed map
# cell on a COARSE map (map_bits < bits) -> INTERNAL_FLAG | node_id << 5
# | log2 with a 24-bit node id (bit 29 is the flag) — traversal resumes
# the child-link descent below that node for the remaining
# bits - map_bits levels (ops/octree_traverse.py), so grids past the
# dense-map budget (512^3+) keep the flat fast path:
# one map gather plus at most bits - map_bits chase steps per region.
LEAF_FLAG = np.int32(1 << 30)
INTERNAL_FLAG = np.int32(1 << 29)
REGION_MAP_MAX_BITS = 8      # map is side^3 i32: 64 MiB at 2^8 per axis


def build_region_map(children: np.ndarray, bits: int,
                     map_bits: int | None = None) -> np.ndarray:
    """Flatten the octree's region decomposition to a per-cell lookup.

    For every cell of the conceptual 2^map_bits cube, record the region
    the stackless descent would stop at: the deepest empty octant
    (INVALID child, octTree.hpp:271) or occupied leaf cube containing
    the cell — or, when the tree is deeper than the map (map_bits <
    bits), the INTERNAL node at depth map_bits whose subtree the cell
    falls in.  Regions at depth <= map_bits partition the cube in
    coarse-cell multiples, so the map paints each cell exactly once —
    an O(side_m^3) host sweep done once per tree.  Traversal then needs
    ONE gather per step (plus the short residual chase under INTERNAL
    entries) instead of a bits-deep child-link chase
    (ops/octree_traverse.py flat path).

    children: (M, 8) int with -1 for INVALID, pre-order numbered.
    Returns int32[side_m^3] indexed xm + side_m*(ym + side_m*zm) where
    the m coords are full-res cell coords >> (bits - map_bits).  The
    stored log2 region sizes stay in FULL-resolution cells.
    """
    if map_bits is None:
        map_bits = min(bits, REGION_MAP_MAX_BITS)
    assert 0 <= map_bits <= bits
    dshift = bits - map_bits
    side_m = 1 << map_bits
    ch = np.asarray(children, np.int64)
    m = np.empty((side_m * side_m * side_m,), np.int32)
    if len(ch) == 0:
        m[:] = np.int32(bits)      # wholly empty: one root-sized region
        return m
    is_leaf = (ch < 0).all(axis=1)
    oc = np.arange(8, dtype=np.int64)
    odx, ody, odz = oc & 1, (oc >> 1) & 1, (oc >> 2) & 1

    def paint(bases_x, bases_y, bases_z, rc, vals):
        # bases/rc in FULL-res cells; depth <= map_bits regions are
        # whole multiples of the coarse cell, so the >> is exact
        if len(bases_x) == 0:
            return
        rcm = rc >> dshift
        off = np.arange(rcm, dtype=np.int64)
        x = (bases_x >> dshift)[:, None, None, None] + off[None, None,
                                                           None, :]
        y = (bases_y >> dshift)[:, None, None, None] + off[None, None,
                                                           :, None]
        z = (bases_z >> dshift)[:, None, None, None] + off[None, :,
                                                           None, None]
        lin = (x + side_m * (y + side_m * z)).reshape(len(bases_x), -1)
        m[lin.reshape(-1)] = np.repeat(vals.astype(np.int32), rcm ** 3)

    nodes = np.array([0], np.int64)
    bx = np.array([0], np.int64)
    by = np.array([0], np.int64)
    bz = np.array([0], np.int64)
    for depth in range(map_bits + 1):
        if len(nodes) == 0:
            break
        rc = (1 << bits) >> depth
        lg = bits - depth
        leaf = is_leaf[nodes]
        paint(bx[leaf], by[leaf], bz[leaf], rc,
              LEAF_FLAG | (nodes[leaf].astype(np.int32) << 5)
              | np.int32(lg))
        pn = nodes[~leaf]
        pbx, pby, pbz = bx[~leaf], by[~leaf], bz[~leaf]
        if len(pn) == 0:
            break
        if depth == map_bits:
            # deeper structure than the map resolves: hand traversal the
            # internal node to resume the child-link descent from
            assert pn.max() < (1 << 24), "internal node id exceeds 24 bits"
            paint(pbx, pby, pbz, rc,
                  INTERNAL_FLAG | (pn.astype(np.int32) << 5)
                  | np.int32(lg))
            break
        half = rc >> 1
        sub = ch[pn]                               # (K, 8)
        cbx = (pbx[:, None] + odx[None, :] * half).reshape(-1)
        cby = (pby[:, None] + ody[None, :] * half).reshape(-1)
        cbz = (pbz[:, None] + odz[None, :] * half).reshape(-1)
        flat = sub.reshape(-1)
        empty = flat < 0
        paint(cbx[empty], cby[empty], cbz[empty], half,
              np.full(int(empty.sum()), lg - 1, np.int32))
        nodes = flat[~empty]
        bx, by, bz = cbx[~empty], cby[~empty], cbz[~empty]
    return m


def build_nodes(codes_sorted: np.ndarray, max_depth: int,
                max_items: int) -> np.ndarray:
    """Flat node array from sorted Morton codes (host, vectorized per level).

    Returns int64 array (M, 10): columns 0..7 children (INVALID as
    0xFFFFFFFF), 8 start, 9 count — pre-order numbered like the recursive
    reference build.
    """
    n = len(codes_sorted)
    if n == 0 and max_depth == 0:
        return np.zeros((0, 10), np.int64)

    # level-order construction -------------------------------------------
    # each node: (begin, end, depth); splittable nodes expand per level
    begins = [np.array([0], np.int64)]
    ends = [np.array([n], np.int64)]
    parents = [np.array([-1], np.int64)]   # parent row in previous level
    octants = [np.array([0], np.int64)]    # which child slot of the parent

    codes = codes_sorted.astype(np.uint64)
    level_rows = []  # (begin, end, parent_global_idx, octant)

    cur_b, cur_e = begins[0], ends[0]
    cur_parent = parents[0]
    cur_oct = octants[0]
    all_b, all_e, all_parent, all_oct, all_depth = [], [], [], [], []
    global_offset = 0

    for depth in range(max_depth + 1):
        k = len(cur_b)
        if k == 0:
            break
        all_b.append(cur_b)
        all_e.append(cur_e)
        all_parent.append(cur_parent)
        all_oct.append(cur_oct)
        all_depth.append(np.full(k, depth, np.int64))

        counts = cur_e - cur_b
        split = (depth < max_depth) & (counts > max_items)
        idx_split = np.flatnonzero(split)
        if len(idx_split) == 0 or depth == max_depth:
            cur_b = np.zeros(0, np.int64)
            cur_e = np.zeros(0, np.int64)
            cur_parent = np.zeros(0, np.int64)
            cur_oct = np.zeros(0, np.int64)
            global_offset += k
            continue

        shift = np.uint64(3 * (max_depth - 1 - depth))
        keys = (codes >> shift)  # sorted; low 3 bits = octant at this level
        # prefix of each splitting node (bits above this level)
        pref = (codes[cur_b[idx_split]] >> (shift + np.uint64(3)))
        # child boundaries: searchsorted for prefix*8 + c, c = 0..8
        q = (pref[:, None].astype(np.uint64) << np.uint64(3)) \
            + np.arange(9, dtype=np.uint64)[None, :]
        bounds = np.searchsorted(keys, q)  # (S, 9)
        bounds = np.clip(bounds, cur_b[idx_split][:, None],
                         cur_e[idx_split][:, None])
        cb = bounds[:, :8].reshape(-1)
        ce = bounds[:, 1:].reshape(-1)
        child_oct = np.tile(np.arange(8, dtype=np.int64), len(idx_split))
        child_parent = np.repeat(global_offset + idx_split, 8)
        keep = ce > cb  # only non-empty octants become nodes
        cur_b, cur_e = cb[keep], ce[keep]
        cur_parent, cur_oct = child_parent[keep], child_oct[keep]
        global_offset += k

    b = np.concatenate(all_b)
    e = np.concatenate(all_e)
    parent = np.concatenate(all_parent)
    octant = np.concatenate(all_oct)
    m = len(b)

    # children table in level order
    children = np.full((m, 8), np.int64(INVALID_INDEX))
    child_rows = np.flatnonzero(parent >= 0)
    children[parent[child_rows], octant[child_rows]] = child_rows

    # pre-order renumbering (children visited 0..7), iterative stack ------
    order = np.empty(m, np.int64)  # order[new] = old
    rank = np.empty(m, np.int64)   # rank[old] = new
    stack = [0]
    nxt = 0
    while stack:
        node = stack.pop()
        order[nxt] = node
        rank[node] = nxt
        nxt += 1
        ch = children[node]
        for c in range(7, -1, -1):
            if ch[c] != np.int64(INVALID_INDEX):
                stack.append(ch[c])
    assert nxt == m

    out = np.full((m, 10), np.int64(INVALID_INDEX))
    old_children = children[order]
    valid = old_children != np.int64(INVALID_INDEX)
    out[:, :8] = np.where(valid, rank[np.clip(old_children, 0, m - 1)],
                          np.int64(INVALID_INDEX))
    out[:, 8] = b[order]
    out[:, 9] = (e - b)[order]
    return out


@functools.partial(jax.jit, static_argnames=("nx", "ny"))
def _encode_sort_items(hit, lin, nx, ny):
    """Morton-encode the SAT-hit cells and sort them — all on device.

    hit: (K,) bool, lin: (K,) int32 linear cell ids.  Non-hit slots get
    the (0xFFFFFFFF, 0xFFFFFFFF) sentinel (sorts after every valid 63-bit
    code); the caller slices the first n_items of the result.  Static
    nx/ny keep the integer div/mod lowering cheap (see CLAUDE.md #6).
    """
    x = lin % nx
    y = (lin // nx) % ny
    z = lin // (nx * ny)
    hi, lo = morton_encode3(x, y, z)
    sent = jnp.uint32(0xFFFFFFFF)
    hi = jnp.where(hit, hi, sent)
    lo = jnp.where(hit, lo, sent)
    return sort_codes_device(hi, lo)


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class Octree:
    """Flat Morton octree as device arrays."""

    code_hi: Any                    # uint32[N] sorted code upper limbs
    code_lo: Any                    # uint32[N] lower limbs
    item_x: Any                     # int32[N] decoded cell coords (sorted
    item_y: Any                     # order) — precomputed so traversal
    item_z: Any                     # never decodes under jit
    children: Any                   # int32[M, 8], -1 == INVALID
    node_start: Any                 # int32[M]
    node_count: Any                 # int32[M]
    root_min: Any                   # float32[3] (== mesh bb.min)
    dims: tuple = field(metadata=dict(static=True))
    voxel_size: float = field(metadata=dict(static=True))
    bits_per_axis: int = field(metadata=dict(static=True))
    max_items: int = field(metadata=dict(static=True))
    origin_key: tuple = field(default=(0.0, 0.0, 0.0),
                              metadata=dict(static=True))
    set_calls: int = 0
    region_map: Any = None          # int32[side_m^3] flattened-descent map
                                    # (build_region_map) or None
    items4: Any = None              # int32[>=N, 4] packed (x, y, z, 0)
                                    # item rows for block gathers
    map_bits: int = field(default=0, metadata=dict(static=True))
                                    # region_map granularity (== bits when
                                    # the dense map covers the whole tree;
                                    # < bits => INTERNAL entries resume
                                    # the child-link descent)

    # -- construction ------------------------------------------------------
    @classmethod
    def from_mesh(cls, vertices, faces, voxel_size, max_items_per_leaf=16,
                  bb_min=None, bb_max=None, chunk=2048, sort_device=None):
        from ..ops.geometry import grid_dims, mesh_bbox
        from ..ops.voxelize import required_window_shape, voxelize_dense

        v = np.asarray(vertices, dtype=np.float32).reshape(-1, 3)
        f = np.asarray(faces).reshape(-1, 3)
        if bb_min is None or bb_max is None:
            bb_min, bb_max = mesh_bbox(v)
        bb_min = np.asarray(bb_min, np.float32)
        bb_max = np.asarray(bb_max, np.float32)
        dims = grid_dims(bb_min, bb_max, voxel_size)
        max_dim = max(dims)
        if max_dim == 0 or len(f) == 0:
            return cls(code_hi=jnp.zeros(0, jnp.uint32),
                       code_lo=jnp.zeros(0, jnp.uint32),
                       item_x=jnp.zeros(0, jnp.int32),
                       item_y=jnp.zeros(0, jnp.int32),
                       item_z=jnp.zeros(0, jnp.int32),
                       children=jnp.zeros((0, 8), jnp.int32),
                       node_start=jnp.zeros(0, jnp.int32),
                       node_count=jnp.zeros(0, jnp.int32),
                       root_min=jnp.asarray(bb_min),
                       dims=dims, voxel_size=float(voxel_size),
                       bits_per_axis=0,
                       max_items=int(max_items_per_leaf),
                       origin_key=tuple(float(x) for x in bb_min),
                       set_calls=0)

        # ceil(log2(maxDim)) in double precision (octTree.hpp:578-580)
        bits = int(math.ceil(math.log2(float(max_dim))))
        if bits > 21:
            raise ValueError(
                "We support up to 21 bits per axis "
                "(max 2^21 voxels per dimension)!"
            )
        max_depth = bits

        win = required_window_shape(v, f, bb_min, voxel_size, dims)
        cap = win[0] * win[1] * win[2]
        budget = (1 << 22) if jax.default_backend() != "cpu" else (1 << 14)
        _occ, calls, hit, lin, _rank = voxelize_dense(
            jnp.asarray(v[f]), jnp.asarray(bb_min), dims=dims,
            voxel_size_static=float(voxel_size), window=win,
            chunk=int(min(chunk, max(8, budget // cap))),
            with_hit_mask=True,
        )

        # one item per SAT hit, duplicates preserved (octTree.hpp:769-771)
        nx, ny, _nz = dims
        if sort_device is None:
            sort_device = jax.default_backend() != "cpu"
        if sort_device:
            # device path: encode + lax.sort on device (non-hits routed to
            # the all-ones sentinel, which sorts last); only the sorted
            # prefix [:n_items] crosses to the host for node layout
            hi_s, lo_s = _encode_sort_items(hit.reshape(-1),
                                            lin.reshape(-1), nx, ny)
            n_items = int(calls)
            codes = ((np.asarray(hi_s[:n_items]).astype(np.uint64)
                      << np.uint64(32))
                     | np.asarray(lo_s[:n_items]).astype(np.uint64))
            nodes = build_nodes(codes, max_depth, int(max_items_per_leaf))
        else:
            hit_np = np.asarray(hit).reshape(-1)
            lin_np = np.asarray(lin).reshape(-1)[hit_np].astype(np.int64)
            x = (lin_np % nx).astype(np.uint64)
            y = ((lin_np // nx) % ny).astype(np.uint64)
            z = (lin_np // (nx * ny)).astype(np.uint64)

            # native encode/sort/build when the C++ runtime is present
            # (bit-identical to the numpy path; tests pin both)
            from .. import native as vnative
            if vnative.available():
                codes = vnative.sort_codes_native(
                    vnative.morton_encode_native(
                        x.astype(np.uint32), y.astype(np.uint32),
                        z.astype(np.uint32)))
                nodes = vnative.build_octree_nodes_native(
                    codes, max_depth, int(max_items_per_leaf))
            else:
                codes = np.sort(morton_encode3_np(x, y, z))
                nodes = build_nodes(codes, max_depth,
                                    int(max_items_per_leaf))
        ix, iy, iz = morton_decode3_np(codes)
        # flattened-descent region map + packed item rows (the fast
        # traversal path).  Trees deeper than REGION_MAP_MAX_BITS get a
        # COARSE map (64 MiB budget) whose INTERNAL entries resume the
        # child-link descent for the residual bits - map_bits levels —
        # 512^3+ grids stay on the flat path (the reference supports
        # 21 bits/axis, octTree.hpp:583-585).
        region_map = None
        items4 = None
        map_bits = min(bits, REGION_MAP_MAX_BITS)
        if bits > 0:
            ch_np = np.where(nodes[:, :8] == np.int64(INVALID_INDEX), -1,
                             nodes[:, :8])
            region_map = jnp.asarray(
                build_region_map(ch_np, bits, map_bits))
            it4 = np.zeros((max(len(ix), 1) + int(max_items_per_leaf), 4),
                           np.int32)
            it4[: len(ix), 0] = ix
            it4[: len(ix), 1] = iy
            it4[: len(ix), 2] = iz
            items4 = jnp.asarray(it4)
        return cls(
            code_hi=jnp.asarray((codes >> np.uint64(32)).astype(np.uint32)),
            code_lo=jnp.asarray((codes & np.uint64(0xFFFFFFFF)).astype(np.uint32)),
            item_x=jnp.asarray(ix.astype(np.int32)),
            item_y=jnp.asarray(iy.astype(np.int32)),
            item_z=jnp.asarray(iz.astype(np.int32)),
            children=jnp.asarray(
                np.where(nodes[:, :8] == np.int64(INVALID_INDEX), -1,
                         nodes[:, :8]).astype(np.int32)),
            node_start=jnp.asarray(nodes[:, 8].astype(np.int32)),
            node_count=jnp.asarray(nodes[:, 9].astype(np.int32)),
            root_min=jnp.asarray(bb_min),
            dims=dims, voxel_size=float(voxel_size), bits_per_axis=bits,
            max_items=int(max_items_per_leaf),
            origin_key=tuple(float(x) for x in bb_min),
            set_calls=int(calls),
            region_map=region_map, items4=items4,
            map_bits=map_bits if region_map is not None else 0,
        )

    # -- queries -----------------------------------------------------------
    @property
    def origin(self):
        """Grid origin (== mesh bb.min; alias so Octree can stand in for
        the grid encodings in scene assembly)."""
        return self.root_min

    @property
    def n_items(self):
        return int(self.code_hi.shape[0])

    @property
    def n_nodes(self):
        return int(self.node_start.shape[0])

    @property
    def root_bounds(self):
        """Power-of-two cube [min, min + vs*2^bits] (octTree.hpp:592-594)."""
        mn = np.asarray(self.root_min, np.float32)
        extent = np.float32(self.voxel_size) * np.float32(
            np.uint32(1) << np.uint32(self.bits_per_axis))
        return mn, mn + extent

    def codes_u64(self) -> np.ndarray:
        return (np.asarray(self.code_hi, np.uint64) << np.uint64(32)) \
            | np.asarray(self.code_lo, np.uint64)

    def get_aabbs(self):
        """One AABB per item (duplicates included) in sorted-code order —
        exactly the DFS leaf emission of octTree.hpp:374-392."""
        if self.n_items == 0:
            return jnp.zeros((0, 6), jnp.float32)
        x, y, z = morton_decode3_np(self.codes_u64())
        vs = np.float32(self.voxel_size)
        half = vs * np.float32(0.5)
        mn = np.asarray(self.root_min, np.float32)
        cx = mn[0] + (x.astype(np.float32) + np.float32(0.5)) * vs
        cy = mn[1] + (y.astype(np.float32) + np.float32(0.5)) * vs
        cz = mn[2] + (z.astype(np.float32) + np.float32(0.5)) * vs
        return jnp.asarray(np.stack(
            [cx - half, cy - half, cz - half, cx + half, cy + half,
             cz + half], axis=-1))

    def occupancy(self):
        """Dense (Z, Y, X) uint8 view (for cross-encoding equality tests)."""
        nx, ny, nz = self.dims
        occ = np.zeros((nz * ny * nx,), np.uint8)
        if self.n_items:
            x, y, z = morton_decode3_np(self.codes_u64())
            lin = (x.astype(np.int64) + nx * (y.astype(np.int64)
                                              + ny * z.astype(np.int64)))
            occ[lin] = 1
        return jnp.asarray(occ.reshape(nz, ny, nx))

    def memory_usage_bytes(self):
        # items * sizeof(Item{u64}) + nodes * sizeof(Node{8*u32+2*u32})
        return self.n_items * 8 + self.n_nodes * 40
