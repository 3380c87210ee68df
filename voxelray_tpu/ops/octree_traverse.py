"""Stackless octree ray traversal.

The reference never traverses its octree on the GPU (it flattens leaves to
AABBs and lets the driver's TLAS do the work, octTree.hpp:502-510 +
hello_vulkan.cpp:690-697 commented path).  Here the octree is traversed
directly — the capability its encoding exists for:

  repeat (bounded):
    descend from the root to the deepest node containing the current
    point (child links via gather); an empty octant (INVALID child,
    octTree.hpp:271) yields its box as free space
    if the region is an occupied leaf: slab-test its <= max_items Morton
    items (decoded with the reference float math) and accept the nearest
    if none accepted (or region empty): advance the ray to the region's
    exit plane and continue

No stack, no recursion (the reference build needs a 512 MiB stack for its
recursion, octTree.hpp:130-134; traversal here is O(depth) per step with
pure iteration).  Descent uses the Morton bit structure: the octant of a
cell at level L is bit-sliced from its (x, y, z), exactly the digit order
buildNodeRecursive splits on (octTree.hpp:337-345).

This is the semantic/capability path; the production-speed path is the
brick accel (ops/traverse_fast.py), which is the same idea fixed at
three bitmask levels.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .compact import compact_mask
from .intersect import TMAX, TMIN

__all__ = ["trace_octree", "any_hit_octree"]


@functools.partial(
    jax.jit,
    static_argnames=("bits", "dims", "voxel_size", "origin_key",
                     "max_items", "max_outer"),
)
def _trace_octree_impl(o, d, children, node_start, node_count, item_x,
                       item_y, item_z, t_min, t_max, *, bits, dims,
                       voxel_size, origin_key, max_items, max_outer):
    nx, ny, nz = dims
    vs = jnp.float32(voxel_size)
    half = jnp.float32(0.5) * vs
    og = jnp.asarray(origin_key, jnp.float32)
    n = o.shape[0]
    side = 1 << bits  # conceptual grid cells per axis (octTree.hpp:592)

    grid_max = og + jnp.float32(side) * vs
    inv = 1.0 / d
    tbot = inv * (og - o)
    ttop = inv * (grid_max - o)
    tn_ = jnp.minimum(tbot, ttop)
    tf_ = jnp.maximum(tbot, ttop)
    t_enter = jnp.maximum(jnp.maximum(tn_[:, 0], tn_[:, 1]), tn_[:, 2])
    t_exit = jnp.minimum(jnp.minimum(tf_[:, 0], tf_[:, 1]), tf_[:, 2])
    t_cur = jnp.maximum(t_enter, 0.0) + 1e-6
    alive = (t_exit > jnp.maximum(t_enter, 0.0)) & (t_cur <= t_max)

    def cell_slab_t(cx, cy, cz):
        """Reference slab t0 of the cell AABB (raytrace.rint:46-56)."""
        ccx = og[0] + (cx.astype(jnp.float32) + 0.5) * vs
        ccy = og[1] + (cy.astype(jnp.float32) + 0.5) * vs
        ccz = og[2] + (cz.astype(jnp.float32) + 0.5) * vs
        t0 = jnp.full(cx.shape, -jnp.inf, jnp.float32)
        t1 = jnp.full(cx.shape, jnp.inf, jnp.float32)
        for cc, oo, ii in ((ccx, o[:, 0:1], inv[:, 0:1]),
                           (ccy, o[:, 1:2], inv[:, 1:2]),
                           (ccz, o[:, 2:3], inv[:, 2:3])):
            tb = ii * ((cc - half) - oo)
            tt = ii * ((cc + half) - oo)
            t0 = jnp.maximum(t0, jnp.minimum(tb, tt))
            t1 = jnp.minimum(t1, jnp.maximum(tb, tt))
        return t0, t1

    def outer_body(state):
        t_cur, alive, best_t, best_lin, it = state
        p = o + d * t_cur[:, None]
        cell = jnp.floor((p - og) / vs).astype(jnp.int32)
        cell = jnp.clip(cell, 0, side - 1)
        cx, cy, cz = cell[:, 0], cell[:, 1], cell[:, 2]

        # descend: find deepest node containing the cell; record the
        # level at which we stopped (empty octant or leaf)
        def descend(level, carry):
            node, stop_level, is_leaf = carry
            shift = bits - 1 - level
            octant = (((cx >> shift) & 1)
                      | (((cy >> shift) & 1) << 1)
                      | (((cz >> shift) & 1) << 2))
            child = children[jnp.maximum(node, 0), octant]
            descending = (stop_level < 0)
            # empty octant -> free region: the octant is one level BELOW
            # the node we were at (depth level+1)
            hit_empty = descending & (child < 0)
            stop_level = jnp.where(hit_empty, level + 1, stop_level)
            node = jnp.where(descending & (child >= 0), child, node)
            # if the new node is a leaf (no children at all), stop below it
            leaf = node_leaf[jnp.maximum(node, 0)]
            hit_leaf = descending & (child >= 0) & leaf
            stop_level = jnp.where(hit_leaf, level + 1, stop_level)
            is_leaf = is_leaf | hit_leaf
            return node, stop_level, is_leaf

        node0 = jnp.zeros(n, jnp.int32)
        stop0 = jnp.full(n, -1, jnp.int32)
        # root with no children at all (tiny trees): it is itself a leaf
        root_leaf = node_leaf[0]
        stop0 = jnp.where(root_leaf, 0, stop0)
        leaf0 = jnp.broadcast_to(root_leaf, (n,))
        node, stop_level, is_leaf = jax.lax.fori_loop(
            0, bits, descend, (node0, stop0, leaf0))
        stop_level = jnp.where(stop_level < 0, bits, stop_level)

        # region box: the octant cube at stop_level containing the cell
        # (cells per side at that level = side >> stop_level)
        region_cells = (side >> jnp.minimum(stop_level, bits)).astype(
            jnp.int32)
        region_cells = jnp.maximum(region_cells, 1)
        rx = (cx // region_cells) * region_cells
        ry = (cy // region_cells) * region_cells
        rz = (cz // region_cells) * region_cells
        rminx = og[0] + rx.astype(jnp.float32) * vs
        rminy = og[1] + ry.astype(jnp.float32) * vs
        rminz = og[2] + rz.astype(jnp.float32) * vs
        ext = region_cells.astype(jnp.float32) * vs
        tx = jnp.where(d[:, 0] != 0,
                       jnp.maximum((rminx - o[:, 0]) * inv[:, 0],
                                   (rminx + ext - o[:, 0]) * inv[:, 0]),
                       jnp.inf)
        ty = jnp.where(d[:, 1] != 0,
                       jnp.maximum((rminy - o[:, 1]) * inv[:, 1],
                                   (rminy + ext - o[:, 1]) * inv[:, 1]),
                       jnp.inf)
        tz = jnp.where(d[:, 2] != 0,
                       jnp.maximum((rminz - o[:, 2]) * inv[:, 2],
                                   (rminz + ext - o[:, 2]) * inv[:, 2]),
                       jnp.inf)
        t_region_exit = jnp.minimum(tx, jnp.minimum(ty, tz))

        # occupied leaf: test its items
        start = node_start[jnp.maximum(node, 0)]
        count = node_count[jnp.maximum(node, 0)]
        ks = jnp.arange(max_items, dtype=jnp.int32)
        idx = jnp.clip(start[:, None] + ks[None, :], 0,
                       item_x.shape[0] - 1)
        vx = item_x[idx]
        vy = item_y[idx]
        vz = item_z[idx]
        t0, t1 = cell_slab_t(vx, vy, vz)
        valid = (ks[None, :] < count[:, None]) & is_leaf[:, None] \
            & alive[:, None]
        accept = valid & (t1 > jnp.maximum(t0, 0.0)) & (t0 > 0.0) \
            & (t0 >= t_min) & (t0 <= t_max[:, None])
        t0m = jnp.where(accept, t0, jnp.inf)
        arg = jnp.argmin(t0m, axis=1)
        tb = jnp.take_along_axis(t0m, arg[:, None], axis=1)[:, 0]
        lx = jnp.take_along_axis(vx, arg[:, None], axis=1)[:, 0]
        ly = jnp.take_along_axis(vy, arg[:, None], axis=1)[:, 0]
        lz = jnp.take_along_axis(vz, arg[:, None], axis=1)[:, 0]
        got = jnp.isfinite(tb) & alive
        best_t = jnp.where(got, tb, best_t)
        best_lin = jnp.where(
            got, lx.astype(jnp.int32) + nx * (ly.astype(jnp.int32)
                                              + ny * lz.astype(jnp.int32)),
            best_lin)

        # advance past the region
        t_cur = jnp.maximum(t_region_exit, t_cur) + 1e-6
        alive = alive & ~got & (t_cur < t_exit) & (t_cur <= t_max)
        return t_cur, alive, best_t, best_lin, it + 1

    def outer_cond(state):
        _, alive, _, _, it = state
        return jnp.logical_and(it < max_outer, jnp.any(alive))

    node_leaf = (children < 0).all(axis=1)
    init = (t_cur, alive, jnp.full(n, jnp.inf, jnp.float32),
            jnp.full(n, -1, jnp.int32), jnp.int32(0))
    _, _, best_t, best_lin, _ = jax.lax.while_loop(outer_cond, outer_body,
                                                   init)
    return best_t, best_lin


@functools.partial(
    jax.jit,
    static_argnames=("bits", "map_bits", "dims", "voxel_size",
                     "origin_key", "max_items", "rounds", "steps",
                     "drain_frac", "max_outer"),
)
def _trace_octree_flat_impl(o, d, region_map, children, node_start,
                            node_count, items4, t_min,
                            t_max, *, bits, map_bits, dims, voxel_size,
                            origin_key, max_items, rounds, steps,
                            drain_frac, max_outer):
    """Flattened-descent octree walk (the performance path).

    Same region sequence and accept rules as _trace_octree_impl, but the
    bits-deep child-link descent is replaced by ONE gather into the
    per-cell region map (models/octree.py build_region_map), and the
    traversal runs as STATIC unrolled rounds — `steps` free-space skips
    then one leaf item test per round — instead of gathers inside a
    while_loop body.
    When the map is COARSE (map_bits < bits, e.g. 512^3 grids past the
    dense-map budget), INTERNAL map entries resume the child-link
    descent for the residual bits - map_bits levels — a short static
    chase, not a full-depth one.  Stragglers drain through a compacted
    two-level while loop: zero iterations when the static rounds
    already resolved every ray.
    """
    nx, ny_, _nz = dims
    vs = jnp.float32(voxel_size)
    half = jnp.float32(0.5) * vs
    og = jnp.asarray(origin_key, jnp.float32)
    n = o.shape[0]
    side = 1 << bits
    dshift = bits - map_bits
    side_m = 1 << map_bits
    leaf_flag = jnp.int32(1 << 30)
    internal_flag = jnp.int32(1 << 29)
    node_sc = jnp.stack([node_start, node_count], axis=1)  # (M, 2) rows
    node_leaf = (children < 0).all(axis=1) if dshift else None

    grid_max = og + jnp.float32(side) * vs
    inv = 1.0 / d
    tbot = inv * (og - o)
    ttop = inv * (grid_max - o)
    tn_ = jnp.minimum(tbot, ttop)
    tf_ = jnp.maximum(tbot, ttop)
    t_enter = jnp.maximum(jnp.maximum(tn_[:, 0], tn_[:, 1]), tn_[:, 2])
    t_exit = jnp.minimum(jnp.minimum(tf_[:, 0], tf_[:, 1]), tf_[:, 2])
    t_cur0 = jnp.maximum(t_enter, 0.0) + 1e-6
    alive0 = (t_exit > jnp.maximum(t_enter, 0.0)) & (t_cur0 <= t_max)

    def cell_slab_t(vx, vy, vz, oo, ii):
        """Reference slab t0/t1 of item cells (raytrace.rint:46-56)."""
        t0 = jnp.full(vx.shape, -jnp.inf, jnp.float32)
        t1 = jnp.full(vx.shape, jnp.inf, jnp.float32)
        for cc, ax in ((vx, 0), (vy, 1), (vz, 2)):
            c = og[ax] + (cc.astype(jnp.float32) + 0.5) * vs
            tb = ii[:, ax:ax + 1] * ((c - half) - oo[:, ax:ax + 1])
            tt = ii[:, ax:ax + 1] * ((c + half) - oo[:, ax:ax + 1])
            t0 = jnp.maximum(t0, jnp.minimum(tb, tt))
            t1 = jnp.minimum(t1, jnp.maximum(tb, tt))
        return t0, t1

    def skip_step(oo, dd, ii, t_ex, tmx, t_cur, alive, holding, hold_node,
                  hold_texit):
        """One region lookup: hold on a leaf, advance past free space."""
        p = oo + dd * t_cur[:, None]
        cell = jnp.clip(jnp.floor((p - og) / vs).astype(jnp.int32), 0,
                        side - 1)
        cx, cy, cz = cell[:, 0], cell[:, 1], cell[:, 2]
        lin = ((cx >> dshift) + side_m * ((cy >> dshift)
                                          + side_m * (cz >> dshift)))
        act = alive & ~holding
        val = region_map[jnp.where(act, lin, 0)]
        is_leaf = (val & leaf_flag) != 0
        lg = val & 31
        node = (val >> 5) & ((1 << 25) - 1)
        if dshift:
            # COARSE map: an INTERNAL entry stops the map at depth
            # map_bits with deeper structure below — resume the
            # child-link descent (same digit order as
            # _trace_octree_impl's descend) for the residual levels
            is_int = act & ~is_leaf & ((val & internal_flag) != 0)
            node_i = jnp.where(is_int, (val >> 5) & ((1 << 24) - 1), 0)
            desc = is_int
            found_leaf = jnp.zeros_like(is_int)
            lg_i = jnp.zeros(cx.shape, jnp.int32)
            for level in range(map_bits, bits):
                shift = bits - 1 - level
                octant = (((cx >> shift) & 1)
                          | (((cy >> shift) & 1) << 1)
                          | (((cz >> shift) & 1) << 2))
                child = children[jnp.where(desc, node_i, 0), octant]
                hit_empty = desc & (child < 0)
                lg_i = jnp.where(hit_empty, bits - (level + 1), lg_i)
                moved = desc & (child >= 0)
                node_i = jnp.where(moved, child, node_i)
                hit_leaf = moved & node_leaf[jnp.maximum(node_i, 0)]
                lg_i = jnp.where(hit_leaf, bits - (level + 1), lg_i)
                found_leaf = found_leaf | hit_leaf
                desc = moved & ~hit_leaf
            # depth == bits nodes are leaves by construction
            # (build splits only while depth < max_depth); defensive
            found_leaf = found_leaf | desc
            lg_i = jnp.where(desc, 0, lg_i)
            is_leaf = is_leaf | (is_int & found_leaf)
            lg = jnp.where(is_int, lg_i, lg)
            node = jnp.where(is_int, node_i, node)
        # region cube exit (the octant at the stopping level)
        rx = ((cx >> lg) << lg).astype(jnp.float32)
        ry = ((cy >> lg) << lg).astype(jnp.float32)
        rz = ((cz >> lg) << lg).astype(jnp.float32)
        ext = jnp.exp2(lg.astype(jnp.float32)) * vs
        tx = jnp.where(dd[:, 0] != 0,
                       jnp.maximum((og[0] + rx * vs - oo[:, 0]) * ii[:, 0],
                                   (og[0] + rx * vs + ext - oo[:, 0])
                                   * ii[:, 0]), jnp.inf)
        ty = jnp.where(dd[:, 1] != 0,
                       jnp.maximum((og[1] + ry * vs - oo[:, 1]) * ii[:, 1],
                                   (og[1] + ry * vs + ext - oo[:, 1])
                                   * ii[:, 1]), jnp.inf)
        tz = jnp.where(dd[:, 2] != 0,
                       jnp.maximum((og[2] + rz * vs - oo[:, 2]) * ii[:, 2],
                                   (og[2] + rz * vs + ext - oo[:, 2])
                                   * ii[:, 2]), jnp.inf)
        t_rex = jnp.minimum(tx, jnp.minimum(ty, tz))

        take = act & is_leaf
        hold_node = jnp.where(take, node, hold_node)
        hold_texit = jnp.where(take, t_rex, hold_texit)
        holding = holding | take
        advance = act & ~is_leaf
        t_cur = jnp.where(advance,
                          jnp.maximum(t_rex, t_cur) + 1e-6, t_cur)
        alive = alive & (holding
                         | (~advance) | ((t_cur < t_ex) & (t_cur <= tmx)))
        return t_cur, alive, holding, hold_node, hold_texit

    def item_phase(oo, dd, ii, t_ex, tmn, tmx, sel_for_write, t_cur,
                   alive, holding, hold_node, hold_texit, best_t,
                   best_lin):
        """Test the held leaf's items; advance non-accepting rays."""
        sc = node_sc[jnp.where(holding, hold_node, 0)]
        start, count = sc[:, 0], sc[:, 1]
        st = jnp.clip(start, 0, items4.shape[0] - max_items)
        rows = jax.vmap(
            lambda s: jax.lax.dynamic_slice(items4, (s, 0),
                                            (max_items, 4)))(st)
        vx = rows[..., 0]
        vy = rows[..., 1]
        vz = rows[..., 2]
        t0, t1 = cell_slab_t(vx, vy, vz, oo, ii)
        ks = jnp.arange(max_items, dtype=jnp.int32)
        valid = (ks[None, :] < count[:, None]) & holding[:, None] \
            & alive[:, None]
        accept = valid & (t1 > jnp.maximum(t0, 0.0)) & (t0 > 0.0) \
            & (t0 >= tmn) & (t0 <= tmx[:, None])
        t0m = jnp.where(accept, t0, jnp.inf)
        arg = jnp.argmin(t0m, axis=1)
        tb = jnp.take_along_axis(t0m, arg[:, None], axis=1)[:, 0]
        lx = jnp.take_along_axis(vx, arg[:, None], axis=1)[:, 0]
        ly = jnp.take_along_axis(vy, arg[:, None], axis=1)[:, 0]
        lz = jnp.take_along_axis(vz, arg[:, None], axis=1)[:, 0]
        got = jnp.isfinite(tb) & holding & alive
        lin_hit = lx + nx * (ly + ny_ * lz)
        if sel_for_write is None:
            best_t = jnp.where(got, tb, best_t)
            best_lin = jnp.where(got, lin_hit, best_lin)
        else:
            idx = jnp.where(got, sel_for_write, best_t.shape[0])
            best_t = best_t.at[idx].set(tb, mode="drop")
            best_lin = best_lin.at[idx].set(lin_hit, mode="drop")
        # rays whose leaf had no accepted item march past its region
        adv = holding & ~got
        t_cur = jnp.where(adv, jnp.maximum(hold_texit, t_cur) + 1e-6,
                          t_cur)
        alive = alive & ~got \
            & jnp.where(adv, (t_cur < t_ex) & (t_cur <= tmx), True)
        holding = jnp.zeros_like(holding)
        return t_cur, alive, holding, best_t, best_lin

    best_t = jnp.full(n, jnp.inf, jnp.float32)
    best_lin = jnp.full(n, -1, jnp.int32)
    holding = jnp.zeros(n, bool)
    hold_node = jnp.zeros(n, jnp.int32)
    hold_texit = jnp.zeros(n, jnp.float32)
    t_cur, alive = t_cur0, alive0
    tmx_b = t_max
    for _ in range(rounds):
        for _ in range(steps):
            t_cur, alive, holding, hold_node, hold_texit = skip_step(
                o, d, inv, t_exit, tmx_b, t_cur, alive, holding,
                hold_node, hold_texit)
        t_cur, alive, holding, best_t, best_lin = item_phase(
            o, d, inv, t_exit, t_min, tmx_b, None, t_cur, alive, holding,
            hold_node, hold_texit, best_t, best_lin)

    # ---- compacted straggler drain --------------------------------------
    cap_d = min(max(8192, -(-n // drain_frac) // 1024 * 1024 + 1024), n)
    outer_cap = -(-n // cap_d) + 1

    def outer_cond(st):
        return jnp.logical_and(jnp.any(st[0]), st[3] < outer_cap)

    def outer_body(st):
        alive_f, t_cur_f, (best_t, best_lin), outer = st
        sel, live, sel_c, _ = compact_mask(alive_f, cap_d, n)
        oo = o[sel_c]
        dd = d[sel_c]
        ii = inv[sel_c]
        t_ex = t_exit[sel_c]
        tmx = t_max[sel_c]
        tmn = t_min

        def drain_cond(dst):
            return jnp.logical_and(jnp.any(dst[1]), dst[5] < max_outer)

        def drain_body(dst):
            dt_cur, dalive, dholding, dhn, dht, it, bt_bl = dst
            bt, bl = bt_bl
            dt_cur, dalive, dholding, dhn, dht = skip_step(
                oo, dd, ii, t_ex, tmx, dt_cur, dalive, dholding, dhn,
                dht)
            dt_cur, dalive, dholding, bt, bl = item_phase(
                oo, dd, ii, t_ex, tmn, tmx, sel, dt_cur, dalive,
                dholding, dhn, dht, bt, bl)
            return (dt_cur, dalive, dholding, dhn, dht, it + 1, (bt, bl))

        init = (t_cur_f[sel_c], live & alive_f[sel_c],
                jnp.zeros(cap_d, bool), jnp.zeros(cap_d, jnp.int32),
                jnp.zeros(cap_d, jnp.float32), jnp.int32(0),
                (best_t, best_lin))
        _, dalive, _, _, _, _, (best_t, best_lin) = jax.lax.while_loop(
            drain_cond, drain_body, init)
        alive_f = alive_f.at[sel].set(dalive, mode="drop")
        return (alive_f, t_cur_f, (best_t, best_lin), outer + 1)

    alive, _, (best_t, best_lin), _ = jax.lax.while_loop(
        outer_cond, outer_body,
        (alive, t_cur, (best_t, best_lin), jnp.int32(0)))
    return best_t, best_lin


def trace_octree(origins, dirs, tree, t_min=TMIN, t_max=TMAX,
                 max_outer=512):
    """Nearest voxel hit via octree walk: (t, cell_lin), -1/inf on miss.

    tree: models.octree.Octree.  Hit cells are reported as linear indices
    in the tree's voxel dims (x + nx*(y + ny*z)) like the grid backends.
    Trees carrying the flattened-descent region map trace through the
    static-round flat path (a coarse map + residual child chase past
    2^8 cells/axis); trees without one fall back to the while-loop
    child-link descent.
    """
    batch_shape = origins.shape[:-1]
    o = origins.reshape(-1, 3).astype(jnp.float32)
    d = dirs.reshape(-1, 3).astype(jnp.float32)
    t_max_b = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32),
                               batch_shape).reshape(-1)
    if tree.n_items == 0 or tree.bits_per_axis == 0:
        return (jnp.full(batch_shape, jnp.inf, jnp.float32),
                jnp.full(batch_shape, -1, jnp.int32))

    if tree.region_map is not None and tree.items4 is not None:
        t, lin = _trace_octree_flat_impl(
            o, d, tree.region_map, tree.children, tree.node_start,
            tree.node_count, tree.items4, jnp.float32(t_min), t_max_b,
            bits=tree.bits_per_axis,
            map_bits=(tree.map_bits or tree.bits_per_axis),
            dims=tree.dims,
            voxel_size=tree.voxel_size, origin_key=tree.origin_key,
            max_items=int(tree.max_items), rounds=4, steps=4,
            drain_frac=64, max_outer=max_outer)
        return t.reshape(batch_shape), lin.reshape(batch_shape)

    t, lin = _trace_octree_impl(
        o, d, tree.children, tree.node_start, tree.node_count,
        tree.item_x, tree.item_y, tree.item_z,
        jnp.float32(t_min), t_max_b,
        bits=tree.bits_per_axis, dims=tree.dims,
        voxel_size=tree.voxel_size,
        origin_key=tree.origin_key,
        max_items=int(tree.max_items), max_outer=max_outer)
    return t.reshape(batch_shape), lin.reshape(batch_shape)


def any_hit_octree(origins, dirs, tree, t_min=TMIN, t_max=TMAX):
    t, _ = trace_octree(origins, dirs, tree, t_min=t_min, t_max=t_max)
    return jnp.isfinite(t)
