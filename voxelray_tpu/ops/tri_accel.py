"""Triangle acceleration structure: uniform tri-grid + brick-walk march.

Replacement for the reference's triangle BLAS (hello_vulkan.cpp:596-635
objectToVkGeometryKHR and the TLAS built PREFER_FAST_TRACE at :755): the
driver's BVH becomes a uniform grid binning triangles into cells, marched
with the same brick-walk kernel the voxel path uses (ops/traverse_fast) —
the tri-grid's nonempty-cell mask is just another BrickAccel.

Design (why a grid and not a BVH): the brick walk already turns "next
nonempty cell along the ray" into a bitmask DDA, and per-cell triangle
lists are fixed-width rows that gather as whole rows.  Build cost is one
voxelize pass (SAT-exact binning, ops/voxelize.py).

Trace = rounds of (find next nonempty cell via trace_grid_fast with a
per-ray advancing t_min) -> (gather the cell's triangle row, Möller-
Trumbore all L lanes, accept only hits inside the cell's t-span so
nearest-ordering survives triangles spanning multiple cells).  Rays
whose cell had no in-span hit advance t_min past the cell exit and
march again.  Rays starting INSIDE a nonempty cell (shadow rays leave
surfaces) get a round-0 origin-cell test, because the grid trace's
accept rule (t0 > 0, raytrace.rint:46-56) never reports the cell the
ray starts in.

Cells with more triangles than the static row width are truncated and
FLAGGED: rays touching them resolve through the brute path outside
(callers read `overflow_cells`; build_tri_accel sizes the row width to
the true max by default so this is 0 unless capped).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from .compact import compact_mask
from .intersect import TMAX, TMIN, hit_triangles
from .pallas.brick_dda import BLOCK
from .traverse_fast import BrickAccel, build_accel, trace_grid_fast

__all__ = ["TriAccel", "build_tri_accel", "trace_triangles_grid",
           "any_hit_triangles_grid"]


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class TriAccel:
    brick: BrickAccel               # walkable mask of nonempty tri-cells
    cell_slot: Any                  # int32[n_cells+1]: lin -> row of
                                    # cell_tris, -1 = empty cell
    cell_tris: Any                  # int32[n_rows, L]: tri ids, -1 = pad
    tri9: Any                       # float32[F+1, 9]: v0|v1|v2 rows
                                    # (row F = degenerate pad triangle)
    origin: Any                     # float32[3]
    dims: tuple = field(metadata=dict(static=True))
    voxel_size: float = field(metadata=dict(static=True))
    l_width: int = field(metadata=dict(static=True))
    overflow_cells: int = field(metadata=dict(static=True))


def build_tri_accel(v0, v1, v2, *, res=64, l_width=None,
                    max_l_width=512) -> TriAccel:
    """Bin triangles (given as three (F, 3) corner streams) into a
    uniform grid whose longest axis has ~`res` cells.

    Build runs the SAT-exact voxelizer per bucket (host orchestration,
    device SAT) and assembles the CSR-style padded rows host-side — this
    is the one-time "BLAS build"; tracing is pure device code.
    """
    from .geometry import grid_dims
    from .voxelize import plan_buckets, voxelize_dense

    v0 = np.asarray(v0, np.float32)
    v1 = np.asarray(v1, np.float32)
    v2 = np.asarray(v2, np.float32)
    f_total = len(v0)
    tri_all = np.stack([v0, v1, v2], axis=1)          # (F, 3, 3)
    bb_min = tri_all.reshape(-1, 3).min(axis=0)
    bb_max = tri_all.reshape(-1, 3).max(axis=0)
    extent = float(max(bb_max - bb_min))
    vs = max(extent, 1e-6) / float(res)
    # pad the box a hair so max-boundary triangles stay inside windows
    bb_min = bb_min - 0.5 * vs
    bb_max = bb_max + 0.5 * vs
    dims = grid_dims(bb_min, bb_max, vs)
    nx, ny, nz = dims
    n_cells = nx * ny * nz

    # (tri, cell) pairs via the SAT voxelizer's hit mask, bucketed so a
    # few large triangles don't inflate every window
    verts_flat = tri_all.reshape(-1, 3)
    faces = np.arange(f_total * 3).reshape(f_total, 3)
    buckets = plan_buckets(verts_flat, faces, bb_min, vs, dims,
                           max_buckets=8)
    pair_tri, pair_lin = [], []
    for win, idx in buckets:
        if len(idx) == 0:
            continue
        cap = win[0] * win[1] * win[2]
        chunk = int(max(8, min(8192, (1 << 21) // cap)))
        _, _, hit, lin, _ = voxelize_dense(
            jnp.asarray(tri_all[idx]), jnp.asarray(bb_min), dims=dims,
            voxel_size_static=float(vs), window=win, chunk=chunk,
            with_hit_mask=True)
        hit = np.asarray(hit)
        lin = np.asarray(lin)
        t_ix, s_ix = np.nonzero(hit)
        pair_tri.append(np.asarray(idx)[t_ix].astype(np.int32))
        pair_lin.append(lin[t_ix, s_ix].astype(np.int32))
    if pair_tri:
        pair_tri = np.concatenate(pair_tri)
        pair_lin = np.concatenate(pair_lin)
    else:
        pair_tri = np.zeros((0,), np.int32)
        pair_lin = np.zeros((0,), np.int32)

    order = np.lexsort((pair_tri, pair_lin))
    lin_s = pair_lin[order]
    tri_s = pair_tri[order]
    counts = np.bincount(lin_s, minlength=n_cells)
    nonempty = np.flatnonzero(counts)
    true_max = int(counts.max()) if len(nonempty) else 1
    if l_width is None:
        l_width = min(true_max, max_l_width)
    l_width = max(1, int(l_width))
    overflow = int((counts > l_width).sum())

    cell_slot = np.full((n_cells + 1,), -1, np.int32)
    cell_slot[nonempty] = np.arange(len(nonempty), dtype=np.int32)
    n_rows = max(1, len(nonempty))
    cell_tris = np.full((n_rows, l_width), -1, np.int32)
    off = np.zeros(n_cells + 1, np.int64)
    np.cumsum(counts, out=off[1:])
    within = np.arange(len(lin_s)) - off[lin_s]
    keep = within < l_width
    cell_tris[cell_slot[lin_s[keep]], within[keep]] = tri_s[keep]

    occ = (counts > 0).astype(np.uint8).reshape(nz, ny, nx)
    brick = build_accel(jnp.asarray(occ), bb_min, vs)
    tri9 = np.concatenate(
        [tri_all.reshape(f_total, 9),
         np.zeros((1, 9), np.float32)], axis=0)    # degenerate pad row
    return TriAccel(
        brick=brick, cell_slot=jnp.asarray(cell_slot),
        cell_tris=jnp.asarray(cell_tris), tri9=jnp.asarray(tri9),
        origin=jnp.asarray(bb_min.astype(np.float32)), dims=dims,
        voxel_size=float(vs), l_width=l_width, overflow_cells=overflow)


def _cell_span(lin, o, d, origin, dims, vs):
    """(t_enter, t_exit) of the cell AABB, reference slab float math."""
    nx, ny, _ = dims
    x = lin % nx
    y = (lin // nx) % ny
    z = lin // (nx * ny)
    c = origin + (jnp.stack([x, y, z], axis=-1).astype(jnp.float32)
                  + 0.5) * vs
    half = jnp.float32(0.5) * vs
    inv = 1.0 / d
    tb = inv * ((c - half) - o)
    tt = inv * ((c + half) - o)
    t0 = jnp.max(jnp.minimum(tb, tt), axis=-1)
    t1 = jnp.min(jnp.maximum(tb, tt), axis=-1)
    return t0, t1


def _mt_cell(ta, o, d, slot_rows, t_lo, span_hi, t_max):
    """Möller-Trumbore over one cell row per ray.

    slot_rows: (m,) row index into cell_tris (callers clamp >= 0 and mask
    via t_lo = +inf for dead lanes).  Returns (t, tri_id, u, v) of the
    nearest accepted hit with t_lo < t <= span_hi (inclusive in-cell
    bound) and t < t_max (the brute backend's strict interval rule)."""
    ids = ta.cell_tris[slot_rows]                      # (m, L)
    rows = ta.tri9[jnp.where(ids >= 0, ids, ta.tri9.shape[0] - 1)]
    a = rows[..., 0:3]
    b = rows[..., 3:6]
    c = rows[..., 6:9]
    t, u, v = hit_triangles(o[:, None, :], d[:, None, :], a, b, c,
                            t_min=t_lo[:, None], t_max=t_max[:, None])
    t = jnp.where((ids >= 0) & (t <= span_hi[:, None]), t, jnp.inf)
    arg = jnp.argmin(t, axis=1)
    take = lambda x: jnp.take_along_axis(x, arg[:, None], axis=1)[:, 0]
    tb = take(t)
    return tb, jnp.where(jnp.isfinite(tb), take(ids), -1), take(u), take(v)


@functools.partial(
    jax.jit, static_argnames=("ta_static", "rounds", "cand_frac"))
def _trace_tri_impl(o, d, ta, t_min, t_max, *, ta_static, rounds,
                    cand_frac):
    dims, vs_s, l_width = ta_static
    vs = jnp.float32(vs_s)
    n = o.shape[0]
    origin = ta.origin
    t_min_b = jnp.broadcast_to(jnp.asarray(t_min, jnp.float32), (n,))
    t_max_b = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (n,))

    best_t = jnp.full((n,), jnp.inf, jnp.float32)
    best_id = jnp.full((n,), -1, jnp.int32)
    best_u = jnp.zeros((n,), jnp.float32)
    best_v = jnp.zeros((n,), jnp.float32)

    # ---- round 0: the cell the ray STARTS in (grid trace can't report
    # it: its accept rule needs the cell-entry t0 > 0) ------------------
    nx, ny, nz = dims
    ocell = jnp.floor((o - origin) / vs).astype(jnp.int32)
    inside = ((ocell >= 0) & (ocell < jnp.asarray([nx, ny, nz]))) \
        .all(axis=-1)
    olin = jnp.clip(ocell[:, 0] + nx * (ocell[:, 1] + ny * ocell[:, 2]),
                    0, nx * ny * nz - 1)
    oslot = jnp.where(inside, ta.cell_slot[olin], -1)
    has0 = oslot >= 0
    _, t1_0 = _cell_span(olin, o, d, origin, dims, vs)
    lo0 = jnp.where(has0, t_min_b, jnp.inf)
    hi0 = t1_0 * (1 + 1e-6) + 1e-7
    t0b, id0, u0, v0_ = _mt_cell(ta, o, d, jnp.maximum(oslot, 0), lo0,
                                 hi0, t_max_b)
    got0 = jnp.isfinite(t0b) & has0
    best_t = jnp.where(got0, t0b, best_t)
    best_id = jnp.where(got0, id0, best_id)
    best_u = jnp.where(got0, u0, best_u)
    best_v = jnp.where(got0, v0_, best_v)

    # ---- marching rounds ----------------------------------------------
    t_cur = t_min_b
    active = ~got0

    def cap_up(c):
        """Round a capacity up to whole kernel blocks."""
        return max(BLOCK, -(-c // BLOCK) * BLOCK)

    def march(state, walk_frac=1):
        """One marching lap.  walk_frac > 1 compacts the MARCH DOMAIN
        before the inner grid trace (later laps have few active rays, so
        a full-width inner trace every lap would be mostly idle lanes);
        active rays beyond the compacted budget retry next lap with
        t_cur unchanged — the same starvation semantics as cand_frac,
        covered by the same lap bound."""
        best_t, best_id, best_u, best_v, t_cur, active = state
        if walk_frac > 1:
            wcap = cap_up(-(-n // walk_frac))
            wsel, wlive, wsel_c, _ = compact_mask(active, wcap, n)
            ow, dw = o[wsel_c], d[wsel_c]
            tmn = jnp.where(wlive, t_cur[wsel_c], 0.0)
            tmx = jnp.where(wlive, t_max_b[wsel_c], -1.0)
            t_cw, lin_w = trace_grid_fast(ow, dw, ta.brick, t_min=tmn,
                                          t_max=tmx)
            widx = jnp.where(wlive, wsel, n)
            t_cell = jnp.full((n,), jnp.inf, jnp.float32).at[widx].set(
                t_cw, mode="drop")
            lin = jnp.full((n,), -1, jnp.int32).at[widx].set(
                lin_w, mode="drop")
            walked = jnp.zeros((n,), bool).at[widx].set(True, mode="drop")
        else:
            tmn = jnp.where(active, t_cur, 0.0)
            tmx = jnp.where(active, t_max_b, -1.0)
            t_cell, lin = trace_grid_fast(o, d, ta.brick, t_min=tmn,
                                          t_max=tmx)
            walked = jnp.ones((n,), bool)
        has = jnp.isfinite(t_cell) & active
        # compact candidate rays before the (m, L) list gather
        cap = cap_up(-(-n // cand_frac)) if cand_frac > 1 else n
        if cap < n:
            sel, live, sel_c, _ = compact_mask(has, cap, n)
            # rays beyond cap retry next round (t_cur unchanged)
        else:
            sel = sel_c = jnp.arange(n, dtype=jnp.int32)
            live = has
        oc = o[sel_c]
        dc = d[sel_c]
        linc = jnp.maximum(lin[sel_c], 0)
        t0c, t1c = _cell_span(linc, oc, dc, origin, dims, vs)
        slotc = jnp.maximum(ta.cell_slot[jnp.clip(linc, 0,
                                                  nx * ny * nz - 1)], 0)
        lo = jnp.where(live, jnp.maximum(t_cur[sel_c],
                                         t0c * (1 - 1e-6) - 1e-7),
                       jnp.inf)
        hi = t1c * (1 + 1e-6) + 1e-7
        tc, idc, uc, vc = _mt_cell(ta, oc, dc, slotc, lo, hi,
                                   t_max_b[sel_c])
        gotc = jnp.isfinite(tc) & live
        idx = jnp.where(gotc, sel, n)
        best_t = best_t.at[idx].set(tc, mode="drop")
        best_id = best_id.at[idx].set(idc, mode="drop")
        best_u = best_u.at[idx].set(uc, mode="drop")
        best_v = best_v.at[idx].set(vc, mode="drop")
        # advance past the cell for rays that found a cell but no hit:
        # never backward (monotone march).  Advance to the MIDPOINT of
        # the tested cell, not just under its exit: adjacent cells
        # compute their shared face from different float expressions
        # (center(i)+half vs center(i+1)-half, then the slab divide), so
        # the next cell's entry can undershoot this exit by several ulp
        # (measured 3e-6 relative) — a t1-eps advance then rejects it in
        # the fine accept (t0 >= t_min) and the ray dies mid-mesh.  The
        # midpoint is above this cell's entry (can't re-find it) and
        # half a span below the next entry (boundary fuzz can't skip it).
        adv = 0.5 * (t0c + t1c)
        t_next = jnp.full((n,), jnp.inf, jnp.float32).at[
            jnp.where(live, sel, n)].set(adv, mode="drop")
        served = jnp.zeros((n,), bool).at[
            jnp.where(live, sel, n)].set(True, mode="drop")
        resolved = jnp.zeros((n,), bool).at[idx].set(True, mode="drop")
        t_cur = jnp.where(served & ~resolved,
                          jnp.maximum(t_cur, t_next), t_cur)
        # stay active: unresolved rays that were served this round (march
        # on), that found a cell but overflowed the candidate cap, or that
        # overflowed the walk domain (both retry with an unchanged
        # t_cur); rays whose walk found no cell are misses
        active = active & ~resolved & (served | has | ~walked) \
            & (t_cur <= t_max_b)
        return (best_t, best_id, best_u, best_v, t_cur, active)

    state = (best_t, best_id, best_u, best_v, t_cur, active)
    walk_fracs = [1, 4] + [8] * max(0, rounds - 2)
    for r in range(rounds):
        state = march(state, walk_frac=walk_fracs[r])

    # drain-to-empty tail: rays still marching after the static rounds
    # (tangent rays crossing MANY nonempty cells) loop until they resolve
    # or exit — zero iterations in the common case, and a static bound
    # guarantees termination.  The bound must account for candidate-cap
    # STARVATION (review r3): a lap serves at most cap = n/cand_frac
    # rays (one cell each) and overflow rays retry with t_cur unchanged,
    # so with every ray active the laps needed are
    # cand_frac * cells_per_ray, not cells_per_ray — a (nx+ny+nz)-only
    # cap silently returned misses on dense-candidate frames.  Total
    # cell-visits are <= n * (nx+ny+nz+3) and each lap consumes
    # min(active, cap) visits, so cand_frac * (nx+ny+nz+3) + 1 is a
    # true upper bound; the cond still exits the moment the queue
    # drains, so the common case runs zero iterations either way.
    # the drain lap serves at most min(n/walk_frac, n/cand_frac) rays:
    # both compactions starve, so the bound takes the larger frac
    lap_cap = max(1, cand_frac, 8) * (nx + ny + nz + 3) + 1

    def cond(st):
        return jnp.logical_and(jnp.any(st[0][5]), st[1] < lap_cap)

    def body(st):
        return (march(st[0], walk_frac=8), st[1] + 1)

    state, laps = jax.lax.while_loop(cond, body, (state, jnp.int32(0)))
    best_t, best_id, best_u, best_v, _, active = state
    return (best_t, best_id, best_u, best_v,
            jnp.sum(active.astype(jnp.int32)), laps)


def trace_triangles_grid(origins, dirs, ta: TriAccel, t_min=TMIN,
                         t_max=TMAX, rounds=6, cand_frac=4,
                         return_stats=False):
    """Nearest triangle hit via the tri-grid march.

    Same contract as ops.traverse.trace_triangles_brute: (t, prim_id, u,
    v), t = +inf / id = -1 on miss.  Ties inside one cell resolve to the
    L-row order (build order = stable ascending triangle id, matching
    the brute backend's lowest-index tie rule for identical t).
    """
    batch_shape = origins.shape[:-1]
    o = origins.reshape(-1, 3)
    d = dirs.reshape(-1, 3)
    t_max_b = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32),
                               batch_shape).reshape(-1)
    t_min_b = jnp.broadcast_to(jnp.asarray(t_min, jnp.float32),
                               batch_shape).reshape(-1)
    t, pid, u, v, unresolved, laps = _trace_tri_impl(
        o, d, ta, t_min_b, t_max_b,
        ta_static=(ta.dims, ta.voxel_size, ta.l_width),
        rounds=rounds, cand_frac=cand_frac)
    out = (t.reshape(batch_shape), pid.reshape(batch_shape),
           u.reshape(batch_shape), v.reshape(batch_shape))
    if return_stats == "full":
        return out + (unresolved, laps)
    if return_stats:
        return out + (unresolved,)
    return out


def any_hit_triangles_grid(origins, dirs, ta: TriAccel, t_min=TMIN,
                           t_max=TMAX, rounds=6):
    """Occlusion predicate (shadow rays) via the tri-grid march."""
    t, _, _, _ = trace_triangles_grid(origins, dirs, ta, t_min=t_min,
                                      t_max=t_max, rounds=rounds)
    return jnp.isfinite(t)
