"""Ray traversal backends over voxel geometry.

The reference delegates traversal to the Vulkan driver's TLAS/BLAS walk
and runs the slab test per candidate AABB (raytrace.rint).  Hit semantics
to reproduce (per VK_KHR_ray_tracing report/accept rules the shaders rely
on): a voxel is hit at t0 from the slab test iff

    t1 > max(t0, 0)   (the rint predicate)
    t0 > 0            (the rint report guard)
    t_min <= t0 <= t_max   (hardware ray-interval clamp)

and the nearest accepted t0 wins.

Backends:
  trace_aabbs_brute — test every AABB (chunked scan).  This is the
                      semantic reference: identical AABB values, identical
                      float ops, works for any AABB soup (Vec encoding).
  trace_grid_dda    — Amanatides-Woo 3-D DDA over the dense bitmask grid.
                      Returns identical hits for grids whose AABBs are the
                      cell boxes (Bool/AabbStruct encodings): the first
                      occupied cell along the ray whose slab t0 passes the
                      rules above IS the argmin.
  The brick-hierarchy kernel walk (traverse_fast.py) and the octree walk
  (octree_traverse.py) are the accelerated backends.

All functions are vectorized over an arbitrary ray batch shape (...,).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .intersect import TMAX, TMIN, hit_aabb

__all__ = ["trace_aabbs_brute", "any_hit_aabbs_brute", "trace_grid_dda",
           "trace_grid_dda_chunked", "trace_grid_dda_zslab",
           "any_hit_grid_dda", "trace_triangles_brute",
           "any_hit_triangles_brute"]


def _accept(t0, t_min, t_max):
    return (t0 > 0.0) & (t0 >= t_min) & (t0 <= t_max)


def trace_aabbs_brute(origins, dirs, aabbs, t_min=TMIN, t_max=TMAX,
                      chunk=512):
    """Nearest voxel hit by exhaustive slab tests.

    origins/dirs: (..., 3); aabbs: (N, 6).  Returns (t, prim_id) with
    t = +inf, prim_id = -1 on miss.  Ties resolve to the lowest primitive
    index (deterministic, unlike the driver's undefined order).
    """
    batch_shape = origins.shape[:-1]
    n = aabbs.shape[0]
    if n == 0:
        return (jnp.full(batch_shape, jnp.inf, jnp.float32),
                jnp.full(batch_shape, -1, jnp.int32))
    n_chunks = -(-n // chunk)
    padded = jnp.pad(aabbs, ((0, n_chunks * chunk - n), (0, 0)),
                     constant_values=np.inf)
    chunks = padded.reshape(n_chunks, chunk, 6)

    # t_max may be per-ray (shadow light distance): align with chunk axis
    t_max = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32),
                             batch_shape)[..., None]
    o = origins[..., None, :]
    d = dirs[..., None, :]

    def body(carry, box):
        best_t, best_id, base = carry
        t0 = hit_aabb(box[:, 0:3], box[:, 3:6], o, d)  # (..., chunk)
        ok = _accept(t0, t_min, t_max)
        t0 = jnp.where(ok, t0, jnp.inf)
        arg = jnp.argmin(t0, axis=-1)
        tbest = jnp.take_along_axis(t0, arg[..., None], axis=-1)[..., 0]
        better = tbest < best_t
        best_id = jnp.where(better, base + arg.astype(jnp.int32), best_id)
        best_t = jnp.where(better, tbest, best_t)
        return (best_t, best_id, base + chunk), None

    init = (jnp.full(batch_shape, jnp.inf, jnp.float32),
            jnp.full(batch_shape, -1, jnp.int32), jnp.int32(0))
    (t, pid, _), _ = jax.lax.scan(body, init, chunks)
    return t, pid


def any_hit_aabbs_brute(origins, dirs, aabbs, t_min=TMIN, t_max=TMAX,
                        chunk=512):
    """Shadow-ray predicate: does any AABB hit fall inside (t_min, t_max)?

    t_max may be an array (per-ray light distance).
    """
    t, _ = trace_aabbs_brute(origins, dirs, aabbs, t_min=t_min,
                             t_max=jnp.asarray(t_max), chunk=chunk)
    return jnp.isfinite(t)


def trace_triangles_brute(origins, dirs, v0, v1, v2, t_min=TMIN, t_max=TMAX,
                          chunk=256):
    """Nearest triangle hit (the driver's triangle BLAS, in software).

    Returns (t, prim_id, u, v) with t = +inf / prim_id = -1 on miss.
    """
    from .intersect import hit_triangles

    batch_shape = origins.shape[:-1]
    n = v0.shape[0]
    if n == 0:
        z = jnp.zeros(batch_shape, jnp.float32)
        return (jnp.full(batch_shape, jnp.inf, jnp.float32),
                jnp.full(batch_shape, -1, jnp.int32), z, z)
    n_chunks = -(-n // chunk)
    pad = n_chunks * chunk - n

    def pad_r(x):
        return jnp.pad(x, ((0, pad), (0, 0))).reshape(n_chunks, chunk, 3)

    tris = (pad_r(v0), pad_r(v1), pad_r(v2))
    t_max = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32),
                             batch_shape)[..., None]
    o = origins[..., None, :]
    d = dirs[..., None, :]

    def body(carry, tri):
        best_t, best_id, best_u, best_v, base = carry
        a, b, c = tri
        t, u, v = hit_triangles(o, d, a, b, c, t_min=t_min, t_max=t_max)
        arg = jnp.argmin(t, axis=-1)
        take = lambda x: jnp.take_along_axis(x, arg[..., None],
                                             axis=-1)[..., 0]
        tb, ub, vb = take(t), take(u), take(v)
        better = tb < best_t
        best_id = jnp.where(better, base + arg.astype(jnp.int32), best_id)
        best_t = jnp.where(better, tb, best_t)
        best_u = jnp.where(better, ub, best_u)
        best_v = jnp.where(better, vb, best_v)
        return (best_t, best_id, best_u, best_v, base + chunk), None

    z = jnp.zeros(batch_shape, jnp.float32)
    init = (jnp.full(batch_shape, jnp.inf, jnp.float32),
            jnp.full(batch_shape, -1, jnp.int32), z, z, jnp.int32(0))
    (t, pid, u, v, _), _ = jax.lax.scan(body, init, tris)
    return t, pid, u, v


def any_hit_triangles_brute(origins, dirs, v0, v1, v2, t_min=TMIN,
                            t_max=TMAX, chunk=256):
    t, _, _, _ = trace_triangles_brute(origins, dirs, v0, v1, v2,
                                       t_min=t_min, t_max=t_max, chunk=chunk)
    return jnp.isfinite(t)


def _dda_init(o, d, origin, dims, vs):
    """Entry cell + boundary-crossing state for each ray (traced helper).

    Returns (cell, t_next, inside) with the exact float expressions the
    monolithic dda always used."""
    nx, ny, nz = dims
    dims_f = jnp.asarray([nx, ny, nz], jnp.float32)
    grid_max = origin + dims_f * vs
    inv_d = 1.0 / d
    # entry into the grid bounds
    tbot = inv_d * (origin - o)
    ttop = inv_d * (grid_max - o)
    tn = jnp.minimum(tbot, ttop)
    tf = jnp.maximum(tbot, ttop)
    t_enter = jnp.maximum(jnp.maximum(tn[:, 0], tn[:, 1]), tn[:, 2])
    t_exit = jnp.minimum(jnp.minimum(tf[:, 0], tf[:, 1]), tf[:, 2])
    # start marginally inside the first cell
    t_start = jnp.maximum(t_enter, 0.0) + 1e-7
    inside = t_exit > jnp.maximum(t_enter, 0.0)

    p = o + d * t_start[:, None]
    cell = jnp.clip(
        jnp.floor((p - origin) / vs).astype(jnp.int32), 0,
        jnp.asarray([nx - 1, ny - 1, nz - 1], jnp.int32),
    )
    step = jnp.where(d >= 0, 1, -1).astype(jnp.int32)
    # t at the next boundary crossing per axis
    next_bound = origin + (cell + (step > 0)).astype(jnp.float32) * vs
    t_next = jnp.where(d != 0.0, (next_bound - o) * inv_d, jnp.inf)
    return cell, t_next, inside


def _dda_cell_hit_t(cell, o, d, origin, vs):
    """Slab t0 of the cell AABB built with the reference's float expr."""
    half = jnp.float32(0.5) * vs
    c = origin + (cell.astype(jnp.float32) + 0.5) * vs
    return hit_aabb(c - half, c + half, o, d)


def _dda_steps(o, d, occ_flat, origin, state, *, dims, vs, t_min, t_max,
               seg_steps):
    """Run up to seg_steps DDA iterations from `state` (traced helper).

    state = (cell, t_next, (best_t, best_lin), active); the while bound
    is seg_steps, so one dispatch never runs more than seg_steps
    full-width iterations (the chunked driver's segment length)."""
    nx, ny, nz = dims
    inv_d = 1.0 / d
    step = jnp.where(d >= 0, 1, -1).astype(jnp.int32)
    t_delta = jnp.where(d != 0.0, vs * jnp.abs(inv_d), jnp.inf)

    def cond(state):
        _, _, _, active, steps = state
        return (steps < seg_steps) & jnp.any(active)

    def body(state):
        cell, t_next, best, active, steps = state
        lin = cell[:, 0] + nx * (cell[:, 1] + ny * cell[:, 2])
        occ_here = occ_flat[jnp.clip(lin, 0, nx * ny * nz - 1)] > 0
        t0 = _dda_cell_hit_t(cell, o, d, origin, vs)
        ok = active & occ_here & _accept(t0, t_min, t_max)
        best_t, best_lin = best
        best_t = jnp.where(ok, t0, best_t)
        best_lin = jnp.where(ok, lin, best_lin)
        active = active & ~ok
        # also deactivate rays whose next t exceeds t_max
        axis = jnp.argmin(t_next, axis=-1)
        t_cross = jnp.take_along_axis(t_next, axis[:, None], axis=-1)[:, 0]
        active = active & (t_cross <= jnp.broadcast_to(t_max, t_cross.shape))
        onehot = jax.nn.one_hot(axis, 3, dtype=jnp.int32)
        cell = cell + onehot * step
        # select, not multiply: 0 * inf (an axis the ray never crosses)
        # would turn that axis's t_next into NaN
        t_next = t_next + jnp.where(onehot > 0, t_delta, 0.0)
        oob = (cell < 0) | (cell >= jnp.asarray([nx, ny, nz], jnp.int32))
        active = active & ~oob.any(axis=-1)
        return cell, t_next, (best_t, best_lin), active, steps + 1

    cell, t_next, best, active = state
    cell, t_next, best, active, _ = jax.lax.while_loop(
        cond, body, (cell, t_next, best, active, jnp.int32(0)))
    return cell, t_next, best, active


def _dda_final_t(lin, o, d, origin, vs, *, dims):
    """Recompute the final hit t OUTSIDE the while loop: XLA may contract
    the in-loop slab expression into FMAs, drifting a few ulp from the
    brute backend; this standalone evaluation restores bit-exact parity."""
    nx, ny, _nz = dims
    hit = lin >= 0
    lin_safe = jnp.maximum(lin, 0)
    hx = lin_safe % nx
    hy = (lin_safe // nx) % ny
    hz = lin_safe // (nx * ny)
    hcell = jnp.stack([hx, hy, hz], axis=-1)
    return jnp.where(hit, _dda_cell_hit_t(hcell, o, d, origin, vs), jnp.inf)


@functools.partial(jax.jit, static_argnames=("dims", "voxel_size_static"))
def trace_grid_dda(origins, dirs, occ_flat, grid_origin, *, dims,
                   voxel_size_static, t_min=TMIN, t_max=TMAX):
    """Amanatides-Woo DDA over a dense occupancy grid.

    occ_flat: (X*Y*Z,) uint8; grid_origin: (3,).  Returns (t, lin) with
    t = +inf / lin = -1 on miss.  t is the slab-test t0 of the hit cell's
    AABB evaluated with the reference float math, so distances match the
    brute backend bit-for-bit.

    This is ONE dispatch with a while bound of nx+ny+nz+3 full-width
    iterations (trace_grid_dda_chunked splits the same walk into bounded
    dispatches).
    """
    nx, ny, nz = dims
    vs = jnp.float32(voxel_size_static)
    origin = jnp.asarray(grid_origin, jnp.float32)
    batch_shape = origins.shape[:-1]
    o = origins.reshape(-1, 3)
    d = dirs.reshape(-1, 3)
    n_rays = o.shape[0]
    # t_max may be per-ray (shadow light distance)
    t_max = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32),
                             batch_shape).reshape(-1)
    max_steps = nx + ny + nz + 3

    cell, t_next, inside = _dda_init(o, d, origin, dims, vs)
    state = (cell, t_next,
             (jnp.full((n_rays,), jnp.inf, jnp.float32),
              jnp.full((n_rays,), -1, jnp.int32)),
             inside)
    _, _, (_t_loop, lin), _ = _dda_steps(
        o, d, occ_flat, origin, state, dims=dims, vs=vs,
        t_min=t_min, t_max=t_max, seg_steps=max_steps)

    t = _dda_final_t(lin, o, d, origin, vs, dims=dims)
    return t.reshape(batch_shape), lin.reshape(batch_shape)


@functools.partial(jax.jit, static_argnames=("dims", "voxel_size_static",
                                             "seg_steps"))
def _dda_segment_jit(o, d, occ_flat, grid_origin, cell, t_next, best_t,
                     best_lin, active, t_max, *, dims, voxel_size_static,
                     seg_steps, t_min=TMIN):
    vs = jnp.float32(voxel_size_static)
    origin = jnp.asarray(grid_origin, jnp.float32)
    cell, t_next, (best_t, best_lin), active = _dda_steps(
        o, d, occ_flat, origin, (cell, t_next, (best_t, best_lin), active),
        dims=dims, vs=vs, t_min=t_min, t_max=t_max, seg_steps=seg_steps)
    return cell, t_next, best_t, best_lin, active, jnp.sum(active)


@functools.partial(jax.jit, static_argnames=("dims", "voxel_size_static"))
def _dda_init_jit(o, d, grid_origin, *, dims, voxel_size_static):
    vs = jnp.float32(voxel_size_static)
    origin = jnp.asarray(grid_origin, jnp.float32)
    return _dda_init(o, d, origin, dims, vs)


@functools.partial(jax.jit, static_argnames=("dims", "voxel_size_static"))
def _dda_finish_jit(lin, o, d, grid_origin, *, dims, voxel_size_static):
    vs = jnp.float32(voxel_size_static)
    origin = jnp.asarray(grid_origin, jnp.float32)
    return _dda_final_t(lin, o, d, origin, vs, dims=dims)


def trace_grid_dda_chunked(origins, dirs, occ_flat, grid_origin, *, dims,
                           voxel_size_static, t_min=TMIN, t_max=TMAX,
                           ray_chunk=131072, seg_steps=256):
    """Exhaustive DDA in bounded dispatches: same results as
    trace_grid_dda, but every dispatch is bounded to ray_chunk rays x
    seg_steps while-loop iterations (a host loop resumes the carried
    state until every ray in the chunk retires), so device memory and
    per-dispatch time stay bounded at any frame size.  It is the
    reference bench.py's full-scale exhaustiveness gate uses.

    Host orchestration (per-segment n_active readback) means this CANNOT
    run inside an outer jit — it is an eager-mode driver, not a traced
    function.  Cost: one host round trip per segment; rays retire early
    so typical chunks take 2-4 segments.
    """
    nx, ny, nz = dims
    batch_shape = origins.shape[:-1]
    o_all = np.asarray(origins, np.float32).reshape(-1, 3)
    d_all = np.asarray(dirs, np.float32).reshape(-1, 3)
    n = o_all.shape[0]
    t_max_all = np.broadcast_to(np.asarray(t_max, np.float32),
                                batch_shape).reshape(-1)
    max_steps = nx + ny + nz + 3
    n_segs = -(-max_steps // seg_steps)
    occ_flat = jnp.asarray(occ_flat)
    grid_origin = jnp.asarray(grid_origin, jnp.float32)

    ray_chunk = min(ray_chunk, n) if n else ray_chunk
    t_out = np.full((n,), np.inf, np.float32)
    lin_out = np.full((n,), -1, np.int32)
    for c0 in range(0, n, ray_chunk):
        c1 = min(c0 + ray_chunk, n)
        m = c1 - c0
        pad = ray_chunk - m
        o = jnp.asarray(np.pad(o_all[c0:c1], ((0, pad), (0, 0)),
                               mode="edge"))
        d = jnp.asarray(np.pad(d_all[c0:c1], ((0, pad), (0, 0)),
                               mode="edge"))
        tmx = jnp.asarray(np.pad(t_max_all[c0:c1], (0, pad), mode="edge"))
        cell, t_next, active = _dda_init_jit(
            o, d, grid_origin, dims=dims,
            voxel_size_static=voxel_size_static)
        best_t = jnp.full((ray_chunk,), jnp.inf, jnp.float32)
        best_lin = jnp.full((ray_chunk,), -1, jnp.int32)
        for _ in range(n_segs):
            cell, t_next, best_t, best_lin, active, n_act = \
                _dda_segment_jit(o, d, occ_flat, grid_origin, cell,
                                 t_next, best_t, best_lin, active, tmx,
                                 dims=dims,
                                 voxel_size_static=voxel_size_static,
                                 seg_steps=seg_steps, t_min=t_min)
            if int(n_act) == 0:
                break
        t_c = _dda_finish_jit(best_lin, o, d, grid_origin, dims=dims,
                              voxel_size_static=voxel_size_static)
        t_out[c0:c1] = np.asarray(t_c)[:m]
        lin_out[c0:c1] = np.asarray(best_lin)[:m]
    return (t_out.reshape(batch_shape), lin_out.reshape(batch_shape))


def trace_grid_dda_zslab(origins, dirs, occ_slab_flat, grid_origin, z0, *,
                         dims, nzs, voxel_size_static, t_min=TMIN,
                         t_max=TMAX):
    """DDA over ONE Z-slab of a grid sharded across devices (SURVEY §5
    "long-context analog": occupancy sharded over Z so grids larger than
    one chip's HBM stay renderable).

    occ_slab_flat: (nx*ny*nzs,) uint8, the slab's cells in x-fastest
    order; z0: TRACED int32 first global z of the slab (axis_index * nzs
    under shard_map); dims stays the FULL grid dims.  All float
    expressions (cell AABB slab t, step boundaries) use the GLOBAL
    origin and GLOBAL cell coordinates — identical values to the
    monolithic trace_grid_dda, so a pmin-over-slabs merge reproduces the
    replicated result (the first accepted cell along a ray is its
    global min-t accept: slab t0 is non-decreasing along the walk).
    Returns (t, lin) with GLOBAL linear cell ids; +inf/-1 where this
    slab has no accept.  Plain traced function — call it inside
    shard_map/jit (parallel/comm.py render_zslab_sharded).
    """
    nx, ny, nz = dims
    vs = jnp.float32(voxel_size_static)
    origin = jnp.asarray(grid_origin, jnp.float32)
    batch_shape = origins.shape[:-1]
    o = origins.reshape(-1, 3)
    d = dirs.reshape(-1, 3)
    n_rays = o.shape[0]
    t_max = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32),
                             batch_shape).reshape(-1)
    t_min = jnp.broadcast_to(jnp.asarray(t_min, jnp.float32),
                             batch_shape).reshape(-1)
    z0 = jnp.asarray(z0, jnp.int32)
    z0f = z0.astype(jnp.float32)

    inv_d = 1.0 / d
    # entry into the SLAB's box (x/y full extent, z the slab's)
    box_min = jnp.stack([origin[0], origin[1], origin[2] + z0f * vs])
    box_max = jnp.stack([origin[0] + jnp.float32(nx) * vs,
                         origin[1] + jnp.float32(ny) * vs,
                         origin[2] + (z0f + jnp.float32(nzs)) * vs])
    tbot = inv_d * (box_min[None, :] - o)
    ttop = inv_d * (box_max[None, :] - o)
    tn = jnp.minimum(tbot, ttop)
    tf = jnp.maximum(tbot, ttop)
    t_enter = jnp.maximum(jnp.maximum(tn[:, 0], tn[:, 1]), tn[:, 2])
    t_exit = jnp.minimum(jnp.minimum(tf[:, 0], tf[:, 1]), tf[:, 2])
    t_start = jnp.maximum(t_enter, 0.0) + 1e-7
    active = t_exit > jnp.maximum(t_enter, 0.0)

    p = o + d * t_start[:, None]
    cell = jnp.floor((p - origin) / vs).astype(jnp.int32)
    lo = jnp.stack([jnp.int32(0), jnp.int32(0), z0])
    hi = jnp.stack([jnp.int32(nx - 1), jnp.int32(ny - 1),
                    z0 + jnp.int32(nzs - 1)])
    cell = jnp.clip(cell, lo[None, :], hi[None, :])
    step = jnp.where(d >= 0, 1, -1).astype(jnp.int32)
    next_bound = origin + (cell + (step > 0)).astype(jnp.float32) * vs
    t_next = jnp.where(d != 0.0, (next_bound - o) * inv_d, jnp.inf)
    t_delta = jnp.where(d != 0.0, vs * jnp.abs(inv_d), jnp.inf)
    max_steps = nx + ny + nzs + 3

    def cond(state):
        _, _, _, active, steps = state
        return (steps < max_steps) & jnp.any(active)

    def body(state):
        cell, t_next, best, active, steps = state
        lin_local = cell[:, 0] + nx * (cell[:, 1]
                                       + ny * (cell[:, 2] - z0))
        occ_here = occ_slab_flat[
            jnp.clip(lin_local, 0, nx * ny * nzs - 1)] > 0
        t0 = _dda_cell_hit_t(cell, o, d, origin, vs)
        ok = active & occ_here & _accept(t0, t_min, t_max)
        best_t, best_lin = best
        best_t = jnp.where(ok, t0, best_t)
        # report the GLOBAL linear id (x + nx*(y + ny*z))
        best_lin = jnp.where(
            ok, cell[:, 0] + nx * (cell[:, 1] + ny * cell[:, 2]),
            best_lin)
        active = active & ~ok
        axis = jnp.argmin(t_next, axis=-1)
        t_cross = jnp.take_along_axis(t_next, axis[:, None], axis=-1)[:, 0]
        active = active & (t_cross <= jnp.broadcast_to(t_max,
                                                       t_cross.shape))
        onehot = jax.nn.one_hot(axis, 3, dtype=jnp.int32)
        cell = cell + onehot * step
        # select, not multiply: 0 * inf (an axis the ray never crosses)
        # would turn that axis's t_next into NaN
        t_next = t_next + jnp.where(onehot > 0, t_delta, 0.0)
        oob = (cell < lo[None, :]) | (cell > hi[None, :])
        active = active & ~oob.any(axis=-1)
        return cell, t_next, (best_t, best_lin), active, steps + 1

    init = (cell, t_next,
            (jnp.full((n_rays,), jnp.inf, jnp.float32),
             jnp.full((n_rays,), -1, jnp.int32)),
            active, jnp.int32(0))
    _, _, (_t_loop, lin), _, _ = jax.lax.while_loop(cond, body, init)
    t = _dda_final_t(lin, o, d, origin, vs, dims=dims)
    return t.reshape(batch_shape), lin.reshape(batch_shape)


@functools.partial(jax.jit, static_argnames=("dims", "voxel_size_static"))
def any_hit_grid_dda(origins, dirs, occ_flat, grid_origin, *, dims,
                     voxel_size_static, t_min=TMIN, t_max=TMAX):
    """Shadow predicate via DDA; t_max may be per-ray."""
    t, _ = trace_grid_dda(origins, dirs, occ_flat, grid_origin, dims=dims,
                          voxel_size_static=voxel_size_static,
                          t_min=t_min, t_max=t_max)
    return jnp.isfinite(t)