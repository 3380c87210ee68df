"""Brick-hierarchy DDA: the voxel traversal kernel (Pallas, Triton route).

One lane per ray walks the grid cell by cell in Amanatides-Woo order (the
visiting order of ops.traverse.trace_grid_dda) and retires at its first
accepted cell, which is the nearest: slab t0 never decreases along the
walk.  This is what the reference's driver did on its card: one
invocation per ray walks the acceleration structure and stops at the
first accepted AABB (raytrace.rint:46-56).

Empty space is skipped through a three-level bitmask hierarchy, each
level read with a per-lane load from global memory:

  l2      one bit per superbrick of 8^3 bricks (64^3 cells)
  coarse  one bit per brick of 8^3 cells
  fine    the brick's 512 cell bits, 16 words stored brick-major so one
          brick is 64 contiguous bytes

All three stay resident in the GPU's L2 cache at the grid sizes the
benchmark uses (a 512^3 grid is ~8 MB of fine words).

Each iteration a lane looks at the box it is in: the largest empty box
(superbrick, brick) containing its cell, or the cell itself.  In an empty
box it lands one cell short of the box exit on every axis (clamped into
the box, never backward) and takes one exact cell step; float slop can
only make it land behind the ray's true path, and a lane behind the path
catches up inside the empty box, because its stale plane crossings sort
first.  So no occupied cell is ever skipped.  In an occupied brick it
tests the cell with the reference slab expressions, then steps one cell.
Every iteration advances at least one cell, so nx + ny + nz + 3
iterations bound the walk; a lane still alive there is reported as
unresolved (lin = -2), which never happens on a well-formed grid.

Off the GPU the kernel runs only in the Pallas interpreter, and only when
INTERPRET is set (tests/conftest.py does); otherwise it raises.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

__all__ = ["brick_dda", "use_interpreter", "INTERPRET", "BLOCK"]

#: Run the kernel in the Pallas interpreter (CPU tests only).
INTERPRET = False
#: Rays per program (one lane each) and the warps that run them.
BLOCK = 32
NUM_WARPS = 1

BRICK = 8
_INF = np.float32(np.inf)


def use_interpreter() -> bool:
    """Whether to run the kernel interpreted; raises off the GPU unless
    INTERPRET is set.  Callers evaluate it outside jit and pass it on as
    a static argument, so a cached trace never hides the check."""
    if INTERPRET:
        return True
    backend = jax.default_backend()
    if backend != "gpu":
        raise RuntimeError(
            f"the brick_dda traversal kernel needs a CUDA GPU, but JAX's "
            f"backend is {backend!r}; render with backend='dda' there")
    return False


def _kernel(ox_ref, oy_ref, oz_ref, dx_ref, dy_ref, dz_ref, tmin_ref,
            tmax_ref, off_ref, l2_ref, coarse_ref, fine_ref, lin_ref, *,
            dims, bdims, origin, voxel_size, max_iters):
    nx, ny, nz = dims
    bx, by, _ = bdims
    sbx, sby = -(-bx // 8), -(-by // 8)
    og = tuple(np.float32(c) for c in origin)
    vs = np.float32(voxel_size)
    inv_vs = np.float32(1.0) / vs
    half = np.float32(0.5) * vs
    gmax = tuple(np.float32(og[a] + np.float32(n) * vs)
                 for a, n in enumerate(dims))

    o = (ox_ref[...], oy_ref[...], oz_ref[...])
    d = (dx_ref[...], dy_ref[...], dz_ref[...])
    t_lo = tmin_ref[...]
    t_hi = tmax_ref[...]
    fine_off = off_ref[0]
    inv = tuple(1.0 / da for da in d)
    step = tuple(jnp.where(da >= 0, 1, -1).astype(jnp.int32) for da in d)
    # index offset of the exit plane along each axis (0 when d < 0)
    fwd = tuple((da >= 0).astype(jnp.int32) for da in d)

    def plane_t(a, idx):
        """t at which the ray crosses cell plane `idx` of axis a."""
        t = (og[a] + idx.astype(jnp.float32) * vs - o[a]) * inv[a]
        return jnp.where(d[a] == 0.0, _INF, t)

    # grid entry: the trace_grid_dda init expressions, with the start
    # moved forward to t_min (cells wholly before it fail the accept)
    tn, tf = [], []
    for a in range(3):
        tb = inv[a] * (og[a] - o[a])
        tt = inv[a] * (gmax[a] - o[a])
        tn.append(jnp.minimum(tb, tt))
        tf.append(jnp.maximum(tb, tt))
    t_enter = jnp.maximum(jnp.maximum(tn[0], tn[1]), tn[2])
    t_exit = jnp.minimum(jnp.minimum(tf[0], tf[1]), tf[2])
    t_start = jnp.maximum(jnp.maximum(t_enter, 0.0), t_lo) + np.float32(1e-7)
    alive = (t_exit > jnp.maximum(t_enter, 0.0)) & (t_lo <= t_hi)
    cell = tuple(
        jnp.clip(jnp.floor((o[a] + d[a] * t_start - og[a]) / vs)
                 .astype(jnp.int32), 0, dims[a] - 1)
        for a in range(3))

    def bit(ref, word_idx, bit_idx, mask):
        word = plgpu.load(ref.at[jnp.where(mask, word_idx, 0)], mask=mask,
                          other=0)
        return mask & (((word >> bit_idx.astype(jnp.uint32)) & 1) != 0)

    def body(state):
        it, cx, cy, cz, act_i, best_lin = state
        c = (cx, cy, cz)
        act = act_i != 0
        sb = (cx >> 6) + sbx * ((cy >> 6) + sby * (cz >> 6))
        sb_occ = bit(l2_ref, sb >> 5, sb & 31, act)
        br = (cx >> 3) + bx * ((cy >> 3) + by * (cz >> 3))
        br_occ = bit(coarse_ref, br >> 5, br & 31, sb_occ)
        loc = (cx & 7) + BRICK * ((cy & 7) + BRICK * (cz & 7))
        cell_occ = bit(fine_ref, (br - fine_off) * 16 + (loc >> 5), loc & 31,
                       br_occ)

        # reference cell AABB slab test (raytrace.rint:46-56)
        t0 = t1 = None
        for a in range(3):
            cc = og[a] + (c[a].astype(jnp.float32) + 0.5) * vs
            tb = inv[a] * ((cc - half) - o[a])
            tt = inv[a] * ((cc + half) - o[a])
            lo, hi = jnp.minimum(tb, tt), jnp.maximum(tb, tt)
            t0 = lo if t0 is None else jnp.maximum(t0, lo)
            t1 = hi if t1 is None else jnp.minimum(t1, hi)
        hit = (cell_occ & (t1 > jnp.maximum(t0, 0.0)) & (t0 > 0.0)
               & (t0 >= t_lo) & (t0 <= t_hi))
        best_lin = jnp.where(hit, cx + nx * (cy + ny * cz), best_lin)
        act = act & ~hit

        # land one cell short of the exit of the empty box (log2 size k;
        # k = 0 is the cell itself, where the landing is the identity)
        k = jnp.where(sb_occ, jnp.where(br_occ, 0, 3), 6)
        box = tuple((ca >> k) << k for ca in c)
        size = 1 << k
        t_box = plane_t(0, box[0] + fwd[0] * size)
        for a in (1, 2):
            t_box = jnp.minimum(t_box, plane_t(a, box[a] + fwd[a] * size))
        land = []
        for a in range(3):
            la = jnp.floor((o[a] + d[a] * t_box - og[a]) * inv_vs) \
                .astype(jnp.int32) - step[a]
            la = jnp.clip(la, box[a], box[a] + size - 1)
            land.append(jnp.where(step[a] > 0, jnp.maximum(la, c[a]),
                                  jnp.minimum(la, c[a])))

        # one exact cell step
        tx, ty, tz = (plane_t(a, land[a] + fwd[a]) for a in range(3))
        t_cross = jnp.minimum(tx, jnp.minimum(ty, tz))
        st_x = tx == t_cross
        st_y = ~st_x & (ty == t_cross)
        st_z = ~(st_x | st_y)
        cx = land[0] + jnp.where(st_x, step[0], 0)
        cy = land[1] + jnp.where(st_y, step[1], 0)
        cz = land[2] + jnp.where(st_z, step[2], 0)
        inb = ((cx >= 0) & (cx < nx) & (cy >= 0) & (cy < ny)
               & (cz >= 0) & (cz < nz))
        act = act & inb & (t_cross <= t_hi)
        return (it + 1, cx, cy, cz, act.astype(jnp.int32), best_lin)

    def cond(state):
        # jnp.any has no Triton lowering; max over int32 lanes does
        return (state[0] < max_iters) & (jnp.max(state[4]) != 0)

    init = (jnp.int32(0), *cell, alive.astype(jnp.int32),
            jnp.full(t_hi.shape, -1, jnp.int32))
    _, _, _, _, act_i, best_lin = jax.lax.while_loop(cond, body, init)
    lin_ref[...] = jnp.where(act_i != 0, -2, best_lin)


def brick_dda(ox, oy, oz, dx, dy, dz, t_min, t_max, fine_off, l2, coarse,
              fine, *, dims, bdims, origin, voxel_size, interpret):
    """Linear id of the nearest accepted cell per ray.

    Ray arrays are (N,) float32; t_min/t_max are (N,) (t_min > t_max
    retires a ray at once); fine_off is the int32 first brick of the
    `fine` table (nonzero for a Z-slab accel); l2/coarse are flat uint32
    bit words, fine is (NB, 16) uint32.  Returns lin (N,) int32: -1 on a
    miss, -2 for a ray still walking at the iteration bound.
    """
    n = ox.shape[0]
    n_pad = -(-max(n, 1) // BLOCK) * BLOCK

    def pad(x, fill):
        return jnp.pad(x, (0, n_pad - n), constant_values=fill)

    rays = [pad(ox, 0.0), pad(oy, 0.0), pad(oz, 0.0),
            pad(dx, 1.0), pad(dy, 1.0), pad(dz, 1.0),
            pad(t_min, 1.0), pad(t_max, -1.0)]
    tables = [jnp.reshape(fine_off, (1,)).astype(jnp.int32), l2, coarse,
              fine.reshape(-1)]
    ray_spec = pl.BlockSpec((BLOCK,), lambda i: (i,))
    whole = [pl.BlockSpec(tab.shape, lambda i: (0,)) for tab in tables]
    kernel = functools.partial(
        _kernel, dims=dims, bdims=bdims, origin=origin,
        voxel_size=voxel_size, max_iters=sum(dims) + 3)
    lin = pl.pallas_call(
        kernel,
        grid=(n_pad // BLOCK,),
        in_specs=[ray_spec] * 8 + whole,
        out_specs=ray_spec,
        out_shape=jax.ShapeDtypeStruct((n_pad,), jnp.int32),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name="brick_dda",
    )(*rays, *tables)
    return lin[:n]
