"""Brick-accelerated grid traversal: the production voxel trace.

The acceleration structure (BrickAccel) is built once per grid: the
occupancy grouped into 8^3-cell bricks, with a bitmask over superbricks
of 8^3 bricks (l2), a bitmask over bricks (coarse) and each brick's 512
cell bits (fine, brick-major).  trace_grid_fast walks it with the
brick_dda kernel (ops/pallas/brick_dda.py) and returns the same
(t, cell_lin) contract, and the same hits, as ops.traverse.trace_grid_dda.

A Z-slab accel (build_accel_slab) keeps the full grid's coordinates and
bitmasks but only its own slab's fine words: the Z-slab-sharded render
(parallel/comm.py) runs the same kernel against it.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from .intersect import TMAX, TMIN
from .pallas.brick_dda import brick_dda, use_interpreter
from .traverse import _dda_final_t

__all__ = ["BrickAccel", "build_accel", "build_accel_slab",
           "trace_grid_fast", "any_hit_grid_fast"]

BRICK = 8


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class BrickAccel:
    coarse: Any                     # uint32[ceil(NB/32)] brick bitmask
    fine: Any                       # uint32[NBs, 16] cell bits per brick
    l2: Any                         # uint32[ceil(NS/32)] superbrick bitmask
    origin: Any                     # float32[3]
    dims: tuple = field(metadata=dict(static=True))     # voxel dims X,Y,Z
    bdims: tuple = field(metadata=dict(static=True))    # brick dims
    voxel_size: float = field(metadata=dict(static=True))
    origin_key: tuple = field(metadata=dict(static=True))
    # first brick (x + bx*(y + by*z) order) of `fine`: 0 for a whole-grid
    # accel; a Z-slab is a contiguous brick block, so a slab accel stores
    # only its own fine rows.  Traced, so every device of a shard_map runs
    # one program with its own offset.
    fine_off: Any = 0


def _pack_bits(bits):
    """bool (..., 32k) -> uint32 (..., k), bit i of word w = element 32w+i."""
    words = bits.astype(jnp.uint32).reshape(bits.shape[:-1] + (-1, 32))
    return (words << jnp.arange(32, dtype=jnp.uint32)).sum(
        axis=-1, dtype=jnp.uint32)


def _pack_flat(bits):
    """bool (n,) -> uint32 (ceil(n/32),)."""
    return _pack_bits(jnp.pad(bits, (0, -bits.shape[0] % 32)))


def build_accel(occ, origin, voxel_size) -> BrickAccel:
    """occ (Z, Y, X) uint8 -> BrickAccel (device arrays)."""
    occ = jnp.asarray(occ)
    return build_accel_slab(occ, 0, occ.shape[0], origin, voxel_size)


def build_accel_slab(occ_slab, z0, full_nz, origin, voxel_size) \
        -> BrickAccel:
    """BrickAccel for a Z-slab of a larger grid.

    occ_slab: (nzs, ny, nx) uint8 — global z rows [z0, z0 + nzs), z0 a
    multiple of 8.  dims/bdims/origin are the FULL grid's, so every
    coordinate expression stays global and bit-identical to the whole
    grid's accel; the bitmasks are full-size but hold bits only in the
    slab, and `fine` holds only the slab's bricks (from fine_off on).
    The walk never enters a brick outside the slab, so a trace against
    this accel is the whole-grid trace restricted to the slab's cells —
    the per-slab query the Z-slab render merges with pmin.
    """
    assert z0 % BRICK == 0, "slab boundaries must be brick-aligned"
    occ_slab = jnp.asarray(occ_slab)
    nzs, ny, nx = occ_slab.shape
    bx, by, bz = -(-nx // BRICK), -(-ny // BRICK), -(-full_nz // BRICK)
    z0b, bzs = z0 // BRICK, -(-nzs // BRICK)
    occp = jnp.pad(occ_slab, ((0, bzs * BRICK - nzs), (0, by * BRICK - ny),
                              (0, bx * BRICK - nx)))
    # (bzs, 8, by, 8, bx, 8) -> brick-major (bzs, by, bx, 8z, 8y, 8x)
    blocks = occp.reshape(bzs, BRICK, by, BRICK, bx, BRICK) \
        .transpose(0, 2, 4, 1, 3, 5).reshape(bzs, by, bx, -1) > 0
    fine = _pack_bits(blocks).reshape(-1, 16)

    # the last slab may extend past the grid (callers pad the slab
    # height); those bricks are empty by construction
    keep = max(0, min(bzs, bz - z0b))
    sbx, sby, sbz = -(-bx // 8), -(-by // 8), -(-bz // 8)
    bocc = jnp.zeros((sbz * 8, sby * 8, sbx * 8), bool) \
        .at[z0b:z0b + keep, :by, :bx].set(blocks[:keep].any(axis=-1))
    coarse = _pack_flat(bocc[:bz, :by, :bx].reshape(-1))
    socc = bocc.reshape(sbz, 8, sby, 8, sbx, 8).any(axis=(1, 3, 5))
    l2 = _pack_flat(socc.reshape(-1))

    origin = np.asarray(origin, np.float32)
    return BrickAccel(
        coarse=coarse, fine=fine, l2=l2, origin=jnp.asarray(origin),
        dims=(nx, ny, full_nz), bdims=(bx, by, bz),
        voxel_size=float(voxel_size),
        origin_key=tuple(float(c) for c in origin),
        fine_off=jnp.int32(bx * by * z0b),
    )


@functools.partial(jax.jit, static_argnames=("interpret",))
def _trace(o, d, accel, t_min, t_max, *, interpret):
    lin = brick_dda(
        o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2], t_min, t_max,
        accel.fine_off, accel.l2, accel.coarse, accel.fine,
        dims=accel.dims, bdims=accel.bdims, origin=accel.origin_key,
        voxel_size=accel.voxel_size, interpret=interpret)
    unresolved = jnp.sum(lin == -2)
    lin = jnp.maximum(lin, -1)
    # the hit t is evaluated outside the kernel with the dda's own
    # expression, so it matches trace_grid_dda's t for the same cell
    # (the kernel's in-loop t may be contracted into FMAs differently)
    t = _dda_final_t(lin, o, d, accel.origin,
                     jnp.float32(accel.voxel_size), dims=accel.dims)
    return t, lin, unresolved


def trace_grid_fast(origins, dirs, accel: BrickAccel, t_min=TMIN,
                    t_max=TMAX, admit=None, return_stats=False):
    """(t, cell_lin) of the nearest voxel hit; the trace_grid_dda contract.

    t = +inf and cell_lin = -1 on a miss.  t_min/t_max are scalars or
    per-ray arrays of the batch shape; admit (optional bool, batch shape)
    traces only the admitted rays, the rest miss.  return_stats=True
    also returns `unresolved`, the count of rays still walking at the
    kernel's iteration bound (0 means the result is exhaustive).
    """
    batch_shape = origins.shape[:-1]

    def per_ray(x):
        return jnp.broadcast_to(jnp.asarray(x, jnp.float32),
                                batch_shape).reshape(-1)

    t_lo, t_hi = per_ray(t_min), per_ray(t_max)
    if admit is not None:
        t_hi = jnp.where(admit.reshape(-1), t_hi, -jnp.inf)
    t, lin, unresolved = _trace(
        origins.reshape(-1, 3), dirs.reshape(-1, 3), accel, t_lo, t_hi,
        interpret=use_interpreter())
    out = (t.reshape(batch_shape), lin.reshape(batch_shape))
    return out + (unresolved,) if return_stats else out


def any_hit_grid_fast(origins, dirs, accel: BrickAccel, t_min=TMIN,
                      t_max=TMAX, admit=None):
    """True where some voxel accepts along the ray (the shadow query):
    the nearest trace, whose lanes retire at their first accepted cell."""
    t, _ = trace_grid_fast(origins, dirs, accel, t_min=t_min, t_max=t_max,
                           admit=admit)
    return jnp.isfinite(t)
