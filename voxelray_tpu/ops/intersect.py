"""Ray intersection primitives: camera ray generation, slab test,
Moller-Trumbore triangles.

  make_camera_rays — the raygen reconstruction from inverse matrices
                     (raytrace.rgen:41-47)
  hit_aabb         — branchless slab test, hit iff t1 > max(t0, 0),
                     reporting t0 (raytrace.rint:46-56); the renderer
                     additionally requires tMin <= t0 <= tMax like the
                     hardware interval clamp
  hit_triangle     — Moller-Trumbore with barycentrics, the software
                     equivalent of the driver's triangle intersector
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["make_camera_rays", "hit_aabb", "hit_triangles", "TMIN", "TMAX"]

TMIN = np.float32(0.001)    # raytrace.rgen:50
TMAX = np.float32(10000.0)  # raytrace.rgen:51


def make_camera_rays(width: int, height: int, view_inv, proj_inv):
    """Per-pixel rays: origins (H, W, 3), directions (H, W, 3).

    Pixel (0, 0) is the top-left launch id; the Y-flipped projection
    makes +d.y point down exactly as in the Vulkan render.  The products
    are pinned to full float32 precision (a GPU may otherwise run them
    in TF32, moving directions by ~1e-3 relative).
    """
    view_inv = jnp.asarray(view_inv, jnp.float32)
    proj_inv = jnp.asarray(proj_inv, jnp.float32)
    px = (jnp.arange(width, dtype=jnp.float32) + 0.5) / width * 2.0 - 1.0
    py = (jnp.arange(height, dtype=jnp.float32) + 0.5) / height * 2.0 - 1.0
    dx, dy = jnp.meshgrid(px, py)  # (H, W)
    d = jnp.stack([dx, dy, jnp.ones_like(dx), jnp.ones_like(dx)], axis=-1)
    hi = jax.lax.Precision.HIGHEST
    target = jnp.einsum("ij,hwj->hwi", proj_inv, d, precision=hi)
    tn = target[..., :3]
    tn = tn / jnp.linalg.norm(tn, axis=-1, keepdims=True)
    direction = jnp.einsum("ij,hwj->hwi", view_inv[:3, :3], tn,
                           precision=hi)
    origin = view_inv[:3, 3]
    origins = jnp.broadcast_to(origin, direction.shape)
    return origins, direction


def hit_aabb(aabb_min, aabb_max, origin, direction):
    """Slab test; returns t0 where hit, else -1.0 (raytrace.rint:46-56).

    Shapes broadcast; the caller applies the ray-interval clamp.
    """
    inv_dir = 1.0 / direction
    tbot = inv_dir * (aabb_min - origin)
    ttop = inv_dir * (aabb_max - origin)
    tmin = jnp.minimum(ttop, tbot)
    tmax = jnp.maximum(ttop, tbot)
    t0 = jnp.maximum(tmin[..., 0], jnp.maximum(tmin[..., 1], tmin[..., 2]))
    t1 = jnp.minimum(tmax[..., 0], jnp.minimum(tmax[..., 1], tmax[..., 2]))
    return jnp.where(t1 > jnp.maximum(t0, 0.0), t0, -1.0)


def hit_triangles(origin, direction, v0, v1, v2, t_min=TMIN, t_max=TMAX):
    """Moller-Trumbore; returns (t, u, v) with t = inf on miss.

    origin/direction: (..., 3); v0/v1/v2: (..., 3) broadcastable.
    Backface culling off (the reference builds its BLAS without culling
    flags); degenerate triangles miss.
    """
    eps = jnp.float32(1e-8)
    e1 = v1 - v0
    e2 = v2 - v0
    p = jnp.cross(direction, e2)
    det = (e1 * p).sum(-1)
    ok = jnp.abs(det) > eps
    inv_det = jnp.where(ok, 1.0 / jnp.where(ok, det, 1.0), 0.0)
    s = origin - v0
    u = (s * p).sum(-1) * inv_det
    q = jnp.cross(s, e1)
    v = (direction * q).sum(-1) * inv_det
    t = (e2 * q).sum(-1) * inv_det
    hit = ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) \
        & (t > t_min) & (t < t_max)
    return jnp.where(hit, t, jnp.inf), u, v
