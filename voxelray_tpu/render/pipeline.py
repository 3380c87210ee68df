"""The render pipeline: one jitted camera-to-framebuffer function.

Replaces the reference's whole RT pipeline + SBT machinery
(hello_vulkan.cpp:798-1025, raytrace at :1030-1050): shader-group dispatch
becomes branch-free select between the two closest-hit programs; the
recursion-depth-2 camera+shadow ray pair becomes two traversal passes.

Per-pixel contract reproduced end to end:

  raygen (raytrace.rgen:39-67)
    -> nearest hit over { triangle BLAS, voxel AABB BLAS }
    -> triangle CH (raytrace.rchit): interpolated normal, texture-modulated
       diffuse, attenuation 1 -> shadow ray if dot(N,L)>0 -> 0.3 if
       shadowed else specular
    -> voxel CH (raytrace2.rchit): dominant-axis cube normal, attenuation
       0.3 default -> shadow ray if dot(N,L)>0 -> 1 + specular if unshadowed
    -> miss: clearColor * 0.8 (raytrace.rmiss:37)
  post: pow(rgba, 1/2.2) (post.frag:35-36)

Camera matrices and light state are traced arguments: per-frame updates
never recompile and never touch the host inside render (the
"zero host round-trips" requirement, SURVEY.md section 2.4).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..models.scene import Light, Scene
from ..ops.intersect import TMAX, TMIN, make_camera_rays
from ..ops.traverse import (any_hit_aabbs_brute, any_hit_grid_dda,
                            any_hit_triangles_brute, trace_aabbs_brute,
                            trace_grid_dda, trace_triangles_brute)
from . import shading
from .camera import Camera

__all__ = ["render_rays", "render_image", "render_scene", "render_aov"]


def _sample_texture(textures, tex_meta, layer, uv, lod=None):
    """Bilinear/trilinear sample with repeat addressing; layer -1 -> white.

    textures is the (T, TH, TWA, 3) mip-atlas stack, tex_meta the
    (T, LMAX, 4) per-level (y0, x0, h, w) placements (models/scene.py) —
    every texture samples with its OWN dims, so mixed-size stacks are
    correct.  lod=None samples the base level (the reference's ray-traced
    path: implicit-lod texture() in a closest-hit stage reads level 0);
    a float lod array gives trilinear filtering across the mip chain
    (the raster path's sampler, maxLod = FLT_MAX).
    """
    t = textures.shape[0]
    lmax = tex_meta.shape[1]
    layer_c = jnp.clip(layer, 0, t - 1)
    # wrap to [0,1) in float once — avoids integer mod by traced dims
    # (pathologically slow lowering, CLAUDE.md #6)
    uvw = uv - jnp.floor(uv)

    def level_sample(lv):
        meta = tex_meta[layer_c, lv]                       # (..., 4)
        y0 = meta[..., 0]
        x0 = meta[..., 1]
        hh = meta[..., 2]
        ww = meta[..., 3]
        u = uvw[..., 0] * ww.astype(jnp.float32) - 0.5
        v = uvw[..., 1] * hh.astype(jnp.float32) - 0.5
        xf = jnp.floor(u)
        yf = jnp.floor(v)
        fu = (u - xf)[..., None]
        fv = (v - yf)[..., None]
        xi = xf.astype(jnp.int32)
        yi = yf.astype(jnp.int32)

        def fetch(xa, ya):
            # u in [-0.5, w-0.5) -> xi in [-1, w-1], xi+1 in [0, w]:
            # only the two edge cases need wrapping
            xa = jnp.where(xa < 0, ww - 1, jnp.where(xa >= ww, 0, xa))
            ya = jnp.where(ya < 0, hh - 1, jnp.where(ya >= hh, 0, ya))
            return textures[layer_c, ya + y0, xa + x0]

        return (fetch(xi, yi) * (1 - fu) * (1 - fv)
                + fetch(xi + 1, yi) * fu * (1 - fv)
                + fetch(xi, yi + 1) * (1 - fu) * fv
                + fetch(xi + 1, yi + 1) * fu * fv)

    if lod is None:
        c = level_sample(jnp.zeros(uv.shape[:-1], jnp.int32))
    else:
        lod = jnp.clip(lod, 0.0, jnp.float32(lmax - 1))
        l0 = jnp.floor(lod).astype(jnp.int32)
        l1 = jnp.minimum(l0 + 1, lmax - 1)
        fl = (lod - l0.astype(jnp.float32))[..., None]
        c = level_sample(l0) * (1 - fl) + level_sample(l1) * fl
    return jnp.where((layer >= 0)[..., None], c, 1.0)


def _trace_triangles(scene: Scene, origins, dirs, t_min, t_max):
    """Nearest triangle hit: tri-grid march when the scene carries a
    triangle acceleration structure (the reference's triangle BLAS,
    hello_vulkan.cpp:596-635), chunked brute otherwise."""
    if scene.tri_accel is not None:
        from ..ops.tri_accel import trace_triangles_grid
        return trace_triangles_grid(origins, dirs, scene.tri_accel,
                                    t_min=t_min, t_max=t_max)
    return trace_triangles_brute(origins, dirs, scene.tri_v0,
                                 scene.tri_v1, scene.tri_v2,
                                 t_min=t_min, t_max=t_max)


def _trace_voxels(scene: Scene, origins, dirs, t_min, t_max, backend):
    if backend == "octree" and scene.octree is not None:
        from ..ops.octree_traverse import trace_octree
        return trace_octree(origins, dirs, scene.octree,
                            t_min=t_min, t_max=t_max)
    if backend == "fast" and scene.accel is not None:
        from ..ops.traverse_fast import trace_grid_fast
        return trace_grid_fast(origins, dirs, scene.accel,
                               t_min=t_min, t_max=t_max)
    if backend == "dda" and scene.occ_flat.shape[0] > 0:
        t, lin = trace_grid_dda(
            origins, dirs, scene.occ_flat, scene.grid_origin,
            dims=scene.grid_dims, voxel_size_static=scene.grid_voxel_size,
            t_min=t_min, t_max=t_max)
        return t, lin
    t, pid = trace_aabbs_brute(origins, dirs, scene.voxel_aabbs,
                               t_min=t_min, t_max=t_max)
    return t, pid


def _voxel_center_of_hit(scene: Scene, hit_id, backend):
    """Cell center for the hit primitive (the (min+max)/2 the voxel CH
    computes, raytrace2.rchit:57-60)."""
    if backend in ("dda", "fast", "octree") and scene.occ_flat.shape[0] > 0:
        nx, ny, _ = scene.grid_dims
        lin = jnp.maximum(hit_id, 0)
        x = lin % nx
        y = (lin // nx) % ny
        z = lin // (nx * ny)
        vs = jnp.float32(scene.grid_voxel_size)
        idx = jnp.stack([x, y, z], axis=-1).astype(jnp.float32)
        return scene.grid_origin + (idx + 0.5) * vs
    box = scene.voxel_aabbs[jnp.maximum(hit_id, 0)]
    return (box[..., 0:3] + box[..., 3:6]) * 0.5


def _any_hit(scene: Scene, origins, dirs, t_min, t_max, backend,
             admit=None):
    occluded = jnp.zeros(origins.shape[:-1], bool)
    if scene.n_triangles:
        if scene.tri_accel is not None:
            from ..ops.tri_accel import any_hit_triangles_grid
            occluded |= any_hit_triangles_grid(
                origins, dirs, scene.tri_accel, t_min=t_min, t_max=t_max)
        else:
            occluded |= any_hit_triangles_brute(
                origins, dirs, scene.tri_v0, scene.tri_v1, scene.tri_v2,
                t_min=t_min, t_max=t_max)
    if backend == "octree" and scene.octree is not None:
        from ..ops.octree_traverse import any_hit_octree
        occluded |= any_hit_octree(origins, dirs, scene.octree,
                                   t_min=t_min, t_max=t_max)
    elif backend == "fast" and scene.accel is not None:
        from ..ops.traverse_fast import any_hit_grid_fast
        occluded |= any_hit_grid_fast(origins, dirs, scene.accel,
                                      t_min=t_min, t_max=t_max, admit=admit)
    elif backend == "dda" and scene.occ_flat.shape[0] > 0:
        occluded |= any_hit_grid_dda(
            origins, dirs, scene.occ_flat, scene.grid_origin,
            dims=scene.grid_dims, voxel_size_static=scene.grid_voxel_size,
            t_min=t_min, t_max=t_max)
    elif scene.n_voxels:
        occluded |= any_hit_aabbs_brute(origins, dirs, scene.voxel_aabbs,
                                        t_min=t_min, t_max=t_max)
    return occluded


def render_rays(scene: Scene, origins, dirs, light_position,
                light_intensity, light_type, clear_color, *,
                backend="dda", t_min=TMIN, t_max=TMAX, shadows=True,
                trace_voxels_fn=None, any_hit_fn=None):
    """Trace + shade a ray batch; returns linear-space RGB (..., 3).

    trace_voxels_fn / any_hit_fn: optional overrides for the voxel
    nearest-hit and occlusion queries — the Z-slab-sharded grid path
    (parallel/comm.py render_zslab_sharded) injects per-device slab
    traversals + collectives here so the SHADING stays this exact code
    (no drift between the replicated and sharded pipelines).
    trace_voxels_fn(origins, dirs, t_min, t_max) -> (t, cell_lin);
    any_hit_fn(origins, dirs, t_min, t_max) -> bool occluded.
    """
    # ---- closest hit over both geometry kinds --------------------------
    if scene.n_triangles:
        t_tri, tri_id, bu, bv = _trace_triangles(scene, origins, dirs,
                                                 t_min, t_max)
    else:
        t_tri = jnp.full(origins.shape[:-1], jnp.inf, jnp.float32)
        tri_id = jnp.full(origins.shape[:-1], -1, jnp.int32)
        bu = bv = jnp.zeros(origins.shape[:-1], jnp.float32)
    if trace_voxels_fn is not None:
        t_vox, vox_id = trace_voxels_fn(origins, dirs, t_min, t_max)
    else:
        t_vox, vox_id = _trace_voxels(scene, origins, dirs, t_min, t_max,
                                      backend)

    vox_hit = jnp.isfinite(t_vox) & (t_vox < t_tri)
    tri_hit = jnp.isfinite(t_tri) & ~vox_hit
    any_hit = vox_hit | tri_hit
    t_hit = jnp.where(vox_hit, t_vox, t_tri)
    t_hit_safe = jnp.where(any_hit, t_hit, 1.0)
    world_pos = origins + dirs * t_hit_safe[..., None]

    # ---- normals -------------------------------------------------------
    tid = jnp.maximum(tri_id, 0)
    w = (1.0 - bu - bv)[..., None]
    if scene.n_triangles:
        n_tri = (scene.tri_n0[tid] * w + scene.tri_n1[tid] * bu[..., None]
                 + scene.tri_n2[tid] * bv[..., None])
        n_tri = n_tri / jnp.maximum(
            jnp.linalg.norm(n_tri, axis=-1, keepdims=True), 1e-20)
    else:
        n_tri = jnp.zeros(world_pos.shape, jnp.float32)
    if scene.n_voxels or scene.occ_flat.shape[0]:
        center = _voxel_center_of_hit(scene, vox_id, backend)
        n_vox = shading.cube_normal(world_pos, center)
    else:
        n_vox = jnp.zeros(world_pos.shape, jnp.float32)
    normal = jnp.where(vox_hit[..., None], n_vox, n_tri)

    # ---- materials -----------------------------------------------------
    if scene.n_triangles:
        mat_tri = scene.materials[scene.tri_mat[tid]]
    else:
        mat_tri = jnp.broadcast_to(
            scene.voxel_material, world_pos.shape[:-1] + (20,))
    mat = jnp.where(vox_hit[..., None], scene.voxel_material, mat_tri)

    # ---- light ---------------------------------------------------------
    l_vec, intensity, light_dist = shading.light_terms(
        world_pos, light_position, light_intensity, light_type)

    diffuse = shading.compute_diffuse(mat, l_vec, normal)
    if scene.n_triangles:
        uv = (scene.tri_uv0[tid] * w + scene.tri_uv1[tid] * bu[..., None]
              + scene.tri_uv2[tid] * bv[..., None])
        # base-level sample: GLSL texture() in a closest-hit stage has no
        # implicit derivatives, so the reference's RT path reads mip 0
        # (raytrace.rchit:99-105); the raster path uses the full chain
        tex_rgb = _sample_texture(scene.textures, scene.tex_meta,
                                  scene.tri_tex[tid], uv)
        diffuse = jnp.where(tri_hit[..., None], diffuse * tex_rgb, diffuse)

    # ---- shadow ray ----------------------------------------------------
    facing = (normal * l_vec).sum(-1) > 0.0
    if shadows:
        # shadow rays matter only for pixels that hit something facing
        # the light: the fast backend retires the others at once via its
        # admit mask.  Miss pixels' shadow results feed a color the final
        # miss-select discards, so skipping them cannot change the image.
        admit = (any_hit & facing) if backend == "fast" else None
        if any_hit_fn is not None:
            shadowed = any_hit_fn(world_pos, l_vec, TMIN, light_dist)
        else:
            shadowed = _any_hit(scene, world_pos, l_vec, TMIN, light_dist,
                                backend, admit=admit)
        shadowed = jnp.where(facing, shadowed, True)  # traced when facing
    else:
        # shadows disabled: every facing surface counts as lit
        shadowed = ~facing

    specular = shading.compute_specular(mat, dirs, l_vec, normal)
    lit = facing & ~shadowed
    # triangle CH: attenuation 1 unless (facing and shadowed) -> 0.3
    att_tri = jnp.where(facing & shadowed, 0.3, 1.0)
    # voxel CH: attenuation 0.3 unless (facing and unshadowed) -> 1
    att_vox = jnp.where(lit, 1.0, 0.3)
    attenuation = jnp.where(vox_hit, att_vox, att_tri)
    specular = jnp.where(lit[..., None], specular, 0.0)

    color = intensity[..., None] * attenuation[..., None] \
        * (diffuse + specular)
    miss = shading.miss_color(clear_color)
    return jnp.where(any_hit[..., None], color, miss)


@functools.partial(
    jax.jit,
    static_argnames=("scene_static", "width", "height", "backend",
                     "shadows"),
)
def _render_jit(scene, view_inv, proj_inv, light_position, light_intensity,
                light_type, clear_color, *, scene_static, width, height,
                backend, shadows):
    # rays stay in raster order: a warp of the brick_dda kernel walks 32
    # neighbouring pixels of one row (an (8, 128)-tile order measured no
    # faster on an H100: 1.98 vs 1.92 ms best per 1080p primary trace)
    origins, dirs = make_camera_rays(width, height, view_inv, proj_inv)
    rgb = render_rays(scene, origins, dirs, light_position, light_intensity,
                      light_type, clear_color, backend=backend,
                      shadows=shadows)
    rgba = jnp.concatenate([rgb, jnp.ones(rgb.shape[:-1] + (1,),
                                          jnp.float32)], axis=-1)
    return shading.gamma_post(rgba)


def render_image(scene: Scene, view_inv, proj_inv, *, width, height,
                 light: Light = Light(), clear_color=(1.0, 1.0, 1.0, 1.0),
                 backend="dda", shadows=True):
    """Framebuffer (H, W, 4) float32, gamma-corrected."""
    return _render_jit(
        scene, jnp.asarray(view_inv), jnp.asarray(proj_inv),
        jnp.asarray(light.position, jnp.float32),
        jnp.float32(light.intensity), jnp.int32(light.type),
        jnp.asarray(clear_color, jnp.float32),
        scene_static=(scene.grid_dims, scene.grid_voxel_size),
        width=width, height=height, backend=backend, shadows=shadows,
    )


def render_scene(scene: Scene, camera: Camera = Camera(), *, width=1280,
                 height=720, light: Light = Light(),
                 clear_color=(1.0, 1.0, 1.0, 1.0), backend="dda",
                 shadows=True):
    """Convenience wrapper: camera dataclass in, image out (the main.cpp
    frame loop without the window)."""
    _, _, view_inv, proj_inv = camera.matrices(width, height)
    return render_image(scene, view_inv, proj_inv, width=width,
                        height=height, light=light,
                        clear_color=clear_color, backend=backend,
                        shadows=shadows)


@functools.partial(jax.jit,
                   static_argnames=("width", "height", "backend"))
def _aov_jit(scene, view_inv, proj_inv, *, width, height, backend):
    origins, dirs = make_camera_rays(width, height, view_inv, proj_inv)
    if scene.n_triangles:
        t_tri, tri_id, bu, bv = _trace_triangles(scene, origins, dirs,
                                                 TMIN, TMAX)
    else:
        t_tri = jnp.full(origins.shape[:-1], jnp.inf, jnp.float32)
        tri_id = jnp.full(origins.shape[:-1], -1, jnp.int32)
        bu = bv = jnp.zeros(origins.shape[:-1], jnp.float32)
    t_vox, vox_id = _trace_voxels(scene, origins, dirs, TMIN, TMAX, backend)
    vox_hit = jnp.isfinite(t_vox) & (t_vox < t_tri)
    tri_hit = jnp.isfinite(t_tri) & ~vox_hit
    any_hit = vox_hit | tri_hit
    t_hit = jnp.where(vox_hit, t_vox, t_tri)
    world_pos = origins + dirs * jnp.where(any_hit, t_hit, 1.0)[..., None]
    tid = jnp.maximum(tri_id, 0)
    w = (1.0 - bu - bv)[..., None]
    if scene.n_triangles:
        n_tri = (scene.tri_n0[tid] * w + scene.tri_n1[tid] * bu[..., None]
                 + scene.tri_n2[tid] * bv[..., None])
        n_tri = n_tri / jnp.maximum(
            jnp.linalg.norm(n_tri, axis=-1, keepdims=True), 1e-20)
    else:
        n_tri = jnp.zeros(world_pos.shape, jnp.float32)
    if scene.occ_flat.shape[0] or scene.n_voxels:
        center = _voxel_center_of_hit(scene, vox_id, backend)
        n_vox = shading.cube_normal(world_pos, center)
    else:
        n_vox = jnp.zeros(world_pos.shape, jnp.float32)
    normal = jnp.where(vox_hit[..., None], n_vox, n_tri)
    normal = jnp.where(any_hit[..., None], normal, 0.0)
    depth = jnp.where(any_hit, t_hit, jnp.inf)
    return depth, normal, any_hit


def render_aov(scene: Scene, camera: Camera = Camera(), *, width=1280,
               height=720, backend="dda"):
    """Depth + normal + hit-mask buffers (the BASELINE config-3 output:
    hit distance and surface normal per pixel, no shading)."""
    _, _, view_inv, proj_inv = camera.matrices(width, height)
    return _aov_jit(scene, jnp.asarray(view_inv), jnp.asarray(proj_inv),
                    width=width, height=height, backend=backend)
