"""Software rasterizer — the classic-pipeline fallback.

The reference can toggle from ray tracing to a raster pipeline
(main.cpp:241-247): vertex transform by viewProj (vert_shader.vert:56-66)
then per-pixel Lambert + specular with the same material model but NO
shadow rays (frag_shader.frag:56-99).  Only OBJ instances are drawn — the
implicit AABB instance is excluded (hello_vulkan.cpp:417-428), so voxels
don't appear in raster mode; same here.

Implementation: perspective-correct barycentric coverage over pixel tiles
with a z-buffer (depth in Vulkan ZO [0,1], less-than test), vectorized
over (pixels x triangle-chunks) with a lax.scan min-reduce.  Background is
the clear color (the render-pass clear), and the shared gamma post pass
applies on top (post.frag) — note: no 0.8 dimming, that's the ray miss
shader only.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..models.scene import Light, Scene
from . import shading
from .camera import Camera

__all__ = ["rasterize_image", "rasterize_scene"]


def _project(view, proj, pos):
    """World -> clip -> ndc + clip w."""
    hi = jax.lax.Precision.HIGHEST
    vp = jnp.matmul(proj, view, precision=hi)
    ph = jnp.concatenate([pos, jnp.ones(pos.shape[:-1] + (1,),
                                        jnp.float32)], axis=-1)
    clip = jnp.einsum("ij,nj->ni", vp, ph, precision=hi)
    w = clip[..., 3:4]
    ndc = clip[..., :3] / jnp.where(jnp.abs(w) > 1e-20, w, 1e-20)
    return ndc, w[..., 0]


@functools.partial(jax.jit, static_argnames=("width", "height", "chunk"))
def rasterize_image(scene: Scene, view, proj, eye, light_position,
                    light_intensity, light_type, clear_color, *,
                    width, height, chunk=64):
    """(H, W, 4) float32 framebuffer, gamma applied."""
    n = scene.n_triangles
    view = jnp.asarray(view, jnp.float32)
    proj = jnp.asarray(proj, jnp.float32)

    # pixel centers
    px = jnp.arange(width, dtype=jnp.float32) + 0.5
    py = jnp.arange(height, dtype=jnp.float32) + 0.5
    sx, sy = jnp.meshgrid(px, py)  # (H, W)

    bg = jnp.asarray(clear_color, jnp.float32)[:3]
    frame = jnp.broadcast_to(bg, (height, width, 3))
    zbuf = jnp.ones((height, width), jnp.float32)

    if n == 0:
        rgba = jnp.concatenate(
            [frame, jnp.ones((height, width, 1), jnp.float32)], axis=-1)
        return shading.gamma_post(rgba)

    ndc0, w0 = _project(view, proj, scene.tri_v0)
    ndc1, w1 = _project(view, proj, scene.tri_v1)
    ndc2, w2 = _project(view, proj, scene.tri_v2)

    def to_screen(ndc):
        return jnp.stack([(ndc[..., 0] + 1.0) * 0.5 * width,
                          (ndc[..., 1] + 1.0) * 0.5 * height], axis=-1)

    s0, s1, s2 = to_screen(ndc0), to_screen(ndc1), to_screen(ndc2)

    n_chunks = -(-n // chunk)
    pad = n_chunks * chunk - n

    def pad_to(x, fill=0.0):
        cfg = [(0, pad)] + [(0, 0)] * (x.ndim - 1)
        return jnp.pad(x, cfg, constant_values=fill)

    data = dict(
        s0=pad_to(s0), s1=pad_to(s1), s2=pad_to(s2),
        z0=pad_to(ndc0[:, 2], 2.0), z1=pad_to(ndc1[:, 2], 2.0),
        z2=pad_to(ndc2[:, 2], 2.0),
        w0=pad_to(w0, -1.0), w1=pad_to(w1, -1.0), w2=pad_to(w2, -1.0),
        p0=pad_to(scene.tri_v0), p1=pad_to(scene.tri_v1),
        p2=pad_to(scene.tri_v2),
        n0=pad_to(scene.tri_n0), n1=pad_to(scene.tri_n1),
        n2=pad_to(scene.tri_n2),
        t0=pad_to(scene.tri_uv0), t1=pad_to(scene.tri_uv1),
        t2=pad_to(scene.tri_uv2),
        mat=pad_to(scene.tri_mat), tex=pad_to(scene.tri_tex, -1),
        lod=pad_to(scene.tri_lod),
    )
    data = {k: v.reshape((n_chunks, chunk) + v.shape[1:])
            for k, v in data.items()}

    def edge(a, b, x, y):
        return ((x - a[..., 0]) * (b[..., 1] - a[..., 1])
                - (y - a[..., 1]) * (b[..., 0] - a[..., 0]))

    def body(carry, tri):
        frame, zbuf = carry
        a, b, c = tri["s0"], tri["s1"], tri["s2"]  # (chunk, 2)
        x = sx[..., None]  # (H, W, 1)
        y = sy[..., None]
        e0 = edge(a, b, x, y)
        e1 = edge(b, c, x, y)
        e2 = edge(c, a, x, y)
        area = edge(a, b, c[..., 0], c[..., 1])  # (chunk,)
        # inside if all edges same sign as area (no culling)
        sgn = jnp.sign(area)
        inside = (e0 * sgn >= 0) & (e1 * sgn >= 0) & (e2 * sgn >= 0) \
            & (jnp.abs(area) > 1e-12)
        # barycentric (screen-space)
        inv_area = 1.0 / jnp.where(jnp.abs(area) > 1e-12, area, 1.0)
        l0 = e1 * inv_area
        l1 = e2 * inv_area
        l2 = e0 * inv_area
        # reject triangles crossing the near plane (w <= 0)
        ok_tri = (tri["w0"] > 0) & (tri["w1"] > 0) & (tri["w2"] > 0)
        inside &= ok_tri
        # depth (ndc z, ZO) interpolated linearly in screen space
        z = l0 * tri["z0"] + l1 * tri["z1"] + l2 * tri["z2"]
        inside &= (z >= 0.0) & (z <= 1.0)
        z = jnp.where(inside, z, 2.0)
        best = jnp.argmin(z, axis=-1)  # (H, W)
        take = lambda q: jnp.take_along_axis(q, best[..., None],
                                             axis=-1)[..., 0]
        zb = take(z)
        visible = zb < zbuf

        # perspective-correct attribute interpolation
        t = lambda k: jnp.take_along_axis(
            jnp.broadcast_to(tri[k], z.shape + tri[k].shape[2:])
            if tri[k].ndim > 1 else tri[k], best[..., None], axis=-1)
        bl0, bl1, bl2 = take(l0), take(l1), take(l2)
        iw0 = 1.0 / tri["w0"][best]
        iw1 = 1.0 / tri["w1"][best]
        iw2 = 1.0 / tri["w2"][best]
        pw0 = bl0 * iw0
        pw1 = bl1 * iw1
        pw2 = bl2 * iw2
        norm = pw0 + pw1 + pw2
        pw0, pw1, pw2 = pw0 / norm, pw1 / norm, pw2 / norm

        def lerp3(k):
            return (tri[k][best] * pw0[..., None]
                    + tri[k.replace("0", "1")][best] * pw1[..., None]
                    + tri[k.replace("0", "2")][best] * pw2[..., None])

        world = lerp3("p0")
        nrm = lerp3("n0")
        nrm = nrm / jnp.maximum(jnp.linalg.norm(nrm, axis=-1,
                                                keepdims=True), 1e-20)
        uv = lerp3("t0")

        mat = scene.materials[tri["mat"][best]]
        l_vec, intensity, _ = shading.light_terms(
            world, light_position, light_intensity, light_type)
        diffuse = shading.compute_diffuse(mat, l_vec, nrm)
        view_dir = world - eye
        dist = jnp.linalg.norm(view_dir, axis=-1)
        view_dir = view_dir / jnp.maximum(dist[..., None], 1e-20)
        # trilinear mip sampling (the raster pipeline's sampler really is
        # derivative-driven, maxLod = FLT_MAX — approximated here by the
        # pixel footprint at the hit distance)
        from .pipeline import _sample_texture
        spread = 2.0 / (jnp.abs(proj[1, 1]) * height)
        cosv = jnp.abs((nrm * view_dir).sum(-1))
        footprint = dist * spread / jnp.maximum(cosv, 1e-3)
        lod = tri["lod"][best] + jnp.log2(jnp.maximum(footprint, 1e-20))
        diffuse = diffuse * _sample_texture(scene.textures, scene.tex_meta,
                                            tri["tex"][best], uv, lod)
        specular = shading.compute_specular(mat, view_dir, l_vec, nrm)
        color = intensity[..., None] * (diffuse + specular)

        frame = jnp.where(visible[..., None], color, frame)
        zbuf = jnp.where(visible, zb, zbuf)
        return (frame, zbuf), None

    (frame, _), _ = jax.lax.scan(body, (frame, zbuf), data)
    rgba = jnp.concatenate(
        [frame, jnp.ones((height, width, 1), jnp.float32)], axis=-1)
    return shading.gamma_post(rgba)


def rasterize_scene(scene: Scene, camera: Camera = Camera(), *, width=1280,
                    height=720, light: Light = Light(),
                    clear_color=(1.0, 1.0, 1.0, 1.0)):
    view, proj, _, _ = camera.matrices(width, height)
    return rasterize_image(
        scene, view, proj, jnp.asarray(camera.eye, jnp.float32),
        jnp.asarray(light.position, jnp.float32),
        jnp.float32(light.intensity), jnp.int32(light.type),
        jnp.asarray(clear_color, jnp.float32),
        width=width, height=height)
