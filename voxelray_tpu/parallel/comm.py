"""Device mesh, shardings, and collectives — the distributed layer.

The reference is strictly single-GPU (SURVEY.md section 2.4); its only
parallelism is a std::thread fan-out over triangles with a serial merge
(VoxelBuilder.hpp:462-537).  The multi-device equivalents:

  voxelize: shard triangles across devices ("data" axis); each device
            scatters into its own occupancy copy; merge with a bitwise-OR
            all-reduce (psum over {0, 1}) — the deterministic analog of
            the thread-bucket merge.
  render:   shard the pixel rows ("rays" axis) — each device traces its
            rows against the replicated scene; the framebuffer is formed
            by construction (no gather needed under jit output sharding).
  frames:   batch-of-frames data parallelism for animation / deforming
            meshes (BASELINE config 5).

Everything uses jax.sharding.Mesh + shard_map with explicit collectives,
which XLA lowers to NCCL on GPUs.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["make_mesh", "shard_triangles", "voxelize_sharded",
           "voxelize_frames_sharded", "render_sharded", "shard_grid_zslab",
           "render_zslab_sharded", "or_reduce_occupancy"]


def make_mesh(n_devices: int | None = None, axis: str = "rays") -> Mesh:
    """1-D device mesh over all (or the first n) local devices."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (axis,))


def shard_triangles(tri_verts: np.ndarray, n_shards: int) -> np.ndarray:
    """Pad triangle array to a multiple of n_shards with +inf sentinels
    (empty windows) so every shard gets equal static shape."""
    f = tri_verts.shape[0]
    per = -(-f // n_shards)
    pad = per * n_shards - f
    return np.pad(tri_verts, ((0, pad), (0, 0), (0, 0)),
                  constant_values=np.inf)


def or_reduce_occupancy(occ, axis_name: str):
    """Bitwise-OR all-reduce of {0,1} uint8 occupancy over the mesh axis.

    OR == max == (psum > 0); psum is the all-reduce every backend has.
    """
    return (jax.lax.psum(occ.astype(jnp.int32), axis_name) > 0) \
        .astype(jnp.uint8)


def voxelize_sharded(tri_verts, origin, mesh: Mesh, *, dims,
                     voxel_size, window, chunk=4096):
    """Triangle-sharded voxelization with an OR all-reduce merge.

    tri_verts: (F, 3, 3) float32 (host or device).  Returns occ (Z, Y, X)
    uint8 replicated, set_calls int32 (total across shards).
    """
    from ..ops.voxelize import voxelize_dense

    axis = mesh.axis_names[0]
    n = mesh.devices.size
    tri = shard_triangles(np.asarray(tri_verts, np.float32), n)

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(axis), P()), out_specs=(P(), P()),
        check_vma=False,
    )
    def _vox(tri_shard, org):
        occ, calls = voxelize_dense(
            tri_shard, org, dims=dims,
            voxel_size_static=float(voxel_size), window=window,
            chunk=chunk)
        occ = or_reduce_occupancy(occ, axis)
        calls = jax.lax.psum(calls, axis)
        return occ, calls

    return _vox(jnp.asarray(tri), jnp.asarray(origin, jnp.float32))


def voxelize_frames_sharded(frame_verts, faces, origin, mesh: Mesh, *,
                            dims, voxel_size, window, chunk=4096):
    """Batch-of-frames data parallelism (BASELINE config 5).

    frame_verts: (F, V, 3) float32 — one deformed vertex set per
    animation frame, fixed topology `faces` (T, 3).  Frames shard over
    the mesh axis: each device voxelizes ceil(F/n) whole frames
    independently (zero collectives in the hot path — the deforming-mesh
    analog of the reference's per-frame rebuild, VoxelBuilder.hpp:
    462-537, scaled by frame instead of by triangle).  Returns
    (occ (F, Z, Y, X) uint8 sharded over frames, set_calls (F,) int32).

    Frame padding: F rounds up to a multiple of n by repeating the last
    frame; padded outputs are trimmed before returning, so any (F, n)
    combination is exact.
    """
    from ..ops.voxelize import voxelize_dense

    axis = mesh.axis_names[0]
    n = mesh.devices.size
    fv = np.asarray(frame_verts, np.float32)
    F = fv.shape[0]
    per = -(-F // n)
    pad = per * n - F
    if pad:
        fv = np.concatenate([fv, np.repeat(fv[-1:], pad, axis=0)])
    faces_d = jnp.asarray(np.asarray(faces).reshape(-1, 3))

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(axis), P(), P()), out_specs=(P(axis), P(axis)),
        check_vma=False,
    )
    def _vox(verts_shard, faces_rep, org):
        occs, calls = [], []
        for i in range(per):  # static local-frame loop
            tri = verts_shard[i][faces_rep]
            occ_i, calls_i = voxelize_dense(
                tri, org, dims=dims, voxel_size_static=float(voxel_size),
                window=window, chunk=chunk)
            occs.append(occ_i)
            calls.append(calls_i)
        return jnp.stack(occs), jnp.stack(calls)

    occ, calls = _vox(jnp.asarray(fv), faces_d,
                      jnp.asarray(origin, jnp.float32))
    return occ[:F], calls[:F]


def render_sharded(scene, view_inv, proj_inv, mesh: Mesh, *, width, height,
                   light=None, clear_color=(1.0, 1.0, 1.0, 1.0),
                   backend="fast", shadows=True):
    """Row-sharded render: each device traces ceil(height/n) rows.

    This is the multi-device form of the production render (SURVEY §2.4
    row 3 — the SIMT-ray axis is what shards): backend defaults to the
    "fast" brick traversal, and falls back to the dda/brute paths exactly
    like render_image.

    Any (height, n_devices) combination works: the row axis is padded to
    a multiple of n (padding rows trace duplicate last-row rays — their
    output is trimmed before returning) and the result is the exact
    (H, W, 4) framebuffer (sharded over rows on the mesh; convert with
    np.asarray to gather to host).
    """
    from ..models.scene import Light
    from ..ops.intersect import make_camera_rays
    from ..render import shading
    from ..render.pipeline import render_rays

    light = light or Light()
    axis = mesh.axis_names[0]
    n = mesh.devices.size
    rows_per = -(-height // n)
    pad_rows = rows_per * n - height
    if backend == "fast" and scene.accel is None:
        backend = "dda"  # render_image's own fallback chain

    lp = jnp.asarray(light.position, jnp.float32)
    li = jnp.float32(light.intensity)
    lt = jnp.int32(light.type)
    cc = jnp.asarray(clear_color, jnp.float32)

    # ray generation is cheap: compute per-shard rows inside the shard
    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(), P(), P()),
        out_specs=P(axis),
        check_vma=False,
    )
    def _render(scene_rep, vi, pi):
        row0 = jax.lax.axis_index(axis) * rows_per
        origins, dirs = make_camera_rays(width, height, vi, pi)
        if pad_rows:
            # duplicate the last row so every shard slices a full block
            origins = jnp.concatenate(
                [origins, jnp.broadcast_to(origins[-1:],
                                           (pad_rows,) + origins.shape[1:])])
            dirs = jnp.concatenate(
                [dirs, jnp.broadcast_to(dirs[-1:],
                                        (pad_rows,) + dirs.shape[1:])])
        o = jax.lax.dynamic_slice_in_dim(origins, row0, rows_per, axis=0)
        d = jax.lax.dynamic_slice_in_dim(dirs, row0, rows_per, axis=0)
        rgb = render_rays(scene_rep, o, d, lp, li, lt, cc, backend=backend,
                          shadows=shadows)
        rgba = jnp.concatenate(
            [rgb, jnp.ones(rgb.shape[:-1] + (1,), jnp.float32)], axis=-1)
        return shading.gamma_post(rgba)

    img = _render(scene, jnp.asarray(view_inv), jnp.asarray(proj_inv))
    return img[:height] if pad_rows else img


def shard_grid_zslab(scene, mesh: Mesh, backend="fast"):
    """Split the scene's voxel grid into one Z-slab per device of `mesh`.

    Returns (slabs, nzs): `slabs` is a tuple of arrays whose leading axis
    is sharded over the mesh, so each device holds only its own slab —
    the slab's BrickAccel tables (coarse, fine, l2, fine_off) for
    backend="fast", its dense occupancy for "dda" — and nzs is the slab
    height in cells (brick-aligned for "fast")."""
    n = mesh.devices.size
    nx, ny, nz = scene.grid_dims
    if nz == 0:
        raise ValueError("Z-slab sharding needs a voxel grid scene")
    nzs = -(-nz // n)
    if backend == "fast":
        nzs = -(-nzs // 8) * 8
    # host-side split, z-padded with empty cells (never hit)
    occ3 = np.asarray(scene.occ_flat, np.uint8).reshape(nz, ny, nx)
    occp = np.pad(occ3, ((0, nzs * n - nz), (0, 0), (0, 0)))
    if backend == "fast":
        from ..ops.traverse_fast import build_accel_slab
        accs = [build_accel_slab(occp[i * nzs:(i + 1) * nzs], i * nzs, nz,
                                 scene.grid_origin, scene.grid_voxel_size)
                for i in range(n)]
        slabs = tuple(np.stack([np.asarray(getattr(a, k)) for a in accs])
                      for k in ("coarse", "fine", "l2", "fine_off"))
    else:
        slabs = (occp.reshape(n, nzs * ny * nx),)
    sharding = NamedSharding(mesh, P(mesh.axis_names[0]))
    return tuple(jax.device_put(x, sharding) for x in slabs), nzs


def render_zslab_sharded(scene, view_inv, proj_inv, mesh: Mesh, *,
                         width, height, light=None,
                         clear_color=(1.0, 1.0, 1.0, 1.0), shadows=True,
                         backend="fast", slabs=None):
    """Render with the OCCUPANCY GRID sharded over Z-slabs (SURVEY §5
    "long-context analog"): each device holds only its slab of the grid
    (shard_grid_zslab), every device traces ALL rays against its slab
    with GLOBAL coordinates, and the per-slab results merge with
    collectives — nearest hit by a pmin over slab t (slab t0 is
    non-decreasing along a walk, so the global min IS the first accepted
    cell of the monolithic walk; exact-t ties across slabs resolve to
    the smaller cell id), occlusion by an OR.  Grids larger than one
    device's memory therefore stay renderable — the capability the
    reference bounds by single-GPU VRAM residency of its AABB buffer
    (hello_vulkan.cpp:709-715).

    Triangle geometry (and shading) stays replicated: the injected
    trace/any-hit closures only replace the VOXEL queries, so the
    shading is byte-for-byte render_rays (pipeline.py).

    backend="fast" (default): each device traces its slab's BrickAccel
    with the production brick_dda kernel.  backend="dda" keeps the
    all-XLA slab walk (ops.traverse.trace_grid_dda_zslab) as the
    semantic reference.  slabs: the (slabs, nzs) of an earlier
    shard_grid_zslab call for the same scene, mesh and backend.

    Returns the gamma-corrected (H, W, 4) framebuffer (replicated).
    """
    import dataclasses

    from ..models.scene import Light
    from ..ops.intersect import make_camera_rays
    from ..ops.traverse import trace_grid_dda_zslab
    from ..render import shading
    from ..render.pipeline import render_rays

    light = light or Light()
    axis = mesh.axis_names[0]
    nx, ny, nz = scene.grid_dims
    vs = scene.grid_voxel_size
    slabs, nzs = slabs or shard_grid_zslab(scene, mesh, backend)

    # replicated scene WITHOUT the full grid payload (the big arrays the
    # sharding exists to split); occ_flat keeps one sentinel cell so the
    # shading's grid-path branches (cube normals from grid dims) stay on
    scene_rep = dataclasses.replace(
        scene, occ_flat=jnp.ones(1, jnp.uint8), accel=None, octree=None,
        voxel_aabbs=jnp.zeros((0, 6), jnp.float32))

    lp = jnp.asarray(light.position, jnp.float32)
    li = jnp.float32(light.intensity)
    lt = jnp.int32(light.type)
    cc = jnp.asarray(clear_color, jnp.float32)
    imax = jnp.int32(np.iinfo(np.int32).max)

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(), P(), P()) + (P(axis),) * len(slabs),
        out_specs=P(),
        check_vma=False,
    )
    def _render(scene_r, vi, pi, *slab):
        origins, dirs = make_camera_rays(width, height, vi, pi)

        if backend == "fast":
            from ..ops.traverse_fast import (BRICK, BrickAccel,
                                             any_hit_grid_fast,
                                             trace_grid_fast)
            coarse, fine, l2, fine_off = (x[0] for x in slab)
            accel = BrickAccel(
                coarse=coarse, fine=fine, l2=l2, fine_off=fine_off,
                origin=jnp.asarray(scene_r.grid_origin), dims=(nx, ny, nz),
                bdims=tuple(-(-x // BRICK) for x in (nx, ny, nz)),
                voxel_size=float(vs),
                origin_key=tuple(float(c) for c in np.asarray(
                    scene.grid_origin, np.float32)))

            def trace_slab(o, d, tmn, tmx):
                return trace_grid_fast(o, d, accel, t_min=tmn, t_max=tmx)

            def occl_slab(o, d, tmn, tmx):
                return any_hit_grid_fast(o, d, accel, t_min=tmn,
                                         t_max=tmx)
        else:
            z0 = jax.lax.axis_index(axis).astype(jnp.int32) * nzs
            occ_slab = slab[0].reshape(-1)

            def trace_slab(o, d, tmn, tmx):
                return trace_grid_dda_zslab(
                    o, d, occ_slab, scene_r.grid_origin, z0,
                    dims=(nx, ny, nz), nzs=nzs, voxel_size_static=vs,
                    t_min=tmn, t_max=tmx)

            def occl_slab(o, d, tmn, tmx):
                t, _ = trace_slab(o, d, tmn, tmx)
                return jnp.isfinite(t)

        def trace_fn(o, d, tmn, tmx):
            t, lin = trace_slab(o, d, tmn, tmx)
            t_m = jax.lax.pmin(t, axis)
            lin_sel = jnp.where(jnp.isfinite(t) & (t == t_m), lin, imax)
            lin_m = jax.lax.pmin(lin_sel, axis)
            return t_m, jnp.where(jnp.isfinite(t_m), lin_m, -1)

        def any_hit_fn(o, d, tmn, tmx):
            occl = jax.lax.psum(
                occl_slab(o, d, tmn, tmx).astype(jnp.int32), axis) > 0
            if scene_r.n_triangles:
                # replicated triangle occlusion, same helpers as
                # pipeline._any_hit
                if scene_r.tri_accel is not None:
                    from ..ops.tri_accel import any_hit_triangles_grid
                    occl |= any_hit_triangles_grid(
                        o, d, scene_r.tri_accel, t_min=tmn, t_max=tmx)
                else:
                    from ..ops.traverse import any_hit_triangles_brute
                    occl |= any_hit_triangles_brute(
                        o, d, scene_r.tri_v0, scene_r.tri_v1,
                        scene_r.tri_v2, t_min=tmn, t_max=tmx)
            return occl

        rgb = render_rays(scene_r, origins, dirs, lp, li, lt, cc,
                          backend="dda", shadows=shadows,
                          trace_voxels_fn=trace_fn, any_hit_fn=any_hit_fn)
        rgba = jnp.concatenate(
            [rgb, jnp.ones(rgb.shape[:-1] + (1,), jnp.float32)], axis=-1)
        return shading.gamma_post(rgba)

    return _render(scene_rep, jnp.asarray(view_inv), jnp.asarray(proj_inv),
                   *slabs)
