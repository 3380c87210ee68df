"""Runners for the five BASELINE.json gate configurations.

Each runner executes its config end to end and returns a result dict with
the artifacts a judge can check (occupancy counts, image stats, timing).
Scale parameters live in utils.config.BASELINE_CONFIGS; tests run shrunken
variants on CPU, bench/CLI run the full ones on the GPU.
"""
from __future__ import annotations

import numpy as np

from ..io import meshes
from ..models.grids import GridBool, build_grid
from ..models.scene import build_scene
from ..oracle import oracle_voxelize
from ..render.camera import Camera, orbit_path
from ..render.pipeline import render_aov, render_scene
from .config import BASELINE_CONFIGS, JobConfig

__all__ = ["run_gate", "GATE_RUNNERS"]


def _mesh_for(cfg: JobConfig, scale: float):
    v, f = meshes.make_scene_mesh(cfg.mesh)
    return v, f


def gate1_cube_occupancy(cfg: JobConfig, scale=1.0, check_oracle=True):
    """cube -> voxelgridBool, CPU-checkable occupancy, no render."""
    v, f = _mesh_for(cfg, scale)
    vs = cfg.voxelize.voxel_size / scale
    grid = GridBool.from_mesh(v, f, vs)
    out = {"dims": grid.dims, "occupied": int(np.asarray(
        grid.occupancy()).sum()), "set_calls": grid.set_calls}
    if check_oracle:
        ref = oracle_voxelize(v, f, vs)
        out["bit_exact"] = bool(np.array_equal(
            np.asarray(grid.occupancy()).astype(bool), ref.occupancy))
        out["set_calls_match"] = grid.set_calls == ref.set_calls
    return out


def gate2_bunny_render(cfg: JobConfig, scale=1.0, **kw):
    """bunny -> AABB-struct + primary-ray hit/miss render, flat shading."""
    v, f = _mesh_for(cfg, scale)
    vs = cfg.voxelize.voxel_size / scale
    grid = build_grid("aabbstruct", v, f, vs)
    scene = build_scene(models=None, grid={
        "occ": np.asarray(grid.occupancy()), "dims": grid.dims,
        "origin": np.asarray(grid.origin), "voxel_size": grid.voxel_size})
    w = max(64, int(cfg.render.width * scale))
    h = max(36, int(cfg.render.height * scale))
    img = np.asarray(render_scene(scene, Camera(), width=w, height=h,
                                  backend=cfg.render.backend))
    return {"dims": grid.dims, "image_shape": img.shape,
            "image_mean": float(img.mean()),
            "hit_fraction": float(
                (np.abs(img[..., 2] - img[..., 0]) > 1e-3).mean())}


def gate3_vec_octree_aov(cfg: JobConfig, scale=1.0, **kw):
    """vec encoding + octree-backed traversal, depth+normal output."""
    v, f = _mesh_for(cfg, scale)
    vs = cfg.voxelize.voxel_size / scale
    gvec = build_grid("vec", v, f, vs)
    tree = build_grid("octree", v, f, vs)
    # the octree IS the acceleration structure here: it goes into the
    # scene and backend="octree" routes traversal through the stackless
    # node walk (ops/octree_traverse.py) — the vec encoding provides the
    # AABB list (identical geometry)
    if cfg.render.backend != "octree":
        raise ValueError(
            f"gate 3 must exercise the octree walk, got backend="
            f"{cfg.render.backend!r}")
    scene = build_scene(models=None, grid={
        "occ": np.asarray(tree.occupancy()), "dims": tree.dims,
        "origin": np.asarray(tree.root_min),
        "voxel_size": tree.voxel_size},
        aabbs=np.asarray(gvec.get_aabbs()), octree=tree)
    assert scene.octree is not None
    w = max(64, int(cfg.render.width * scale))
    h = max(36, int(cfg.render.height * scale))
    depth, normal, hit = render_aov(scene, Camera(), width=w, height=h,
                                    backend=cfg.render.backend)
    depth = np.asarray(depth)
    return {"vec_aabbs": int(gvec.aabbs.shape[0]),
            "octree_nodes": tree.n_nodes,
            "backend": cfg.render.backend,
            "hit_pixels": int(np.asarray(hit).sum()),
            "depth_min": float(depth[np.isfinite(depth)].min())
            if np.isfinite(depth).any() else None,
            "normals_unit": bool(np.allclose(
                np.linalg.norm(np.asarray(normal)[np.asarray(hit)], axis=-1),
                1.0, atol=1e-5)) if np.asarray(hit).any() else None}


def gate4_flythrough(cfg: JobConfig, scale=1.0, frames=None, **kw):
    """large mesh -> high-res grid, shadowed render, camera fly-through."""
    v, f = _mesh_for(cfg, scale)
    vs = cfg.voxelize.voxel_size / scale
    grid = GridBool.from_mesh(v, f, vs)
    scene = build_scene(models=None, grid=grid)
    w = max(64, int(cfg.render.width * scale))
    h = max(36, int(cfg.render.height * scale))
    n_frames = frames or cfg.render.frames
    from ..ops.geometry import mesh_bbox
    bb_min, bb_max = mesh_bbox(v)
    center = tuple(((bb_min + bb_max) * 0.5).tolist())
    radius = float(np.max(bb_max - bb_min)) * 1.2
    stats = []
    for cam in orbit_path(n_frames, center=center, radius=radius,
                          height=center[1] + radius * 0.3):
        img = np.asarray(render_scene(scene, cam, width=w, height=h,
                                      backend=cfg.render.backend))
        stats.append(float(img.mean()))
    return {"dims": grid.dims, "frames": n_frames, "frame_means": stats}


def gate5_deforming(cfg: JobConfig, scale=1.0, frames=None, n_devices=None,
                    **kw):
    """per-frame re-voxelization of a deforming mesh, sharded over chips."""
    import jax
    import jax.numpy as jnp

    from ..ops.geometry import grid_dims, mesh_bbox
    from ..ops.voxelize import required_window_shape
    from ..parallel.comm import make_mesh, voxelize_frames_sharded

    v, f = _mesh_for(cfg, scale)
    vs = cfg.voxelize.voxel_size / scale
    n_frames = frames or cfg.render.frames
    n_dev = n_devices or len(jax.devices())
    mesh = make_mesh(n_dev)

    # fixed grid across the animation: bbox of the worst-case deformation
    all_v = np.concatenate([meshes.deformed(v, 2 * np.pi * i / n_frames)
                            for i in range(n_frames)])
    bb_min, bb_max = mesh_bbox(all_v)
    dims = grid_dims(bb_min, bb_max, vs)
    win = required_window_shape(all_v, np.tile(f, (n_frames, 1))
                                + np.repeat(np.arange(n_frames) * len(v),
                                            len(f) * 3).reshape(-1, 3),
                                bb_min, vs, dims)
    win = tuple(1 << int(np.ceil(np.log2(max(1, x)))) for x in win)

    # frames-batched data parallelism (the comm.py design for config 5):
    # each device voxelizes whole frames of the animation independently
    fv = np.stack([meshes.deformed(v, 2 * np.pi * i / n_frames)
                   for i in range(n_frames)])
    occ, _calls = voxelize_frames_sharded(fv, f, bb_min, mesh, dims=dims,
                                          voxel_size=vs, window=win,
                                          chunk=256)
    counts = [int(c) for c in
              np.asarray(occ).reshape(n_frames, -1).sum(axis=1)]
    return {"dims": dims, "devices": n_dev, "frames": n_frames,
            "occupied_per_frame": counts}


GATE_RUNNERS = {
    "cube64": gate1_cube_occupancy,
    "bunny128": gate2_bunny_render,
    "vec256": gate3_vec_octree_aov,
    "knot512": gate4_flythrough,
    "deform8": gate5_deforming,
}


def run_gate(name: str, scale: float = 1.0, **kw):
    """Execute one BASELINE gate config; scale < 1 shrinks it for CI."""
    cfg = BASELINE_CONFIGS[name]
    return GATE_RUNNERS[name](cfg, scale=scale, **kw)
