"""Scene assembly: triangle models + voxel geometry + lights in one pytree.

The reference's HelloVulkan engine keeps per-model device buffers plus an
ObjDesc table, a TLAS with one instance per OBJ model and one procedural
AABB instance (hello_vulkan.cpp:737-793), and push-constant light state
(hello_vulkan.h:84-91).  Here the scene is a flat pytree of jnp arrays:

  * all mesh triangles concatenated (instance transforms pre-applied),
    with per-triangle material ids resolved into one global material table,
  * voxel geometry as both the packed AABB list (the "procedural BLAS",
    hello_vulkan.cpp:699-715) and the dense occupancy grid the DDA
    traversal consumes directly,
  * light + clear-color defaults matching the app's startup values
    (lightPosition (10,55,8), intensity 1000, point light,
    hello_vulkan.h:84-91; clearColor (1,1,1,1), main.cpp:183).

Mesh materials are converted sRGB -> linear on load (pow 2.2,
hello_vulkan.cpp:204-208); the voxel default material is uploaded raw
(createAABB, hello_vulkan.cpp:702-711).
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from ..io.objload import LoadedModel, Material

__all__ = ["Scene", "Light", "build_scene"]


@dataclass(frozen=True)
class Light:
    """PushConstantRay light state (host_device.h:87-93)."""

    position: tuple = (10.0, 55.0, 8.0)
    intensity: float = 1000.0
    type: int = 0  # 0 = point, 1 = directional


def _srgb_to_linear_rows(mat_rows: np.ndarray) -> np.ndarray:
    """ambient/diffuse/specular **= 2.2 (hello_vulkan.cpp:204-208)."""
    out = mat_rows.copy()
    out[:, 0:9] = np.power(out[:, 0:9], np.float32(2.2))
    return out


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class Scene:
    """Device-resident scene. Triangle streams are globally concatenated."""

    # triangle geometry (all instances, world space)
    tri_v0: Any                     # float32[F, 3]
    tri_v1: Any
    tri_v2: Any
    tri_n0: Any                     # per-corner normals
    tri_n1: Any
    tri_n2: Any
    tri_uv0: Any                    # float32[F, 2]
    tri_uv1: Any
    tri_uv2: Any
    tri_mat: Any                    # int32[F] -> rows of materials
    tri_tex: Any                    # int32[F] -> texture layer or -1
    tri_lod: Any                    # float32[F] texel-density log2 term
    materials: Any                  # float32[M, 20] packed rows
    textures: Any                   # float32[T, TH, TWA, 3] mip atlases
                                    # (level 0 top-left, levels >= 1 stacked
                                    # down the right column; >= 1 dummy)
    tex_meta: Any                   # int32[T, LMAX, 4] per-level
                                    # (y0, x0, h, w) atlas placements
    # voxel geometry
    voxel_aabbs: Any                # float32[N, 6]
    voxel_material: Any             # float32[20] (default MaterialObj)
    occ_flat: Any                   # uint8[X*Y*Z] dense occupancy
    grid_origin: Any                # float32[3]
    accel: Any                      # BrickAccel or None (the "BLAS")
    octree: Any                     # models.octree.Octree or None
    tri_accel: Any                  # ops.tri_accel.TriAccel or None —
                                    # the triangle-geometry "BLAS"
                                    # (hello_vulkan.cpp:596-635)
    grid_dims: tuple = field(metadata=dict(static=True))
    grid_voxel_size: float = field(metadata=dict(static=True))

    @property
    def n_triangles(self):
        return int(self.tri_v0.shape[0])

    @property
    def n_voxels(self):
        return int(self.voxel_aabbs.shape[0])


def build_scene(models=None, grid=None, aabbs=None,
                voxel_material: Material | None = None,
                transforms=None, octree=None,
                tri_accel="auto") -> Scene:
    """Assemble a Scene.

    models: list of LoadedModel (render-path streams).
    grid:   a GridBool (or result dict) providing occupancy + metadata.
    aabbs:  optional explicit (N, 6) AABB list (defaults to grid AABBs) —
            lets the Vec/AabbStruct/octree encodings feed the same render.
    transforms: optional per-model 4x4 matrices (instance transforms,
            pre-applied to vertices and inverse-transposed to normals).
    tri_accel: "auto" builds a triangle-grid acceleration structure
            (ops/tri_accel.py — the reference's triangle BLAS,
            hello_vulkan.cpp:596-635) once the mesh passes 256 triangles
            (below that the chunked brute trace is cheaper than a march);
            True forces the build, False/None keeps the brute path.
    """
    models = models or []
    transforms = transforms or [None] * len(models)

    v0s, v1s, v2s = [], [], []
    n0s, n1s, n2s = [], [], []
    uv0s, uv1s, uv2s = [], [], []
    mats_rows, mat_ids, tex_ids = [], [], []
    textures: list[np.ndarray] = []
    mat_offset = 0

    for model, xf in zip(models, transforms):
        verts = np.asarray(model.vertices, np.float32)
        pos = verts[:, 0:3]
        nrm = verts[:, 3:6]
        uv = verts[:, 9:11]
        if xf is not None:
            m = np.asarray(xf, np.float32)
            pos = pos @ m[:3, :3].T + m[:3, 3]
            n_mat = np.linalg.inv(m[:3, :3]).T
            nrm = nrm @ n_mat.T
        idx = np.asarray(model.indices).reshape(-1, 3)
        v0s.append(pos[idx[:, 0]])
        v1s.append(pos[idx[:, 1]])
        v2s.append(pos[idx[:, 2]])
        n0s.append(nrm[idx[:, 0]])
        n1s.append(nrm[idx[:, 1]])
        n2s.append(nrm[idx[:, 2]])
        uv0s.append(uv[idx[:, 0]])
        uv1s.append(uv[idx[:, 1]])
        uv2s.append(uv[idx[:, 2]])
        rows = _srgb_to_linear_rows(np.asarray(model.materials, np.float32))
        mats_rows.append(rows)
        mat_ids.append(np.asarray(model.mat_index, np.int32) + mat_offset)
        # texture id per triangle resolved through its material; the
        # model's texture files load now (magenta fallback on failure,
        # hello_vulkan.cpp:323-331)
        tex_of_mat = rows[:, 19].astype(np.int32)
        tex_base = len(textures)
        from ..io.textures import load_texture
        for name in model.textures:
            textures.append(load_texture(name))
        per_tri_tex = tex_of_mat[np.asarray(model.mat_index, np.int32)]
        per_tri_tex = np.where(per_tri_tex >= 0, per_tri_tex + tex_base, -1)
        tex_ids.append(per_tri_tex)
        mat_offset += len(rows)

    if models:
        tri_v0 = np.concatenate(v0s)
        tri_v1 = np.concatenate(v1s)
        tri_v2 = np.concatenate(v2s)
        tri_n0 = np.concatenate(n0s)
        tri_n1 = np.concatenate(n1s)
        tri_n2 = np.concatenate(n2s)
        tri_uv0 = np.concatenate(uv0s)
        tri_uv1 = np.concatenate(uv1s)
        tri_uv2 = np.concatenate(uv2s)
        tri_mat = np.concatenate(mat_ids)
        tri_tex = np.concatenate(tex_ids)
        materials = np.concatenate(mats_rows)
    else:
        tri_v0 = tri_v1 = tri_v2 = np.zeros((0, 3), np.float32)
        tri_n0 = tri_n1 = tri_n2 = np.zeros((0, 3), np.float32)
        tri_uv0 = tri_uv1 = tri_uv2 = np.zeros((0, 2), np.float32)
        tri_mat = np.zeros((0,), np.int32)
        tri_tex = np.zeros((0,), np.int32)
        materials = Material().as_row()[None]

    # textures: 1x1 white dummy when none (hello_vulkan.cpp:297-312).
    # Each texture becomes a mip atlas (full chain like the reference's
    # generateMipmaps, hello_vulkan.cpp:335-340): level 0 at the top-left,
    # levels >= 1 stacked top-to-bottom in the column to its right.
    # tex_meta records per-level (y0, x0, h, w) so differently-sized
    # textures in one stack sample with their OWN dims (sampling with the
    # padded max size would corrupt every smaller texture's UVs).
    if not textures:
        textures = [np.ones((1, 1, 3), np.float32)]
    from ..io.textures import build_mip_chain
    chains = [build_mip_chain(t) for t in textures]
    lmax = max(len(c) for c in chains)
    th = max(max(c[0].shape[0], sum(l.shape[0] for l in c[1:]))
             for c in chains)
    tw = max(c[0].shape[1] + (c[1].shape[1] if len(c) > 1 else 0)
             for c in chains)
    tex_stack = np.zeros((len(chains), th, tw, 3), np.float32)
    tex_meta = np.zeros((len(chains), lmax, 4), np.int32)
    for i, chain in enumerate(chains):
        h0, w0 = chain[0].shape[:2]
        tex_stack[i, :h0, :w0] = chain[0]
        tex_meta[i, 0] = (0, 0, h0, w0)
        ycur = 0
        for lv, img in enumerate(chain[1:], start=1):
            hl, wl = img.shape[:2]
            tex_stack[i, ycur: ycur + hl, w0: w0 + wl] = img
            tex_meta[i, lv] = (ycur, w0, hl, wl)
            ycur += hl
        # levels past this texture's chain clamp to its last level
        for lv in range(len(chain), lmax):
            tex_meta[i, lv] = tex_meta[i, len(chain) - 1]

    # per-triangle LOD constant for footprint mip selection:
    # 0.5 * log2(texels_covered / world_area) so that
    # lod = tri_lod + log2(world-space footprint at the hit) approximates
    # the hardware derivative-based level of the reference's trilinear
    # sampler (maxLod = FLT_MAX, hello_vulkan.cpp:288-293)
    if models and len(tri_v0):
        uv_e1 = tri_uv1 - tri_uv0
        uv_e2 = tri_uv2 - tri_uv0
        uv_area = 0.5 * np.abs(uv_e1[:, 0] * uv_e2[:, 1]
                               - uv_e1[:, 1] * uv_e2[:, 0])
        w_area = 0.5 * np.linalg.norm(
            np.cross(tri_v1 - tri_v0, tri_v2 - tri_v0), axis=-1)
        layer = np.clip(tri_tex, 0, len(chains) - 1)
        texels = (tex_meta[layer, 0, 2].astype(np.float64)
                  * tex_meta[layer, 0, 3])
        dens = uv_area * texels / np.maximum(w_area, 1e-20)
        tri_lod = np.where(
            tri_tex >= 0,
            0.5 * np.log2(np.maximum(dens, 1e-20)), 0.0
        ).astype(np.float32)
    else:
        tri_lod = np.zeros((len(tri_v0),), np.float32)

    # voxel geometry; an Octree may serve directly as the grid source
    from .octree import Octree as _Octree
    if octree is None and isinstance(grid, _Octree):
        octree = grid
    if grid is not None:
        if isinstance(grid, dict):
            occ = np.asarray(grid["occ"], np.uint8)
            g_dims, g_org = grid["dims"], grid["origin"]
            g_vs = grid["voxel_size"]
        else:
            occ = np.asarray(grid.occupancy(), np.uint8)
            g_dims, g_org = grid.dims, np.asarray(grid.origin)
            g_vs = grid.voxel_size
        occ_flat = occ.reshape(-1)
        if aabbs is None:
            from ..ops.aabbs import extract_aabbs
            aabbs = extract_aabbs({
                "occ": occ, "dims": g_dims, "origin": g_org,
                "voxel_size": g_vs,
            })
    else:
        occ_flat = np.zeros((0,), np.uint8)
        g_dims, g_org, g_vs = (0, 0, 0), np.zeros(3, np.float32), 1.0
        if aabbs is None:
            aabbs = np.zeros((0, 6), np.float32)

    vox_mat = (voxel_material or Material()).as_row()

    # the "BLAS build": brick acceleration structure for the fast backend
    accel = None
    if grid is not None and occ_flat.size:
        from ..ops.traverse_fast import build_accel
        accel = build_accel(
            np.asarray(occ_flat, np.uint8).reshape(
                g_dims[2], g_dims[1], g_dims[0]),
            np.asarray(g_org, np.float32), float(g_vs))

    # triangle "BLAS": bin triangles into a walkable uniform grid so
    # ray-vs-mesh scales sub-linearly per ray
    ta = None
    want_ta = (tri_accel is True
               or (tri_accel == "auto" and len(tri_v0) >= 256))
    if want_ta and len(tri_v0):
        from ..ops.tri_accel import build_tri_accel
        # resolution scales with triangle count: ~4 tris/nonempty cell
        # on typical surface meshes keeps list rows narrow while the
        # brick walk skips the empty bulk
        res = int(np.clip(round(float(len(tri_v0)) ** (1 / 2.2)), 16, 256))
        ta = build_tri_accel(tri_v0, tri_v1, tri_v2, res=res)
        if ta.overflow_cells:
            # a cell with more triangles than the padded list width
            # would silently skip the truncated tail during traversal
            # (wrong nearest hit / false miss).  Correctness beats
            # speed: retry with the true widest cell, or fall back to
            # the exact brute path if that row width is unreasonable.
            ta = build_tri_accel(tri_v0, tri_v1, tri_v2, res=res,
                                 max_l_width=4096)
            if ta.overflow_cells:
                import logging
                logging.getLogger(__name__).warning(
                    "tri accel: %d cells overflow even at l_width 4096; "
                    "using exact brute triangle traversal",
                    ta.overflow_cells)
                ta = None

    as_j = jnp.asarray
    return Scene(
        tri_v0=as_j(tri_v0), tri_v1=as_j(tri_v1), tri_v2=as_j(tri_v2),
        tri_n0=as_j(tri_n0), tri_n1=as_j(tri_n1), tri_n2=as_j(tri_n2),
        tri_uv0=as_j(tri_uv0), tri_uv1=as_j(tri_uv1), tri_uv2=as_j(tri_uv2),
        tri_mat=as_j(tri_mat), tri_tex=as_j(tri_tex),
        tri_lod=as_j(tri_lod),
        materials=as_j(materials), textures=as_j(tex_stack),
        tex_meta=as_j(tex_meta),
        voxel_aabbs=as_j(np.asarray(aabbs, np.float32)),
        voxel_material=as_j(vox_mat),
        occ_flat=as_j(occ_flat), grid_origin=as_j(np.asarray(g_org,
                                                             np.float32)),
        accel=accel, octree=octree, tri_accel=ta,
        grid_dims=tuple(int(x) for x in g_dims),
        grid_voxel_size=float(g_vs),
    )
