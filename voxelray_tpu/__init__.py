"""voxelray_tpu — a mesh-voxelization + ray-tracing framework in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of
MatBayern/Raytracing-Voxilizer-Vulkan-Intresection (a Vulkan
VK_KHR_ray_tracing voxelizer/renderer); it runs on an NVIDIA GPU:

  OBJ mesh -> triangle/box SAT voxelization -> one of four grid encodings
  (bitmask / dense AABB-struct / append vector / Morton octree) -> AABB
  extraction -> per-pixel primary+shadow ray trace with Lambert+specular
  shading -> gamma post pass.

Layer map (mirrors SURVEY.md section 1):
  io/        L1  asset I/O: OBJ/MTL parsing, procedural test meshes, textures
  ops/       L2  compute: SAT voxelizer, Morton codes, AABB extraction,
                 ray-AABB slab tests, grid/octree traversal (XLA + Pallas)
  models/    L2  the grid encodings + octree + scene containers (pytrees)
  render/    L3/L4  camera math, shading, the jitted render pipeline,
                 software rasterizer fallback
  parallel/  --  device mesh / sharding / collectives (the distributed layer
                 the reference lacks; rays, triangles and grid slabs
                 shard over the devices)
  utils/     L5  config dataclasses, structured logging, benchmark harness,
                 checkpointing
  native/    --  C++ runtime pieces (fast OBJ parse, CPU oracle voxelizer)
"""

__version__ = "0.1.0"

from . import ops, io, models, render, parallel, utils  # noqa: F401
