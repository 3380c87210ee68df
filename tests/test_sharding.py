"""Multi-chip paths on the 8-device virtual CPU mesh.

Sharded voxelization (triangles + OR all-reduce) and sharded render
(pixel rows) must produce exactly the single-device results — JAX's
functional semantics make this deterministic by construction; these tests
pin it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from voxelray_tpu.io import meshes
from voxelray_tpu.models.grids import GridBool
from voxelray_tpu.models.scene import build_scene
from voxelray_tpu.ops.voxelize import required_window_shape, voxelize_mesh
from voxelray_tpu.parallel.comm import (make_mesh, render_sharded,
                                        voxelize_sharded)
from voxelray_tpu.render.camera import Camera
from voxelray_tpu.render.pipeline import render_image


@pytest.fixture(scope="module")
def mesh8():
    assert len(jax.devices()) >= 8, "conftest must provide 8 CPU devices"
    return make_mesh(8)


def test_sharded_voxelize_matches_single(mesh8):
    v, f = meshes.icosphere(2)
    vs = 0.12
    single = voxelize_mesh(v, f, vs)
    win = required_window_shape(v, f, single["origin"], vs, single["dims"])
    occ, calls = voxelize_sharded(
        v[f], single["origin"], mesh8, dims=single["dims"],
        voxel_size=vs, window=win, chunk=64)
    assert np.array_equal(np.asarray(occ), np.asarray(single["occ"]))
    assert int(calls) == single["set_calls"]


def test_frames_sharded_voxelize_matches_sequential(mesh8):
    """Config-5 frames-batched DP: each device voxelizes whole frames;
    results must equal per-frame single-device voxelization bit-exactly.
    Uses 5 frames over 8 devices to exercise the frame padding path."""
    from voxelray_tpu.parallel.comm import voxelize_frames_sharded

    v, f = meshes.icosphere(1)
    vs = 0.25
    n_frames = 5
    fv = np.stack([meshes.deformed(v, 2 * np.pi * i / n_frames)
                   for i in range(n_frames)])
    from voxelray_tpu.ops.geometry import grid_dims, mesh_bbox
    bb_min, bb_max = mesh_bbox(fv.reshape(-1, 3))
    dims = grid_dims(bb_min, bb_max, vs)
    win = (4, 4, 4)
    occ, calls = voxelize_frames_sharded(fv, f, bb_min, mesh8, dims=dims,
                                         voxel_size=vs, window=win,
                                         chunk=32)
    occ = np.asarray(occ)
    assert occ.shape[0] == n_frames
    from voxelray_tpu.ops.voxelize import voxelize_dense
    for i in range(n_frames):
        occ_i, calls_i = voxelize_dense(
            jnp.asarray(fv[i][f]), jnp.asarray(bb_min), dims=dims,
            voxel_size_static=vs, window=win, chunk=32)
        assert np.array_equal(occ[i], np.asarray(occ_i)), f"frame {i}"
        assert int(calls[i]) == int(calls_i)


def test_sharded_render_matches_single(mesh8):
    v, f = meshes.bunny_like(2)
    grid = GridBool.from_mesh(v, f, 0.11)
    scene = build_scene(models=None, grid=grid)
    W, H = 64, 32
    cam = Camera()
    _, _, vi, pi = cam.matrices(W, H)
    a = np.asarray(render_image(scene, vi, pi, width=W, height=H,
                                backend="dda"))
    b = np.asarray(render_sharded(scene, vi, pi, mesh8, width=W, height=H,
                                  backend="dda"))
    assert a.shape == b.shape
    assert np.allclose(a, b, rtol=2e-6, atol=1e-7)


def test_sharded_trace_fast_bit_parity(mesh8):
    """The production brick_dda traversal under shard_map: per-shard
    trace_grid_fast over a ray shard of the full camera bundle must
    return the single-device hits BIT-exactly (same linear cell ids,
    same hit mask) — the SIMT-ray axis of SURVEY §2.4 row 3 sharded
    through the real traversal, not the dda stand-in."""
    from functools import partial

    from jax.sharding import PartitionSpec as P

    from voxelray_tpu.ops.intersect import make_camera_rays
    from voxelray_tpu.ops.traverse_fast import trace_grid_fast

    v, f = meshes.bunny_like(2)
    grid = GridBool.from_mesh(v, f, 0.11)
    scene = build_scene(models=None, grid=grid)
    W, H = 64, 32  # 64*32 = 2048 rays -> 256/shard
    _, _, vi, pi = Camera().matrices(W, H)
    o, d = make_camera_rays(W, H, vi, pi)
    o = o.reshape(-1, 3)
    d = d.reshape(-1, 3)

    t_s, lin_s = trace_grid_fast(o, d, scene.accel)

    @partial(jax.shard_map, mesh=mesh8,
             in_specs=(P("rays"), P("rays"), P()),
             out_specs=(P("rays"), P("rays")), check_vma=False)
    def _trace(o_sh, d_sh, accel):
        return trace_grid_fast(o_sh, d_sh, accel)

    t_m, lin_m = _trace(o, d, scene.accel)
    assert np.array_equal(np.asarray(lin_s), np.asarray(lin_m))
    hit = np.isfinite(np.asarray(t_s))
    assert np.array_equal(hit, np.isfinite(np.asarray(t_m)))
    assert np.allclose(np.asarray(t_s)[hit], np.asarray(t_m)[hit],
                       rtol=2e-6, atol=0)


def test_sharded_render_fast_matches_single(mesh8):
    """render_sharded's default backend IS the fast path now; full
    shaded+shadowed frame must match the single-device fast render."""
    v, f = meshes.bunny_like(2)
    grid = GridBool.from_mesh(v, f, 0.11)
    scene = build_scene(models=None, grid=grid)
    W, H = 128, 64  # per-shard block (8, 128) -> the tiled path runs
    cam = Camera()
    _, _, vi, pi = cam.matrices(W, H)
    a = np.asarray(render_image(scene, vi, pi, width=W, height=H,
                                backend="fast"))
    b = np.asarray(render_sharded(scene, vi, pi, mesh8, width=W, height=H,
                                  backend="fast"))
    assert a.shape == b.shape
    assert np.allclose(a, b, rtol=2e-6, atol=1e-7)


def test_sharded_render_odd_height(mesh8):
    """Heights that don't divide the device count pad-and-trim
    (e.g. 30 rows on 8 devices)."""
    v, f = meshes.bunny_like(2)
    grid = GridBool.from_mesh(v, f, 0.11)
    scene = build_scene(models=None, grid=grid)
    W, H = 48, 30  # 30 % 8 != 0
    cam = Camera()
    _, _, vi, pi = cam.matrices(W, H)
    a = np.asarray(render_image(scene, vi, pi, width=W, height=H,
                                backend="dda"))
    b = np.asarray(render_sharded(scene, vi, pi, mesh8, width=W, height=H,
                                  backend="dda"))
    assert b.shape == (H, W, 4)
    assert np.allclose(a, b, rtol=2e-6, atol=1e-7)


def test_or_reduce_semantics(mesh8):
    from functools import partial

    from jax.sharding import PartitionSpec as P

    from voxelray_tpu.parallel.comm import or_reduce_occupancy

    @partial(jax.shard_map, mesh=mesh8, in_specs=P("rays"), out_specs=P())
    def go(x):
        return or_reduce_occupancy(x[0], "rays")

    x = np.zeros((8, 16), np.uint8)
    x[2, 5] = 1
    x[7, 5] = 1
    x[3, 9] = 1
    out = np.asarray(go(x))
    want = np.zeros(16, np.uint8)
    want[5] = want[9] = 1
    assert np.array_equal(out, want)


def test_zslab_trace_matches_monolithic(mesh8):
    """Grid sharded over Z-slabs (SURVEY §5 long-context analog): the
    per-slab DDA + pmin merge must reproduce the monolithic full-grid
    DDA exactly — same cells, same hit mask, t to the cross-program
    float envelope."""
    from functools import partial

    from jax.sharding import PartitionSpec as P

    from voxelray_tpu.ops.intersect import make_camera_rays
    from voxelray_tpu.ops.traverse import (trace_grid_dda,
                                           trace_grid_dda_zslab)

    v, f = meshes.bunny_like(2)
    grid = GridBool.from_mesh(v, f, 0.11)
    scene = build_scene(models=None, grid=grid)
    nx, ny, nz = scene.grid_dims
    n = 8
    nzs = -(-nz // n)
    W, H = 64, 32
    _, _, vi, pi = Camera().matrices(W, H)
    o, d = make_camera_rays(W, H, vi, pi)

    t_m, lin_m = trace_grid_dda(
        o, d, scene.occ_flat, scene.grid_origin, dims=scene.grid_dims,
        voxel_size_static=scene.grid_voxel_size)

    occ3 = np.asarray(scene.occ_flat, np.uint8).reshape(nz, ny, nx)
    occp = np.pad(occ3, ((0, nzs * n - nz), (0, 0), (0, 0)))
    occ_sh = jnp.asarray(occp.reshape(n, nzs * ny * nx))
    imax = np.iinfo(np.int32).max

    @partial(jax.shard_map, mesh=mesh8,
             in_specs=(P("rays"), P(), P(), P()),
             out_specs=(P(), P()), check_vma=False)
    def _trace(occ_slab, oo, dd, org):
        z0 = jax.lax.axis_index("rays").astype(jnp.int32) * nzs
        t, lin = trace_grid_dda_zslab(
            oo, dd, occ_slab.reshape(-1), org, z0,
            dims=(nx, ny, nz), nzs=nzs,
            voxel_size_static=scene.grid_voxel_size)
        t_min_all = jax.lax.pmin(t, "rays")
        lin_sel = jnp.where(jnp.isfinite(t) & (t == t_min_all), lin,
                            jnp.int32(imax))
        lin_all = jax.lax.pmin(lin_sel, "rays")
        return t_min_all, jnp.where(jnp.isfinite(t_min_all), lin_all, -1)

    t_s, lin_s = _trace(occ_sh, o, d, scene.grid_origin)
    assert np.array_equal(np.asarray(lin_m), np.asarray(lin_s))
    hm = np.isfinite(np.asarray(t_m))
    assert np.array_equal(hm, np.isfinite(np.asarray(t_s)))
    assert np.allclose(np.asarray(t_m)[hm], np.asarray(t_s)[hm],
                       rtol=2e-6, atol=0)


@pytest.mark.parametrize("backend", ["dda", "fast"])
def test_zslab_render_matches_replicated(mesh8, backend):
    """Full shaded+shadowed frame with the grid sharded over Z-slabs
    matches the replicated dda render (the fast variant runs the
    brick_dda kernel against per-slab accels)."""
    from voxelray_tpu.parallel.comm import render_zslab_sharded

    v, f = meshes.bunny_like(2)
    grid = GridBool.from_mesh(v, f, 0.11)
    scene = build_scene(models=None, grid=grid)
    W, H = 64, 32
    _, _, vi, pi = Camera().matrices(W, H)
    a = np.asarray(render_image(scene, vi, pi, width=W, height=H,
                                backend="dda"))
    b = np.asarray(render_zslab_sharded(scene, vi, pi, mesh8,
                                        width=W, height=H,
                                        backend=backend))
    assert a.shape == b.shape
    assert np.allclose(a, b, rtol=2e-6, atol=1e-7)


def test_zslab_fast_accel_trace_bit_exact():
    """build_accel_slab per-slab traces, min-merged, must reproduce the
    monolithic fast trace BIT-exactly on hit cells and t: every
    coordinate expression in the slab accel is global, so this is exact
    equality, not a tolerance."""
    from voxelray_tpu.ops.intersect import make_camera_rays
    from voxelray_tpu.ops.traverse_fast import (build_accel,
                                                build_accel_slab,
                                                trace_grid_fast)

    v, f = meshes.bunny_like(2)
    grid = GridBool.from_mesh(v, f, 0.09)
    occ = np.asarray(grid.occupancy()).astype(np.uint8)
    nz, ny, nx = occ.shape
    accel = build_accel(occ, grid.origin, grid.voxel_size)
    W, H = 64, 32
    _, _, vi, pi = Camera().matrices(W, H)
    o, d = make_camera_rays(W, H, vi, pi)
    t_m, lin_m = trace_grid_fast(o.reshape(-1, 3), d.reshape(-1, 3),
                                 accel)
    t_m, lin_m = np.asarray(t_m), np.asarray(lin_m)

    n_slabs = 3
    nzs = -(-(-(-nz // n_slabs)) // 8) * 8
    occp = np.pad(occ, ((0, nzs * n_slabs - nz), (0, 0), (0, 0)))
    t_best = np.full_like(t_m, np.inf)
    lin_best = np.full_like(lin_m, -1)
    for i in range(n_slabs):
        sl = build_accel_slab(occp[i * nzs:(i + 1) * nzs], i * nzs, nz,
                              grid.origin, grid.voxel_size)
        t_s, lin_s = trace_grid_fast(o.reshape(-1, 3), d.reshape(-1, 3),
                                     sl)
        t_s, lin_s = np.asarray(t_s), np.asarray(lin_s)
        take = t_s < t_best
        t_best = np.where(take, t_s, t_best)
        lin_best = np.where(take, lin_s, lin_best)
    hits = np.isfinite(t_m)
    assert np.array_equal(hits, np.isfinite(t_best))
    assert np.array_equal(lin_m[hits], lin_best[hits])
    assert np.array_equal(t_m[hits], t_best[hits])
    assert hits.any()
