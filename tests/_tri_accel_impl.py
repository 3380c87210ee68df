"""Triangle-grid acceleration vs the brute Möller-Trumbore reference."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest


@pytest.fixture(autouse=True, scope="module")
def _no_compile_cache():
    """XLA:CPU SEGFAULTS serializing this module's trace_triangles_grid
    executable for the persistent compile cache (put_executable_and_time
    -> executable.serialize(); reproduced at tests tail, exit 139, every
    run since the cell-midpoint march fix).  Skip persistent-cache writes
    for the whole module; everything recompiles in-process, which is
    slower but cannot crash the suite.

    The config flip alone is NOT enough in a full-suite run:
    compilation_cache.is_cache_used() memoizes its decision at the first
    compile of the PROCESS (_cache_checked), so once any earlier module
    compiled with the cache on, the flag change is ignored and the crash
    returns.  reset_cache() clears that memo so the flag is re-read."""
    from jax._src import compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)
    compilation_cache.reset_cache()
    yield
    jax.config.update("jax_enable_compilation_cache", True)
    compilation_cache.reset_cache()

from voxelray_tpu.io import meshes
from voxelray_tpu.ops.intersect import make_camera_rays
from voxelray_tpu.ops.traverse import trace_triangles_brute
from voxelray_tpu.ops.tri_accel import (build_tri_accel,
                                        trace_triangles_grid)
from voxelray_tpu.render.camera import Camera


@pytest.fixture(scope="module")
def sphere():
    v, f = meshes.icosphere(3)           # 1280 triangles
    tri = v[f]
    ta = build_tri_accel(tri[:, 0], tri[:, 1], tri[:, 2], res=24)
    return tri, ta


def _cam_rays(eye, center, W=64, H=48):
    cam = Camera(eye=eye, center=center)
    _, _, vi, pi = cam.matrices(W, H)
    return make_camera_rays(W, H, vi, pi)


def _check_match(tri, ta, o, d, t_max=None, require_hits=0.05):
    kw = {} if t_max is None else dict(t_max=t_max)
    t_b, id_b, u_b, v_b = trace_triangles_brute(
        o, d, jnp.asarray(tri[:, 0]), jnp.asarray(tri[:, 1]),
        jnp.asarray(tri[:, 2]), **kw)
    t_g, id_g, u_g, v_g, unresolved = trace_triangles_grid(
        o, d, ta, return_stats=True, **kw)
    hb = np.isfinite(np.asarray(t_b))
    hg = np.isfinite(np.asarray(t_g))
    assert int(unresolved) == 0
    assert hb.mean() >= require_hits        # the test actually tests hits
    assert np.array_equal(hb, hg)
    # t/u/v: same MT formula, different gather/fusion shapes -> ulp drift
    assert np.allclose(np.asarray(t_g)[hb], np.asarray(t_b)[hb],
                       rtol=3e-6, atol=1e-7)
    same_tri = np.asarray(id_g)[hb] == np.asarray(id_b)[hb]
    # adjacent triangles sharing an edge can tie within float tolerance;
    # require near-total agreement and t-agreement everywhere
    assert same_tri.mean() > 0.995
    assert np.allclose(np.asarray(u_g)[hb][same_tri],
                       np.asarray(u_b)[hb][same_tri], rtol=1e-4,
                       atol=1e-5)


def test_build_structure(sphere):
    tri, ta = sphere
    assert ta.overflow_cells == 0
    ids = np.asarray(ta.cell_tris)
    # every triangle appears in at least one cell
    present = np.unique(ids[ids >= 0])
    assert len(present) == len(tri)
    # rows are ascending (brute's lowest-index tie rule)
    for row in ids[:32]:
        live = row[row >= 0]
        assert np.array_equal(live, np.sort(live))


def test_camera_rays_match_brute(sphere):
    tri, ta = sphere
    o, d = _cam_rays((2.0, 1.3, -2.1), (0.0, 0.0, 0.0))
    _check_match(tri, ta, o, d)


def test_rays_starting_inside_grid(sphere):
    """Shadow-style rays that START inside the tri-grid (origin-cell
    round 0) must still match brute."""
    tri, ta = sphere
    rng = np.random.default_rng(3)
    o = jnp.asarray(rng.uniform(-0.9, 0.9, (500, 3)).astype(np.float32))
    d = rng.normal(size=(500, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    _check_match(tri, ta, o, jnp.asarray(d), require_hits=0.3)


def test_t_max_interval(sphere):
    tri, ta = sphere
    o, d = _cam_rays((2.0, 1.3, -2.1), (0.0, 0.0, 0.0), W=32, H=24)
    t_b, _, _, _ = trace_triangles_brute(
        o, d, jnp.asarray(tri[:, 0]), jnp.asarray(tri[:, 1]),
        jnp.asarray(tri[:, 2]))
    finite = np.asarray(t_b)[np.isfinite(np.asarray(t_b))]
    cut = float(np.median(finite))  # half the hits fall beyond t_max
    _check_match(tri, ta, o, d, t_max=cut, require_hits=0.01)


def test_scene_render_uses_tri_accel():
    """build_scene auto-builds the triangle accel past 256 tris and the
    rendered image matches the brute triangle path."""
    from voxelray_tpu.io.objload import LoadedModel
    from voxelray_tpu.models.scene import build_scene
    from voxelray_tpu.render.pipeline import render_scene

    v, f = meshes.icosphere(3)
    nrm = v / np.linalg.norm(v, axis=1, keepdims=True)
    verts = np.zeros((len(v), 11), np.float32)
    verts[:, 0:3] = v
    verts[:, 3:6] = nrm
    model = LoadedModel(vertices=verts, indices=f.reshape(-1),
                        materials=np.tile(np.asarray(
                            [[.2, .2, .2, .7, .7, .7, 1, 1, 1, 0, 0, 0,
                              1, 32, 1, 1, 2, 0, 0, -1]], np.float32),
                            (1, 1))[0][None],
                        mat_index=np.zeros(len(f), np.int32), textures=[])
    scene_a = build_scene(models=[model])
    assert scene_a.tri_accel is not None
    scene_b = build_scene(models=[model], tri_accel=False)
    assert scene_b.tri_accel is None
    cam = Camera(eye=(2.2, 1.4, -2.3), center=(0.0, 0.0, 0.0))
    img_a = np.asarray(render_scene(scene_a, cam, width=64, height=48))
    img_b = np.asarray(render_scene(scene_b, cam, width=64, height=48))
    # same hit set; shading equal up to adjacent-edge ties + ulp drift
    close = np.isclose(img_a, img_b, atol=2e-3).all(axis=-1)
    assert close.mean() > 0.995


def test_two_meshes_depth_order():
    """Two objects along the ray: the near one must win (the marcher's
    per-cell t-span accept preserves global nearest ordering)."""
    v1, f1 = meshes.cube(size=1.0)
    v2, f2 = meshes.cube(size=1.0)
    tri = np.concatenate([v1[f1] + np.asarray([0, 0, 3.0], np.float32),
                          v2[f2]], axis=0)
    ta = build_tri_accel(tri[:, 0], tri[:, 1], tri[:, 2], res=16)
    o, d = _cam_rays((0.0, 0.0, -4.0), (0.0, 0.0, 0.0), W=32, H=24)
    # brute finds 36/768 = 4.69% hits here (small cube, wide FOV) — the
    # floor only guards against a degenerate all-miss comparison
    _check_match(tri, ta, o, d, require_hits=0.04)


def test_candidate_cap_starvation_stays_exact(sphere):
    """Review r3: a lap serves at most n/cand_frac rays, so with a tiny
    candidate cap and every ray needing the march the drain needs
    cand_frac x more laps than cells-per-ray — the old lap bound
    starved and returned silent misses.  cand_frac=64 with rounds=1
    pushes nearly all work through the capped drain; the result must
    still match brute exactly."""
    tri, ta = sphere
    o, d = _cam_rays((2.2, 1.4, -2.2), (0.0, 0.0, 0.0), W=48, H=36)
    t_b, id_b, _, _ = trace_triangles_brute(
        o, d, jnp.asarray(tri[:, 0]), jnp.asarray(tri[:, 1]),
        jnp.asarray(tri[:, 2]))
    t_g, id_g, _, _, unresolved = trace_triangles_grid(
        o, d, ta, rounds=1, cand_frac=64, return_stats=True)
    hb = np.isfinite(np.asarray(t_b))
    assert int(unresolved) == 0
    assert hb.mean() > 0.05
    assert np.array_equal(hb, np.isfinite(np.asarray(t_g)))
    assert np.allclose(np.asarray(t_g)[hb], np.asarray(t_b)[hb],
                       rtol=3e-6, atol=1e-7)
