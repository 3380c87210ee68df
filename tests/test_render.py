"""End-to-end render pipeline: backend parity, shading contract, shadows."""
import jax.numpy as jnp
import numpy as np
import pytest

from voxelray_tpu.io import meshes
from voxelray_tpu.io.objload import Material, ObjLoader, write_obj
from voxelray_tpu.models.grids import GridBool
from voxelray_tpu.models.scene import Light, build_scene
from voxelray_tpu.ops.traverse import trace_aabbs_brute, trace_grid_dda
from voxelray_tpu.render.camera import Camera
from voxelray_tpu.render.pipeline import render_scene

W, H = 96, 54


@pytest.fixture(scope="module")
def bunny_scene(tmp_path_factory):
    v, f = meshes.bunny_like(2)
    grid = GridBool.from_mesh(v, f, 0.11)
    p = tmp_path_factory.mktemp("scene") / "plane.obj"
    pv, pf = meshes.plane(20.0)
    write_obj(str(p), pv, pf)
    model = ObjLoader().load_model(str(p))
    return build_scene(models=[model], grid=grid), grid


def test_dda_matches_brute_hits(bunny_scene):
    scene, grid = bunny_scene
    cam = Camera()
    _, _, vi, pi = cam.matrices(W, H)
    from voxelray_tpu.ops.intersect import make_camera_rays
    o, d = make_camera_rays(W, H, vi, pi)
    t_b, id_b = trace_aabbs_brute(o, d, scene.voxel_aabbs)
    t_d, lin_d = trace_grid_dda(
        o, d, scene.occ_flat, scene.grid_origin, dims=scene.grid_dims,
        voxel_size_static=scene.grid_voxel_size)
    hit_b = np.isfinite(np.asarray(t_b))
    hit_d = np.isfinite(np.asarray(t_d))
    assert np.array_equal(hit_b, hit_d)
    # identical cells hit...
    occ_lin = np.flatnonzero(np.asarray(scene.occ_flat))
    lin_b = occ_lin[np.asarray(id_b)[hit_b]]
    assert np.array_equal(lin_b, np.asarray(lin_d)[hit_d])
    # ...and hit distances agree to a few ulp.  Separately compiled XLA
    # programs may contract the slab expression into FMAs differently;
    # grazing rays (tiny direction components) amplify that last-ulp
    # difference, so the bound is a small multiple of machine epsilon.
    tb = np.asarray(t_b)[hit_b]
    td = np.asarray(t_d)[hit_d]
    assert np.allclose(tb, td, rtol=2e-6, atol=0)


def test_dda_chunked_matches_monolithic(bunny_scene):
    """trace_grid_dda_chunked (the bounded-dispatch driver bench.py's
    exhaustiveness gate uses) returns the monolithic dda's results — tiny
    ray_chunk/seg_steps so the resume machinery actually exercises
    multiple segments and chunk boundaries."""
    from voxelray_tpu.ops.intersect import make_camera_rays
    from voxelray_tpu.ops.traverse import trace_grid_dda_chunked
    scene, grid = bunny_scene
    _, _, vi, pi = Camera().matrices(W, H)
    o, d = make_camera_rays(W, H, vi, pi)
    t_m, lin_m = trace_grid_dda(
        o, d, scene.occ_flat, scene.grid_origin, dims=scene.grid_dims,
        voxel_size_static=scene.grid_voxel_size)
    t_c, lin_c = trace_grid_dda_chunked(
        o, d, scene.occ_flat, scene.grid_origin, dims=scene.grid_dims,
        voxel_size_static=scene.grid_voxel_size,
        ray_chunk=1024, seg_steps=7)
    assert t_c.shape == (H, W) and lin_c.shape == (H, W)
    assert np.array_equal(np.asarray(lin_m), lin_c)
    hit = np.isfinite(np.asarray(t_m))
    assert np.array_equal(hit, np.isfinite(t_c))
    assert np.allclose(np.asarray(t_m)[hit], t_c[hit], rtol=2e-6, atol=0)


def test_render_images_match_across_backends(bunny_scene):
    scene, _ = bunny_scene
    a = np.asarray(render_scene(scene, Camera(), width=W, height=H,
                                backend="brute"))
    b = np.asarray(render_scene(scene, Camera(), width=W, height=H,
                                backend="dda"))
    assert np.abs(a - b).max() < 1e-6


def test_miss_pixels_are_dimmed_clear(bunny_scene):
    scene, _ = bunny_scene
    clear = (0.2, 0.4, 0.8, 1.0)
    img = np.asarray(render_scene(scene, Camera(), width=W, height=H,
                                  clear_color=clear))
    want = np.asarray([0.2, 0.4, 0.8]) * 0.8
    want = want ** (1 / 2.2)
    # top-left corner looks at the sky
    assert np.allclose(img[0, 0, :3], want, atol=1e-5)
    assert img[0, 0, 3] == 1.0


def test_voxels_render_with_default_yellow_material(bunny_scene):
    scene, _ = bunny_scene
    img = np.asarray(render_scene(scene, Camera(), width=W, height=H))
    # default MaterialObj diffuse is (1,1,0): voxel pixels have B << R,G
    mid = img[H // 3: H // 2, W // 3: 2 * W // 3]
    yellowish = (mid[..., 0] > 0.05) & (mid[..., 2] < 0.5 * mid[..., 0])
    assert yellowish.any(), "no yellow voxel pixels found"


def test_shadow_region_on_plane(bunny_scene, tmp_path):
    scene, _ = bunny_scene
    # light nearly overhead: the bunny must shadow part of the plane
    light = Light(position=(0.5, 50.0, 0.5), intensity=1000.0, type=0)
    with_vox = np.asarray(render_scene(scene, Camera(), width=W,
                                       height=H, light=light))
    # same plane, no voxel occluders
    p = tmp_path / "plane.obj"
    pv, pf = meshes.plane(20.0)
    write_obj(str(p), pv, pf)
    scene_nv = build_scene(models=[ObjLoader().load_model(str(p))])
    no_vox = np.asarray(render_scene(scene_nv, Camera(), width=W,
                                     height=H, light=light))
    lum_w = with_vox[..., :3].mean(-1)
    lum_n = no_vox[..., :3].mean(-1)
    # shadow pixels: plane visible in both, distinctly darker with voxels,
    # by exactly the 0.3-attenuation ratio after gamma
    ratio = np.where(lum_n > 0.1, lum_w / np.maximum(lum_n, 1e-6), 1.0)
    want = 0.3 ** (1 / 2.2)
    shadow_pixels = np.abs(ratio - want) < 0.02
    assert shadow_pixels.sum() > 5, "no 0.3-attenuated shadow pixels found"


def test_directional_light(bunny_scene):
    scene, _ = bunny_scene
    light = Light(position=(0.0, 1.0, 0.0), intensity=0.8, type=1)
    img = np.asarray(render_scene(scene, Camera(), width=W, height=H,
                                  light=light))
    assert np.isfinite(img).all()
    assert img.max() <= 1.5  # no 1/d^2 blowup


def test_voxel_only_scene():
    v, f = meshes.cube(2.0)
    grid = GridBool.from_mesh(v, f, 0.25)
    scene = build_scene(models=None, grid=grid)
    img = np.asarray(render_scene(scene, Camera(eye=(4, 3, -4)),
                                  width=W, height=H))
    assert np.isfinite(img).all()
    # some voxel pixels hit
    assert (np.abs(img[..., 2] - img[..., 0]) > 0.1).any()


def test_mesh_only_scene(tmp_path):
    p = tmp_path / "plane.obj"
    pv, pf = meshes.plane(20.0)
    write_obj(str(p), pv, pf)
    model = ObjLoader().load_model(str(p))
    scene = build_scene(models=[model])
    img = np.asarray(render_scene(scene, Camera(), width=W, height=H))
    assert np.isfinite(img).all()
    # lower half shows the plane, not the miss color
    miss = (np.asarray([1.0, 1.0, 1.0]) * 0.8) ** (1 / 2.2)
    assert not np.allclose(img[-1, W // 2, :3], miss, atol=1e-3)


def test_tiled_fast_render_matches_dda(bunny_scene):
    """The fast path at a frame size that used to take the (8, 128) tile
    order must produce the dda backend's image."""
    scene, grid = bunny_scene
    W, H = 128, 24
    cam = Camera()
    img_f = np.asarray(render_scene(scene, cam, width=W, height=H,
                                    backend="fast"))
    img_d = np.asarray(render_scene(scene, cam, width=W, height=H,
                                    backend="dda"))
    assert np.allclose(img_f, img_d, rtol=2e-5, atol=1e-6)
