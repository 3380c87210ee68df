"""Octree traversal vs the grid DDA: identical hits on identical geometry."""
import jax.numpy as jnp
import numpy as np
import pytest

from voxelray_tpu.io import meshes
from voxelray_tpu.models.grids import GridBool
from voxelray_tpu.models.octree import Octree
from voxelray_tpu.ops.intersect import make_camera_rays
from voxelray_tpu.ops.octree_traverse import trace_octree
from voxelray_tpu.ops.traverse import trace_grid_dda
from voxelray_tpu.render.camera import Camera

VS = 0.11


@pytest.fixture(scope="module")
def setup():
    v, f = meshes.bunny_like(2)
    tree = Octree.from_mesh(v, f, VS)
    grid = GridBool.from_mesh(v, f, VS)
    return tree, grid


def test_octree_camera_rays_match_dda(setup):
    tree, grid = setup
    W, H = 64, 36
    _, _, vi, pi = Camera().matrices(W, H)
    o, d = make_camera_rays(W, H, vi, pi)
    # DDA over the octree's conceptual pow2 grid (same origin/voxel size)
    occ = np.asarray(grid.occupancy())
    t_d, lin_d = trace_grid_dda(
        o, d, jnp.asarray(occ.reshape(-1)), grid.origin,
        dims=grid.dims, voxel_size_static=grid.voxel_size)
    t_o, lin_o = trace_octree(o, d, tree)
    hd = np.isfinite(np.asarray(t_d))
    ho = np.isfinite(np.asarray(t_o))
    assert np.array_equal(hd, ho), f"{int((hd ^ ho).sum())} masks differ"
    # same cells: octree lin uses tree dims == grid dims
    assert tree.dims == grid.dims
    assert np.array_equal(np.asarray(lin_d)[hd], np.asarray(lin_o)[ho])
    assert np.allclose(np.asarray(t_d)[hd], np.asarray(t_o)[ho],
                       rtol=2e-6, atol=0)


def test_octree_random_rays(setup):
    tree, grid = setup
    rng = np.random.default_rng(11)
    n = 256
    o = jnp.asarray(rng.uniform(-3, 3, (n, 3)).astype(np.float32))
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d = jnp.asarray(d)
    occ = np.asarray(grid.occupancy())
    t_d, lin_d = trace_grid_dda(
        o, d, jnp.asarray(occ.reshape(-1)), grid.origin,
        dims=grid.dims, voxel_size_static=grid.voxel_size)
    t_o, lin_o = trace_octree(o, d, tree)
    hd = np.isfinite(np.asarray(t_d))
    ho = np.isfinite(np.asarray(t_o))
    assert np.array_equal(hd, ho)
    assert np.array_equal(np.asarray(lin_d)[hd], np.asarray(lin_o)[ho])


def test_octree_tmax_clipping(setup):
    tree, _ = setup
    # a ray that would hit, clipped short by t_max
    o = jnp.asarray([[5.0, 1.0, 0.0]])
    d = jnp.asarray([[-1.0, 0.0, 0.0]])
    t_full, _ = trace_octree(o, d, tree)
    assert np.isfinite(np.asarray(t_full))[0]
    t_clip, _ = trace_octree(o, d, tree, t_max=float(
        np.asarray(t_full)[0]) - 0.5)
    assert not np.isfinite(np.asarray(t_clip))[0]


def test_flat_path_matches_descent(setup):
    """The flattened region-map path (the default for bits <= 8) and the
    while-loop child-link descent visit the same regions with the same
    float math — results must be identical, not just close."""
    import dataclasses

    tree, _ = setup
    assert tree.region_map is not None    # bits <= 8 here
    tree_nomap = dataclasses.replace(tree, region_map=None, items4=None)
    rng = np.random.default_rng(23)
    n = 512
    o = jnp.asarray(rng.uniform(-3, 3, (n, 3)).astype(np.float32))
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d = jnp.asarray(d)
    t_f, lin_f = trace_octree(o, d, tree)
    t_s, lin_s = trace_octree(o, d, tree_nomap)
    assert np.array_equal(np.asarray(lin_f), np.asarray(lin_s))
    hf = np.isfinite(np.asarray(t_f))
    assert np.array_equal(hf, np.isfinite(np.asarray(t_s)))
    assert np.array_equal(np.asarray(t_f)[hf], np.asarray(t_s)[hf])


def test_coarse_region_map_matches_full(setup):
    """A COARSE region map (map_bits < bits — the 512^3+ configuration)
    routes INTERNAL entries through the residual
    child-link chase; results must be identical to the full dense map
    AND the pure while-loop descent."""
    import dataclasses

    from voxelray_tpu.models.octree import build_region_map

    tree, _ = setup
    bits = tree.bits_per_axis
    assert bits >= 3
    ch = np.asarray(tree.children)
    for mb in (bits - 1, bits - 2, 2):
        rm = build_region_map(ch, bits, mb)
        assert rm.shape == ((1 << mb) ** 3,)
        tree_c = dataclasses.replace(tree, region_map=jnp.asarray(rm),
                                     map_bits=mb)
        rng = np.random.default_rng(37 + mb)
        n = 512
        o = jnp.asarray(rng.uniform(-3, 3, (n, 3)).astype(np.float32))
        d = rng.normal(size=(n, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        d = jnp.asarray(d)
        t_c, lin_c = trace_octree(o, d, tree_c)
        t_f, lin_f = trace_octree(o, d, tree)
        assert np.array_equal(np.asarray(lin_c), np.asarray(lin_f)), mb
        hf = np.isfinite(np.asarray(t_f))
        assert np.array_equal(hf, np.isfinite(np.asarray(t_c)))
        assert np.array_equal(np.asarray(t_c)[hf], np.asarray(t_f)[hf])


def test_region_map_partitions_cube(setup):
    """Every cell belongs to exactly one region; leaves point at real
    leaf nodes whose region cube matches the node's Morton range."""
    from voxelray_tpu.models.octree import LEAF_FLAG, build_region_map

    tree, _ = setup
    bits = tree.bits_per_axis
    side = 1 << bits
    m = np.asarray(tree.region_map)
    assert m.shape == (side ** 3,)
    ch = np.asarray(tree.children)
    is_leaf = (ch < 0).all(axis=1)
    leaf_cells = m >= np.int32(LEAF_FLAG)
    nodes = (m[leaf_cells] >> 5) & ((1 << 25) - 1)
    assert is_leaf[nodes].all()
    # every occupied cell must map to a leaf containing it
    ix = np.asarray(tree.item_x)
    iy = np.asarray(tree.item_y)
    iz = np.asarray(tree.item_z)
    lin = ix + side * (iy + side * iz)
    assert (m[lin] >= np.int32(LEAF_FLAG)).all()


def test_checkpoint_rebuilds_region_map(setup, tmp_path):
    from voxelray_tpu.utils.checkpoint import load_grid, save_grid

    tree, _ = setup
    p = str(tmp_path / "tree.npz")
    save_grid(p, tree)
    tree2 = load_grid(p)
    assert tree2.region_map is not None
    assert np.array_equal(np.asarray(tree2.region_map),
                          np.asarray(tree.region_map))
    _, _, vi, pi = Camera().matrices(32, 24)
    o, d = make_camera_rays(32, 24, vi, pi)
    t_a, lin_a = trace_octree(o, d, tree)
    t_b, lin_b = trace_octree(o, d, tree2)
    assert np.array_equal(np.asarray(lin_a), np.asarray(lin_b))
