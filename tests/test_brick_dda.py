"""brick_dda traversal kernel vs the plain dda reference.

The kernel runs in the Pallas interpreter here (tests/conftest.py turns
it on).  Every case must reproduce ops.traverse.trace_grid_dda: the same
hit mask and the same hit cells, t within the cross-program float
envelope (rtol 2e-6), and no ray still walking at the iteration bound.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from voxelray_tpu.ops.intersect import make_camera_rays
from voxelray_tpu.ops.pallas import brick_dda
from voxelray_tpu.ops.traverse import any_hit_grid_dda, trace_grid_dda
from voxelray_tpu.ops.traverse_fast import (BRICK, build_accel,
                                            build_accel_slab,
                                            trace_grid_fast,
                                            any_hit_grid_fast)
from voxelray_tpu.render.camera import Camera

DIMS = (150, 70, 97)            # > one 64-cell superbrick on every axis
VS = 0.05
ORIGIN = np.asarray([-3.0, -1.0, -2.0], np.float32)


def _grid(seed=0):
    """(Z, Y, X) occupancy mixing every level of the hierarchy: empty
    superbricks, empty bricks inside occupied superbricks, a thin shell,
    a wall, and isolated cells."""
    nx, ny, nz = DIMS
    rng = np.random.default_rng(seed)
    z, y, x = np.meshgrid(np.arange(nz), np.arange(ny), np.arange(nx),
                          indexing="ij")
    r = np.sqrt((x - 40) ** 2 + (y - 35) ** 2 + (z - 50) ** 2)
    occ = (np.abs(r - 18) < 1.2)
    occ |= (x == 131) & (y < 50) & (rng.random(occ.shape) < 0.6)
    occ |= rng.random(occ.shape) < 0.0005
    occ[::8, ::8, ::8] |= rng.random(occ[::8, ::8, ::8].shape) < 0.3
    return occ.astype(np.uint8)


def _camera(eye, center, w=64, h=48):
    _, _, vi, pi = Camera(eye=eye, center=center).matrices(w, h)
    o, d = make_camera_rays(w, h, vi, pi)
    return np.asarray(o).reshape(-1, 3), np.asarray(d).reshape(-1, 3)


def _unit(v):
    v = np.asarray(v, np.float32)
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def _center():
    return ORIGIN + 0.5 * VS * np.asarray(DIMS, np.float32)


def _random_rays(n, seed):
    rng = np.random.default_rng(seed)
    c = _center()
    o = c + rng.uniform(-6, 6, (n, 3)).astype(np.float32)
    return o.astype(np.float32), _unit(c - o + rng.normal(size=(n, 3)))


def case_random():
    o, d = _random_rays(777, 1)
    return dict(o=o, d=d)


def case_camera_tile():
    o, d = _camera((6.0, 2.5, -5.0), tuple(_center()))
    return dict(o=o, d=d)


def case_axis_aligned():
    rng = np.random.default_rng(2)
    c = _center()
    n = 384
    axis = rng.integers(0, 3, n)
    sign = np.where(rng.random(n) < 0.5, -1.0, 1.0)
    d = np.zeros((n, 3), np.float32)
    d[np.arange(n), axis] = sign
    # origins at cell centers (off every cell plane), outside the grid
    # along the ray axis
    cells = rng.integers(0, DIMS, (n, 3))
    o = (ORIGIN + (cells + 0.5) * VS).astype(np.float32)
    o[np.arange(n), axis] = c[axis] - sign * 6.0
    return dict(o=o.astype(np.float32), d=d)


def case_grazing():
    rng = np.random.default_rng(3)
    n = 512
    c = _center()
    d = np.zeros((n, 3), np.float32)
    main = rng.integers(0, 3, n)
    d[np.arange(n), main] = 1.0
    d += rng.normal(scale=1e-3, size=(n, 3)).astype(np.float32)
    d = _unit(d)
    o = (c + rng.uniform(-2.5, 2.5, (n, 3)) - 6.0 * d).astype(np.float32)
    return dict(o=o, d=d)


def case_inside():
    rng = np.random.default_rng(4)
    n = 600
    o = (ORIGIN + rng.uniform(0.05, 0.95, (n, 3))
         * VS * np.asarray(DIMS)).astype(np.float32)
    return dict(o=o, d=_unit(rng.normal(size=(n, 3))))


def case_per_ray_interval():
    o, d = _random_rays(640, 5)
    rng = np.random.default_rng(5)
    t_min = rng.uniform(0.001, 6.0, len(o)).astype(np.float32)
    t_max = (t_min + rng.uniform(0.0, 6.0, len(o))).astype(np.float32)
    return dict(o=o, d=d, t_min=t_min, t_max=t_max)


def case_admit():
    o, d = _camera((6.0, 2.5, -5.0), tuple(_center()), w=48, h=32)
    admit = np.random.default_rng(6).random(len(o)) < 0.5
    return dict(o=o, d=d, admit=admit)


def case_ragged_count():
    o, d = _random_rays(brick_dda.BLOCK * 3 + 37, 7)
    return dict(o=o, d=d)


def case_empty_grid():
    o, d = _random_rays(300, 8)
    return dict(o=o, d=d, occ=np.zeros(DIMS[::-1], np.uint8))


def case_full_grid():
    o, d = _camera((4.0, 1.0, -4.0), tuple(_center()), w=40, h=24)
    return dict(o=o, d=d, occ=np.ones(DIMS[::-1], np.uint8))


CASES = {f.__name__[5:]: f for f in (
    case_random, case_camera_tile, case_axis_aligned, case_grazing,
    case_inside, case_per_ray_interval, case_admit, case_ragged_count,
    case_empty_grid, case_full_grid)}


@pytest.fixture(scope="module")
def base_occ():
    return _grid()


def _dda(o, d, occ, t_min, t_max):
    nz, ny, nx = occ.shape
    t, lin = trace_grid_dda(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(occ.reshape(-1)),
        jnp.asarray(ORIGIN), dims=(nx, ny, nz), voxel_size_static=VS,
        t_min=t_min, t_max=t_max)
    return np.asarray(t), np.asarray(lin)


def _assert_same(t_f, lin_f, t_d, lin_d):
    hd = np.isfinite(t_d)
    assert np.array_equal(np.isfinite(t_f), hd)
    assert np.array_equal(lin_f, np.where(hd, lin_d, -1))
    assert np.allclose(t_f[hd], t_d[hd], rtol=2e-6, atol=0)


@pytest.mark.parametrize("name", list(CASES))
def test_matches_dda(name, base_occ):
    c = CASES[name]()
    occ = c.get("occ", base_occ)
    o, d = c["o"], c["d"]
    n = len(o)
    t_min = c.get("t_min", np.full(n, 0.001, np.float32))
    t_max = c.get("t_max", np.full(n, 10000.0, np.float32))
    accel = build_accel(occ, ORIGIN, VS)
    admit = c.get("admit")
    t_f, lin_f, unresolved = trace_grid_fast(
        jnp.asarray(o), jnp.asarray(d), accel, t_min=jnp.asarray(t_min),
        t_max=jnp.asarray(t_max),
        admit=None if admit is None else jnp.asarray(admit),
        return_stats=True)
    t_d, lin_d = _dda(o, d, occ, jnp.asarray(t_min), jnp.asarray(t_max))
    if admit is not None:
        t_d = np.where(admit, t_d, np.inf)
    assert int(unresolved) == 0
    _assert_same(np.asarray(t_f), np.asarray(lin_f), t_d, lin_d)
    if occ.any() and name not in ("admit",):
        assert np.isfinite(t_d).any()      # the case exercises hits


def test_slab_accel_with_offset(base_occ):
    """A Z-slab accel (fine_off > 0) traces its own slab's cells: the
    dda over the grid with every other slab emptied."""
    nz = base_occ.shape[0]
    z0, nzs = 40, 32
    accel = build_accel_slab(base_occ[z0:z0 + nzs], z0, nz, ORIGIN, VS)
    assert int(accel.fine_off) > 0
    o, d = _camera((6.0, 2.5, -5.0), tuple(_center()))
    only = np.zeros_like(base_occ)
    only[z0:z0 + nzs] = base_occ[z0:z0 + nzs]
    t_f, lin_f = trace_grid_fast(jnp.asarray(o), jnp.asarray(d), accel)
    t_d, lin_d = _dda(o, d, only, 0.001, 10000.0)
    assert np.isfinite(t_d).any()
    _assert_same(np.asarray(t_f), np.asarray(lin_f), t_d, lin_d)


def test_any_hit_matches_dda(base_occ):
    o, d = _random_rays(500, 9)
    t_max = np.random.default_rng(9).uniform(0.5, 8.0, len(o)) \
        .astype(np.float32)
    accel = build_accel(base_occ, ORIGIN, VS)
    occl = any_hit_grid_fast(jnp.asarray(o), jnp.asarray(d), accel,
                             t_max=jnp.asarray(t_max))
    nz, ny, nx = base_occ.shape
    ref = any_hit_grid_dda(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(base_occ.reshape(-1)),
        jnp.asarray(ORIGIN), dims=(nx, ny, nz), voxel_size_static=VS,
        t_max=jnp.asarray(t_max))
    assert np.array_equal(np.asarray(occl), np.asarray(ref))
    assert 0 < np.asarray(ref).sum() < len(o)


def test_accel_structure(base_occ):
    """coarse/l2 bits are max-pools of the occupancy; fine is brick-major
    (NB, 16) with cell (x, y, z) of a brick at bit x + 8y + 64z."""
    accel = build_accel(base_occ, ORIGIN, VS)
    nz, ny, nx = base_occ.shape
    bx, by, bz = accel.bdims
    assert accel.bdims == (-(-nx // 8), -(-ny // 8), -(-nz // 8))
    pad = np.zeros((bz * BRICK, by * BRICK, bx * BRICK), bool)
    pad[:nz, :ny, :nx] = base_occ.astype(bool)
    blocks = pad.reshape(bz, 8, by, 8, bx, 8).transpose(0, 2, 4, 1, 3, 5)
    pooled = blocks.reshape(bz, by, bx, -1).any(-1).reshape(-1)

    def bits(words, n):
        words = np.asarray(words)
        i = np.arange(n)
        return ((words[i >> 5] >> (i & 31)) & 1).astype(bool)

    assert np.array_equal(bits(accel.coarse, len(pooled)), pooled)
    fine = np.asarray(accel.fine)
    assert fine.shape == (bx * by * bz, 16)
    cells = blocks.reshape(-1, 512)
    assert np.array_equal(bits(fine.reshape(-1), cells.size),
                          cells.reshape(-1))
    sb = np.zeros((-(-bz // 8) * 8, -(-by // 8) * 8, -(-bx // 8) * 8), bool)
    sb[:bz, :by, :bx] = pooled.reshape(bz, by, bx)
    sb = sb.reshape(sb.shape[0] // 8, 8, sb.shape[1] // 8, 8,
                    sb.shape[2] // 8, 8).any(axis=(1, 3, 5)).reshape(-1)
    assert np.array_equal(bits(accel.l2, len(sb)), sb)


def test_walk_through_many_nonaccepting_bricks():
    """One corner cell in every brick: rays cross hundreds of occupied
    bricks whose cells they miss before the back wall accepts."""
    occ = np.zeros((64, 64, 64), np.uint8)
    occ[::8, ::8, ::8] = 1
    occ[60] = np.random.default_rng(7).random((64, 64)) < 0.5
    o, d = _camera((1.6, 1.7, -2.5), (1.6, 1.6, 1.6), w=48, h=32)
    accel = build_accel(occ, np.zeros(3, np.float32), 0.05)
    t_f, lin_f, unresolved = trace_grid_fast(
        jnp.asarray(o), jnp.asarray(d), accel, return_stats=True)
    t_d, lin_d = trace_grid_dda(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(occ.reshape(-1)),
        jnp.zeros(3, jnp.float32), dims=(64, 64, 64),
        voxel_size_static=0.05)
    assert int(unresolved) == 0
    assert np.isfinite(np.asarray(t_d)).mean() > 0.1
    _assert_same(np.asarray(t_f), np.asarray(lin_f), np.asarray(t_d),
                 np.asarray(lin_d))


def test_kernel_lowers_for_cuda(base_occ):
    """Cross-lower the kernel to Triton IR for the GPU: a primitive the
    Triton route cannot lower fails here, not on the card."""
    accel = build_accel(base_occ, ORIGIN, VS)
    n = 2 * brick_dda.BLOCK
    f32 = jnp.zeros((n,), jnp.float32)

    def run(x, acc):
        return brick_dda.brick_dda(
            x, x, x, x + 1, x, x, x, x + 1, acc.fine_off, acc.l2,
            acc.coarse, acc.fine, dims=acc.dims, bdims=acc.bdims,
            origin=acc.origin_key, voxel_size=acc.voxel_size,
            interpret=False)

    lowered = jax.jit(run).trace(f32, accel).lower(
        lowering_platforms=("cuda",))
    text = lowered.as_text()
    assert "triton" in text and "brick_dda" in text


def test_off_gpu_without_interpreter_raises(base_occ, monkeypatch):
    monkeypatch.setattr(brick_dda, "INTERPRET", False)
    accel = build_accel(base_occ, ORIGIN, VS)
    o, d = _random_rays(8, 10)
    with pytest.raises(RuntimeError, match="'cpu'"):
        trace_grid_fast(jnp.asarray(o), jnp.asarray(d), accel)


def test_camera_rays_match_numpy_f32():
    """Camera rays are float32-exact (precision pinned: a GPU may run an
    f32 matrix product in TF32, ~1e-3 relative)."""
    w, h = 40, 24
    cam = Camera(eye=(2.0, 1.5, -3.0), center=(0.1, 0.3, 0.2))
    _, _, vi, pi = cam.matrices(w, h)
    o, d = make_camera_rays(w, h, jnp.asarray(vi), jnp.asarray(pi))
    vi = np.asarray(vi, np.float32)
    pi = np.asarray(pi, np.float32)
    px = (np.arange(w, dtype=np.float32) + np.float32(0.5)) / np.float32(w) \
        * np.float32(2) - np.float32(1)
    py = (np.arange(h, dtype=np.float32) + np.float32(0.5)) / np.float32(h) \
        * np.float32(2) - np.float32(1)
    gx, gy = np.meshgrid(px, py)
    p = np.stack([gx, gy, np.ones_like(gx), np.ones_like(gx)], -1)
    tgt = (p @ pi.T)[..., :3]
    tgt = tgt / np.linalg.norm(tgt, axis=-1, keepdims=True)
    want = tgt @ vi[:3, :3].T
    assert np.allclose(np.asarray(d), want, rtol=1e-6, atol=1e-7)
    assert np.array_equal(np.asarray(o)[0, 0], vi[:3, 3])
