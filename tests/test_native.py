"""Native C++ runtime vs Python/oracle implementations (skipped if the
toolchain is unavailable)."""
import os

import numpy as np
import pytest

from voxelray_tpu import native as vn
from voxelray_tpu.io import meshes
from voxelray_tpu.io.objload import load_mesh, write_obj
from voxelray_tpu.models.octree import build_nodes
from voxelray_tpu.ops.morton import morton_encode3_np
from voxelray_tpu.oracle import oracle_voxelize

pytestmark = pytest.mark.skipif(not vn.available(),
                                reason="native lib not built")


def test_parse_obj_matches_python(tmp_path):
    v, f = meshes.bunny_like(2)
    p = tmp_path / "b.obj"
    write_obj(str(p), v, f)
    nv, nf = vn.parse_obj_native(str(p))
    raw = load_mesh(str(p))
    assert np.allclose(nv, raw.vertices)
    assert np.array_equal(nf, raw.faces)


def test_parse_obj_negative_indices_and_quads(tmp_path):
    p = tmp_path / "q.obj"
    p.write_text("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nf -4 -3 -2 -1\n")
    nv, nf = vn.parse_obj_native(str(p))
    assert nf.tolist() == [[0, 1, 2], [0, 2, 3]]


def test_native_voxelize_bitexact():
    v, f = meshes.bunny_like(2)
    ref = oracle_voxelize(v, f, 0.11)
    occ, calls = vn.voxelize_native(v, f, 0.11, ref.origin, ref.dims)
    assert np.array_equal(occ.astype(bool), ref.occupancy)
    assert calls == ref.set_calls


def test_native_voxelize_cube_quirks():
    # the max-boundary-drop quirk must survive in the native path too
    v, f = meshes.cube(2.0)
    ref = oracle_voxelize(v, f, 2.0 / 16)
    occ, calls = vn.voxelize_native(v, f, 2.0 / 16, ref.origin, ref.dims)
    assert np.array_equal(occ.astype(bool), ref.occupancy)
    assert calls == ref.set_calls


def test_native_morton_and_sort():
    rng = np.random.default_rng(3)
    x = rng.integers(0, 1 << 21, 5000, dtype=np.uint32)
    y = rng.integers(0, 1 << 21, 5000, dtype=np.uint32)
    z = rng.integers(0, 1 << 21, 5000, dtype=np.uint32)
    got = vn.morton_encode_native(x, y, z)
    want = morton_encode3_np(x.astype(np.uint64), y.astype(np.uint64),
                             z.astype(np.uint64))
    assert np.array_equal(got, want)
    assert np.array_equal(vn.sort_codes_native(got), np.sort(want))


@pytest.mark.parametrize("seed,n,depth,mi", [(0, 500, 4, 8), (1, 4000, 6, 16),
                                             (2, 64, 2, 1)])
def test_native_octree_nodes(seed, n, depth, mi):
    rng = np.random.default_rng(seed)
    codes = np.sort(rng.integers(0, 1 << (3 * depth), n, dtype=np.uint64))
    got = vn.build_octree_nodes_native(codes, depth, mi)
    want = build_nodes(codes, depth, mi)
    assert np.array_equal(got, want)


def test_library_is_stale_when_missing_or_older_than_source(tmp_path):
    src, lib = tmp_path / "v.cpp", tmp_path / "v.so"
    src.write_text("//")
    assert vn._stale(str(src), str(lib))          # missing
    lib.write_text("")
    os.utime(lib, (1_000, 1_000))
    os.utime(src, (2_000, 2_000))
    assert vn._stale(str(src), str(lib))          # source is newer
    os.utime(lib, (3_000, 3_000))
    assert not vn._stale(str(src), str(lib))
