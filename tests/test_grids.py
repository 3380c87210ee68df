"""Grid encodings: packing, AABB extraction order/values, memory accounting."""
import jax.numpy as jnp
import numpy as np
import pytest

from voxelray_tpu.io import meshes
from voxelray_tpu.models.grids import (GridAabbStruct, GridBool, GridVec,
                                       build_grid, pack_bits, unpack_bits)
from voxelray_tpu.ops.aabbs import aabbs_from_linear
from voxelray_tpu.oracle import oracle_voxelize

VS = 0.12


@pytest.fixture(scope="module")
def sphere():
    v, f = meshes.icosphere(2)
    return v, f, oracle_voxelize(v, f, VS)


def test_pack_roundtrip():
    rng = np.random.default_rng(1)
    flat = rng.integers(0, 2, size=1000).astype(np.uint8)
    words = pack_bits(jnp.asarray(flat))
    assert words.shape[0] == -(-1000 // 32)
    back = np.asarray(unpack_bits(words, 1000))
    assert np.array_equal(back, flat)


def test_gridbool_bit_layout():
    # bit idx%32 of word idx/32, exactly like voxelgridBool.cpp:60-67
    flat = np.zeros(70, np.uint8)
    flat[0] = flat[33] = flat[69] = 1
    words = np.asarray(pack_bits(jnp.asarray(flat)))
    assert words[0] == 1
    assert words[1] == (1 << 1)
    assert words[2] == (1 << 5)


def test_gridbool(sphere):
    v, f, ref = sphere
    g = GridBool.from_mesh(v, f, VS)
    assert np.array_equal(np.asarray(g.occupancy()).astype(bool),
                          ref.occupancy)
    assert g.set_calls == ref.set_calls
    # memory: ceil(cells/32) * 4 bytes
    nx, ny, nz = g.dims
    assert g.memory_usage_bytes() == -(-(nx * ny * nz) // 32) * 4
    # aabb order == ascending linear index; values match the reference
    # float math to jit-fusion tolerance (XLA may contract the
    # origin+(i+0.5)*vs expression into FMAs differently per program)
    lin = np.flatnonzero(ref.occupancy.reshape(-1)).astype(np.int32)
    want = np.asarray(aabbs_from_linear(jnp.asarray(lin), ref.dims,
                                        ref.origin, VS))
    assert np.allclose(np.asarray(g.get_aabbs()), want, rtol=2e-6,
                       atol=1e-7)
    # fixed-capacity jit extraction agrees
    ab, cnt = g.get_aabbs_fixed(1 << 14)
    assert int(cnt) == len(lin)
    assert np.allclose(np.asarray(ab)[: len(lin)], want, rtol=2e-6,
                       atol=1e-7)


def test_gridbool_get_voxel_and_bounds(sphere):
    v, f, ref = sphere
    g = GridBool.from_mesh(v, f, VS)
    zyx = np.argwhere(ref.occupancy)[0]
    assert g.get_voxel(int(zyx[2]), int(zyx[1]), int(zyx[0]))
    with pytest.raises(IndexError):
        g.get_voxel(*g.dims)
    with pytest.raises(IndexError):
        g.get_coords(g.dims[0], 0, 0)


def test_gridaabbstruct(sphere):
    v, f, ref = sphere
    g = GridAabbStruct.from_mesh(v, f, VS)
    assert np.array_equal(np.asarray(g.occupancy()).astype(bool),
                          ref.occupancy)
    nx, ny, nz = g.dims
    assert g.memory_usage_bytes() == nx * ny * nz * 28
    lin = np.flatnonzero(ref.occupancy.reshape(-1)).astype(np.int32)
    want = np.asarray(aabbs_from_linear(jnp.asarray(lin), ref.dims,
                                        ref.origin, VS))
    assert np.allclose(np.asarray(g.get_aabbs()), want, rtol=2e-6,
                       atol=1e-7)


def test_gridvec_duplicates_and_order(sphere):
    v, f, ref = sphere
    g = GridVec.from_mesh(v, f, VS)
    # one AABB per setVoxel call, duplicates preserved
    assert g.aabbs.shape[0] == ref.set_calls == len(ref.hits)
    assert g.memory_usage_bytes() == ref.set_calls * 24
    # order == serial emission order (tri, then z, y, x)
    nx, ny, nz = ref.dims
    lin = (ref.hits[:, 1] + nx * (ref.hits[:, 2] + ny * ref.hits[:, 3])
           ).astype(np.int32)
    want = np.asarray(aabbs_from_linear(jnp.asarray(lin), ref.dims,
                                        ref.origin, VS))
    assert np.allclose(np.asarray(g.get_aabbs()), want, rtol=2e-6,
                       atol=1e-7)
    # occupancy derived from the vec equals the bitmask occupancy
    assert np.array_equal(np.asarray(g.occupancy()).astype(bool),
                          ref.occupancy)


def test_build_grid_dispatch(sphere):
    v, f, _ = sphere
    for enc, cls in [("bool", GridBool), ("aabbstruct", GridAabbStruct),
                     ("vec", GridVec)]:
        assert isinstance(build_grid(enc, v, f, VS), cls)
    with pytest.raises(ValueError):
        build_grid("nope", v, f, VS)


def test_two_phase_extraction_word_capacity():
    """extract_aabbs_fixed's two-phase path: a stats-sized word_capacity
    must reproduce the default path bit-exactly; ascending linear order
    is the reference contract (voxelgridBool.cpp:18-52)."""
    import numpy as np
    from voxelray_tpu.ops.aabbs import (aabbs_from_linear,
                                        count_nonzero_words,
                                        extract_aabbs_fixed)
    rng = np.random.default_rng(21)
    occ = (rng.random((12, 17, 33)) < 0.2).astype(np.uint8)
    dims = (33, 17, 12)
    origin = jnp.zeros(3, jnp.float32)
    nzw = count_nonzero_words(occ)
    lin_ref = np.flatnonzero(occ.reshape(-1).astype(bool)).astype(np.int32)
    ref = np.asarray(aabbs_from_linear(jnp.asarray(lin_ref), dims, origin,
                                       0.25))
    for wc in (None, nzw, nzw + 7, 1 << 14):
        a, c = extract_aabbs_fixed(jnp.asarray(occ), origin, capacity=4096,
                                   dims=dims, voxel_size_static=0.25,
                                   word_capacity=wc)
        assert int(c) == len(lin_ref)
        got = np.asarray(a)
        assert np.array_equal(got[: len(lin_ref)], ref)
        assert not got[len(lin_ref):].any()


def test_undersized_word_capacity_clean_tail_drop():
    """Regression: an UNDERSIZED word_capacity must
    tail-drop like a capacity overflow — the first `kept` rows valid and
    bit-exact, the rest zero (never cell-0 AABBs emitted as valid), with
    count still the full popcount as the overflow signal."""
    import numpy as np
    from voxelray_tpu.ops.aabbs import (aabbs_from_linear,
                                        count_nonzero_words,
                                        extract_aabbs_fixed)
    rng = np.random.default_rng(5)
    occ = (rng.random((9, 13, 29)) < 0.25).astype(np.uint8)
    dims = (29, 13, 9)
    origin = jnp.zeros(3, jnp.float32)
    nzw = count_nonzero_words(occ)
    lin_ref = np.flatnonzero(occ.reshape(-1).astype(bool)).astype(np.int32)
    ref = np.asarray(aabbs_from_linear(jnp.asarray(lin_ref), dims, origin,
                                       0.25))
    flat = occ.reshape(-1).astype(bool)
    nw = -(-flat.size // 32)
    words = np.packbits(
        np.pad(flat, (0, nw * 32 - flat.size)).reshape(nw, 32),
        axis=1, bitorder="little").view(np.uint32)[:, 0]
    pops = np.array([bin(w).count("1") for w in words])
    for wc in (1, nzw // 2, nzw - 1):
        if wc < 1:
            continue
        a, c = extract_aabbs_fixed(jnp.asarray(occ), origin, capacity=4096,
                                   dims=dims, voxel_size_static=0.25,
                                   word_capacity=wc)
        # cells of the first wc nonzero words, in linear order
        kept = int(pops[words != 0][:wc].sum())
        assert int(c) == len(lin_ref)        # overflow signal: c > valid
        got = np.asarray(a)
        assert np.array_equal(got[:kept], ref[:kept])
        assert not got[kept:].any()


def test_byte_capacity_tight_and_undersized():
    """Three-phase extraction: a stats-tight byte_capacity is exact; an
    undersized one tail-drops cleanly (count > valid rows signals)."""
    import numpy as np
    from voxelray_tpu.ops.aabbs import (aabbs_from_linear,
                                        count_nonzero_bytes,
                                        count_nonzero_words,
                                        extract_aabbs_fixed)
    rng = np.random.default_rng(9)
    occ = (rng.random((11, 9, 37)) < 0.3).astype(np.uint8)
    dims = (37, 9, 11)
    origin = jnp.zeros(3, jnp.float32)
    lin_ref = np.flatnonzero(occ.reshape(-1).astype(bool)).astype(np.int32)
    ref = np.asarray(aabbs_from_linear(jnp.asarray(lin_ref), dims, origin,
                                       0.2))
    nzw = count_nonzero_words(occ)
    nzb = count_nonzero_bytes(occ)
    # tight stats: exact
    a, c = extract_aabbs_fixed(jnp.asarray(occ), origin, capacity=4096,
                               dims=dims, voxel_size_static=0.2,
                               word_capacity=nzw, byte_capacity=nzb)
    assert int(c) == len(lin_ref)
    got = np.asarray(a)
    assert np.array_equal(got[: len(lin_ref)], ref)
    assert not got[len(lin_ref):].any()
    # undersized byte capacity: clean tail-drop, full count as signal
    a2, c2 = extract_aabbs_fixed(jnp.asarray(occ), origin, capacity=4096,
                                 dims=dims, voxel_size_static=0.2,
                                 word_capacity=nzw,
                                 byte_capacity=max(1, nzb // 2))
    assert int(c2) == len(lin_ref)
    got2 = np.asarray(a2)
    nz_rows = np.flatnonzero(got2.any(axis=1))
    kept = len(nz_rows)
    assert kept < len(lin_ref)
    assert np.array_equal(got2[:kept], ref[:kept])
    assert not got2[kept:].any()
