"""AABB extraction — the getAabbs() equivalents.

The reference walks its encodings on the CPU and emits a std::vector<Aabb>
(voxelgridBool.cpp:18-52 bit-scan, voxelgridAABBstruct.cpp:10-23 compaction,
voxelgridVecEncoding.cpp:16-19 passthrough).  Here extraction is a
prefix-sum compaction on device: ascending-linear-index order matches the
reference's linear sweeps exactly.

Dynamic result sizes don't exist under jit, so the jitted paths return a
padded (capacity, 6) buffer plus a count; the host wrappers trim.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["extract_aabbs_fixed", "extract_aabbs_words", "extract_aabbs",
           "aabbs_from_linear", "count_occupied", "count_nonzero_words",
           "count_nonzero_bytes", "count_nonzero_groups"]


def aabbs_from_linear(lin, dims, origin, voxel_size):
    """Linear cell indices -> (N, 6) AABBs [min|max], reference float math.

    Center = origin + (coords + 0.5) * voxelSize, corners = center -/+ half
    (voxelgridBool.cpp:34-43).
    """
    nx, ny, _ = dims
    lin = lin.astype(jnp.int32)
    x = lin % nx
    y = (lin // nx) % ny
    z = lin // (nx * ny)
    vs = jnp.float32(voxel_size)
    half = jnp.float32(0.5) * vs
    origin = jnp.asarray(origin, dtype=jnp.float32)
    cx = origin[0] + (x.astype(jnp.float32) + 0.5) * vs
    cy = origin[1] + (y.astype(jnp.float32) + 0.5) * vs
    cz = origin[2] + (z.astype(jnp.float32) + 0.5) * vs
    return jnp.stack(
        [cx - half, cy - half, cz - half, cx + half, cy + half, cz + half],
        axis=-1,
    )


@functools.partial(jax.jit, static_argnames=("capacity", "dims",
                                             "voxel_size_static",
                                             "word_capacity",
                                             "byte_capacity",
                                             "group_capacity",
                                             "stop_after"))
def extract_aabbs_fixed(occ, origin, *, capacity, dims, voxel_size_static,
                        word_capacity=None, byte_capacity=None,
                        group_capacity=None, stop_after=None):
    """Jitted compaction: occupancy (Z,Y,X) -> ((capacity, 6), count).

    Entries beyond `count` are zero.  Ordering is ascending linear index
    (x fastest), identical to the reference's sweep.  Cells beyond capacity
    are dropped (callers size capacity from count_occupied or mesh stats).

    Two-phase word compaction + rank-fill (the getAabbs analog of the
    reference's countr_zero word skip, voxelgridBool.cpp:18-52): a naive
    per-cell compaction pays one scatter update per GRID CELL.  Phase 1
    packs cells into u32 words and compacts the nonzero words
    (n/32 lanes); phase 2 scatters each nonzero byte at its global
    prefix-popcount rank and cummax-forward-fills the output, selecting
    each output row's bit with popcount arithmetic (4*word_capacity
    lanes — no per-bit lanes).

    word_capacity bounds the nonzero word count like capacity bounds the
    cell count — size it from stats (count_nonzero_words with slack);
    byte_capacity optionally bounds admitted nonzero bytes (kept for the
    tail-drop contract; it no longer sizes a buffer).  Undersizing any
    bound tail-drops cleanly with count > valid rows as the overflow
    signal.
    """
    flat = occ.reshape(-1).astype(bool)
    n = flat.shape[0]
    nw = max(1, -(-n // 32))
    shifts = jnp.arange(32, dtype=jnp.uint32)
    padded = jnp.pad(flat, (0, nw * 32 - n))
    words = (padded.reshape(nw, 32).astype(jnp.uint32) << shifts).sum(
        axis=1, dtype=jnp.uint32)
    return _extract_from_words(words, origin, capacity=capacity,
                               dims=dims,
                               voxel_size_static=voxel_size_static,
                               word_capacity=word_capacity,
                               byte_capacity=byte_capacity,
                               group_capacity=group_capacity,
                               stop_after=stop_after)


@functools.partial(jax.jit, static_argnames=("capacity", "dims",
                                             "voxel_size_static",
                                             "word_capacity",
                                             "byte_capacity",
                                             "group_capacity",
                                             "stop_after"))
def extract_aabbs_words(words, origin, *, capacity, dims,
                        voxel_size_static, word_capacity=None,
                        byte_capacity=None, group_capacity=None,
                        stop_after=None):
    """extract_aabbs_fixed taking the PACKED uint32 words directly
    (GridBool's native storage) — skips the unpack->repack round trip
    through a dense (Z,Y,X) uint8 volume (57 MB materialized in device
    memory at 512x228x490).  Bit order matches pack_bits: bit idx%32 of word idx/32,
    padding bits beyond the cell count zero."""
    return _extract_from_words(words, origin, capacity=capacity,
                               dims=dims,
                               voxel_size_static=voxel_size_static,
                               word_capacity=word_capacity,
                               byte_capacity=byte_capacity,
                               group_capacity=group_capacity,
                               stop_after=stop_after)


def _extract_from_words(words, origin, *, capacity, dims,
                        voxel_size_static, word_capacity, byte_capacity,
                        group_capacity, stop_after):
    nw = words.shape[0]
    if nw == 0:
        return jnp.zeros((capacity, 6), jnp.float32), jnp.int32(0)
    if word_capacity is None:
        word_capacity = capacity
    wcap = min(nw, word_capacity)
    # `count` is the FULL popcount (a reduction, not a prefix sum): it
    # must exceed the placed-row count when a capacity bound drops cells
    # — that's the caller's overflow signal.  All RANKS are computed
    # post-compaction instead (see phase 2a): the compactions preserve
    # ascending (word, byte) order and every dropped element is all-zero
    # or a tail, so prefix sums over the COMPACTED populations equal the
    # global prefix ranks, with no full-width popcount+cumsum pair and no
    # second rank scatter.
    count = jnp.sum(jax.lax.population_count(words).astype(jnp.int32))
    if stop_after == "pack":                      # profiling attribution
        return jnp.zeros((capacity, 6), jnp.float32), count

    # phase 1: compact nonzero-word INDICES (one scatter, nw updates).
    # With group_capacity set, a GROUP pre-compaction (phase 0) first
    # compacts nonzero 8-word groups (nw/8 scatter lanes + a row gather
    # of the survivors), so this word scatter runs on 8*gcap lanes
    # instead of nw — a win when nonzero words cluster (surface
    # occupancy does: ~2-4 nonzero groups per x-row).
    if group_capacity is not None:
        G = 8
        nwg = -(-nw // G)
        gcap = max(1, min(nwg, group_capacity))
        wg = jnp.pad(words, (0, nwg * G - nw)).reshape(nwg, G)
        gnz = jnp.max(wg, axis=1) != 0
        gpos = jnp.cumsum(gnz.astype(jnp.int32)) - 1
        gkeep = gnz & (gpos < gcap)
        gslot = jnp.where(gkeep, gpos, gcap)
        cgi = jnp.full((gcap,), nwg, jnp.int32).at[gslot].set(
            jnp.arange(nwg, dtype=jnp.int32), mode="drop")
        glive = cgi < nwg
        cgi_c = jnp.minimum(cgi, nwg - 1)
        cwg = jnp.where(glive[:, None], wg[cgi_c], 0)     # (gcap, G)
        src = cwg.reshape(-1)                             # (gcap*G,)
        src_idx = (cgi_c[:, None] * G
                   + jnp.arange(G, dtype=jnp.int32)).reshape(-1)
        nsrc = gcap * G
    else:
        src, src_idx, nsrc = words, None, nw
    nz = src != 0
    wpos = jnp.cumsum(nz.astype(jnp.int32)) - 1
    wkeep = nz & (wpos < wcap)
    wslot = jnp.where(wkeep, wpos, wcap)
    cwi = jnp.full((wcap,), nw, jnp.int32).at[wslot].set(
        src_idx if src_idx is not None
        else jnp.arange(nw, dtype=jnp.int32), mode="drop")
    wlive = cwi < nw
    cwi_c = jnp.minimum(cwi, nw - 1)
    # an ascending-index gather — both paths reuse it rather than
    # carrying values through a second scatter
    cw = jnp.where(wlive, words[cwi_c], 0)        # (wcap,) u32
    if stop_after == "p1":                        # profiling attribution
        return (jnp.zeros((capacity, 6), jnp.float32)
                .at[0, 0].set(cw.sum().astype(jnp.float32)), count)

    # phase 2: RANK-FILL.  A byte-compact + per-bit scatter would pay
    # 4*wcap + 8*bcap update lanes.  Instead, scatter each nonzero byte's packed
    # (byte_row << 8 | value) at its global prefix-popcount RANK START
    # (4*wcap lanes, the only scatter), then forward-fill with cummax:
    # byte_row strictly ascends with rank, so the running max at output
    # slot r is exactly the byte that owns rank r.  The in-run offset
    # k = r - run_start comes from a second cummax over run-boundary
    # positions, and the k-th set bit of the 8-bit value is selected
    # with three popcount-halving steps — no per-bit lanes at all.
    #
    # Packing fits uint32 for grids up to 2^27 cells (byte_row < 2^24):
    # enforced host-side below (the int32 packing this replaced silently
    # overflowed past 2^23 byte rows).
    if nw > (1 << 24):
        raise ValueError(
            f"extract_aabbs: grid has {nw * 32} cells; the uint32 "
            "rank-fill packing supports at most 2^27")
    byte_sh = jnp.arange(4, dtype=jnp.uint32) * 8
    bytes_ = ((cw[:, None] >> byte_sh) & 0xFF).astype(jnp.uint32)
    live = ((bytes_ != 0) & wlive[:, None]).reshape(-1)
    # byte_capacity bounds the number of NONZERO bytes admitted, like
    # word_capacity bounds nonzero words: bytes beyond it tail-drop
    # cleanly (nonzero-byte order IS ascending rank order), count >
    # valid rows stays the caller's overflow signal.  With the rank-fill
    # there is no byte buffer to size, so None (the default) skips the
    # bound and its cumsum entirely.
    if byte_capacity is not None:
        bnz_rank = jnp.cumsum(live.astype(jnp.int32)) - 1
        live = live & (bnz_rank < min(4 * wcap, max(1, byte_capacity)))
    bytes_flat = bytes_.reshape(-1)
    pops = jnp.where(
        live, jax.lax.population_count(bytes_flat).astype(jnp.int32), 0)
    rank_end = jnp.cumsum(pops)
    rank = rank_end - pops                       # global rank start/byte
    kept = rank_end[-1]
    byte_row = (cwi_c[:, None].astype(jnp.uint32) * 4
                + jnp.arange(4, dtype=jnp.uint32)[None, :]).reshape(-1)
    packed = (byte_row << 8) | bytes_flat
    idx = jnp.where(live & (rank < capacity), rank, capacity)
    fill = jnp.zeros((capacity,), jnp.uint32).at[idx].set(
        jnp.where(live, packed, 0), mode="drop")
    if stop_after == "p2a":                       # profiling attribution
        return (jnp.zeros((capacity, 6), jnp.float32)
                .at[0, 0].set(fill.sum().astype(jnp.float32)), count)

    fill = jax.lax.cummax(fill)
    pos = jnp.arange(capacity, dtype=jnp.int32)
    prev = jnp.roll(fill, 1)
    change = (pos == 0) | (fill != prev)
    runstart = jax.lax.cummax(jnp.where(change, pos, 0))
    k = pos - runstart                            # in-byte bit rank
    bval = (fill & 0xFF).astype(jnp.uint32)
    # k-th set bit of bval by popcount halving (k < popcount(bval) for
    # every valid row; garbage past `kept` is masked below)
    c4 = jax.lax.population_count(bval & 0xF).astype(jnp.int32)
    hi4 = k >= c4
    base = jnp.where(hi4, 4, 0)
    k = k - jnp.where(hi4, c4, 0)
    nib = (bval >> base.astype(jnp.uint32)) & 0xF
    c2 = jax.lax.population_count(nib & 0x3).astype(jnp.int32)
    hi2 = k >= c2
    base = base + jnp.where(hi2, 2, 0)
    k = k - jnp.where(hi2, c2, 0)
    pair = (bval >> base.astype(jnp.uint32)) & 0x3
    bitpos = base + jnp.where(k >= (pair & 1).astype(jnp.int32), 1, 0)
    out_lin = ((fill >> 8).astype(jnp.int32) * 8 + bitpos)
    aabbs = aabbs_from_linear(out_lin, dims, origin, voxel_size_static)
    # Cells from words/bytes dropped by an undersized bound are exactly
    # the TAIL ranks (compaction order is linear order), so clamping the
    # valid mask to the PLACED cell count gives the same clean tail-drop
    # semantics as a capacity overflow.  `count` is still the full
    # popcount: count > number of valid rows is the caller's overflow
    # signal for any bound.
    valid = pos < jnp.minimum(count, kept)
    return jnp.where(valid[:, None], aabbs, 0.0), count


def count_occupied(occ) -> int:
    return int(jnp.sum(occ.astype(jnp.int32)))


def count_nonzero_words(occ) -> int:
    """Number of nonzero 32-cell words in the flattened occupancy —
    the stats source for extract_aabbs_fixed's word_capacity (size it
    like capacity: from worst-case geometry, with slack)."""
    flat = np.asarray(occ).reshape(-1).astype(bool)
    if flat.size == 0:
        return 0
    nw = -(-flat.size // 32)
    words = np.packbits(
        np.pad(flat, (0, nw * 32 - flat.size)).reshape(nw, 32),
        axis=1, bitorder="little").view(np.uint32)[:, 0]
    return int((words != 0).sum())


def count_nonzero_groups(occ) -> int:
    """Number of nonzero 8-word (256-cell) groups — the stats source for
    extract_aabbs_fixed's group_capacity (phase-0 pre-compaction)."""
    flat = np.asarray(occ).reshape(-1).astype(bool)
    if flat.size == 0:
        return 0
    nw = -(-flat.size // 32)
    words = np.packbits(
        np.pad(flat, (0, nw * 32 - flat.size)).reshape(nw, 32),
        axis=1, bitorder="little").view(np.uint32)[:, 0]
    nwg = -(-nw // 8)
    groups = np.pad(words, (0, nwg * 8 - nw)).reshape(nwg, 8)
    return int((groups != 0).any(axis=1).sum())


def count_nonzero_bytes(occ) -> int:
    """Number of nonzero 8-cell bytes — the stats source for
    extract_aabbs_fixed's byte_capacity."""
    flat = np.asarray(occ).reshape(-1).astype(bool)
    if flat.size == 0:
        return 0
    nb = -(-flat.size // 8)
    bytes_ = np.packbits(
        np.pad(flat, (0, nb * 8 - flat.size)).reshape(nb, 8),
        axis=1, bitorder="little")[:, 0]
    return int((bytes_ != 0).sum())


def extract_aabbs(grid) -> np.ndarray:
    """Host-facing extraction from a voxelize_mesh result dict or grid
    object with occ/dims/origin/voxel_size: exact-size (N, 6) float32."""
    if isinstance(grid, dict):
        occ, dims = grid["occ"], grid["dims"]
        origin, vs = grid["origin"], grid["voxel_size"]
    else:
        occ, dims = grid.occ, grid.dims
        origin, vs = grid.origin, grid.voxel_size
    occ_np = np.asarray(occ).astype(bool)
    if occ_np.size == 0:
        return np.zeros((0, 6), np.float32)
    lin = np.flatnonzero(occ_np.reshape(-1)).astype(np.int32)
    if len(lin) == 0:
        return np.zeros((0, 6), np.float32)
    return np.asarray(
        aabbs_from_linear(jnp.asarray(lin), dims, origin, vs)
    )
