"""Mesh voxelization on the device.

The reference voxelizes on the CPU: per triangle, a clamped voxel window is
scanned with a triple loop and a SAT test per cell (VoxelBuilder.hpp:164-196
serial, :422-537 threaded).  Here the same math becomes one data-parallel
XLA computation:

  * every triangle enumerates a *static-shape* window box (WX, WY, WZ) of
    candidate cells — the reference's dynamic `for z,y,x` nest becomes a
    static unravel of k in [0, WX*WY*WZ) plus per-axis masks
    dx < wx, dy < wy, dz < wz against the triangle's true clamped window
    (static divisors keep XLA's integer lowering cheap on every backend),
  * the 13-axis SAT runs vectorized over (triangles x cells),
  * hits scatter (constant value 1, promise_in_bounds, misses routed to
    a trash slot) into a dense occupancy volume — the deterministic
    equivalent of the thread-bucket merge at VoxelBuilder.hpp:533-537.

The computation is chunked over triangles with a lax.scan to bound peak
memory; the window shape is a static argument so the kernel is jittable
and reusable across frames (per-frame re-voxelization of a deforming mesh
never leaves the device).  The host wrapper buckets triangles by per-axis
window extent so a few huge triangles don't drag every small one through
a giant window.

Occupancy is bit-exact vs. oracle.oracle_voxelize: identical window
truncation (including the max-boundary drop quirk), identical f32
expression shapes.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .sat import tri_box_overlap

__all__ = [
    "voxelize_dense",
    "voxelize_mesh",
    "window_bounds",
    "required_window_shape",
    "plan_buckets",
    "VoxelizePlan",
    "plan_voxelize",
    "voxelize_planned",
]


def window_bounds(tri_min, tri_max, origin, voxel_size, dims):
    """Per-triangle clamped cell windows, the VoxelBuilder.hpp:175-184 math.

    tri_min/tri_max: (..., 3) float32 triangle bounds.  Returns
    (start, end): int32 arrays, start >= 0, end <= dims, with the
    reference's float-divide + truncate-toward-zero + `+2` slack.
    """
    origin = jnp.asarray(origin, dtype=jnp.float32)
    vs = jnp.float32(voxel_size)
    dims_arr = jnp.asarray(dims, dtype=jnp.int32)
    start = jnp.maximum(
        0, ((tri_min - origin) / vs).astype(jnp.int32)
    )
    end = jnp.minimum(
        dims_arr, ((tri_max - origin) / vs).astype(jnp.int32) + 2
    )
    return start, end


def _np_windows(vertices, faces, origin, voxel_size, dims):
    """Host-side per-triangle (start, end) with the exact reference math."""
    v = np.asarray(vertices, dtype=np.float32)
    f = np.asarray(faces)
    tri = v[f]
    tmin = tri.min(axis=1)
    tmax = tri.max(axis=1)
    origin = np.asarray(origin, dtype=np.float32)
    vs = np.float32(voxel_size)
    dims_arr = np.asarray(dims, dtype=np.int32)
    start = np.maximum(0, ((tmin - origin) / vs).astype(np.int32))
    end = np.minimum(dims_arr, ((tmax - origin) / vs).astype(np.int32) + 2)
    return start, np.maximum(end, start)


def _np_effective_extents(vertices, faces, origin, voxel_size, dims):
    """Per-triangle tested-window extents with provably-dead slabs cut.

    The reference's window end is trunc(max/vs)+2 (VoxelBuilder.hpp:
    175-184): for a triangle whose max is strictly inside cell t, the
    final slab t+1 can never pass the SAT's box-axis test — separation
    there is `tmax - center < -half` (sat.py box axes; max(v - c) equals
    max(v) - c exactly in float), so every cell of that slab is SAT-false
    and skipping it changes neither occupancy nor set_calls.  The test is
    evaluated HERE in the same f32 expression shapes the device kernel
    uses, with a 16-ulp margin absorbing FMA-contraction drift between
    backends: slabs are excluded only when separation holds by a wide
    float margin, borderline triangles keep the full reference window
    (and the SAT decides, identically to the reference).  Measured on
    the 1M-tri bench mesh: 38.3M -> 12.9M tested slots (2.96x).

    Returns (start, w_eff): int32 (F, 3) arrays, w_eff >= 1.
    """
    start, end = _np_windows(vertices, faces, origin, voxel_size, dims)
    v = np.asarray(vertices, np.float32)
    tmax = v[np.asarray(faces)].max(axis=1).astype(np.float32)
    w_eff = np.maximum(end - start, 1).astype(np.int32)
    origin = np.asarray(origin, np.float32)
    vs = np.float32(voxel_size)
    h = np.float32(voxel_size * 0.5)
    eps = np.float32(2 ** -23)
    for ax in range(3):
        for _ in range(2):   # reference slack is at most 2 slabs
            last = (start[:, ax] + w_eff[:, ax] - 1).astype(np.float32)
            c = (origin[ax] + (last + np.float32(0.5)) * vs) \
                .astype(np.float32)
            t = (tmax[:, ax] - c).astype(np.float32)
            margin = 16 * eps * np.maximum(
                np.maximum(np.abs(c), np.abs(tmax[:, ax])), vs)
            sep = (t < -h - margin) & (w_eff[:, ax] > 1)
            if not sep.any():
                break
            w_eff[sep, ax] -= 1
    return start, w_eff


def required_window_shape(vertices, faces, origin, voxel_size, dims):
    """Max per-axis window extent over all triangles (host-side numpy).

    Drives the static window shape for voxelize_dense.  For animated meshes
    call once with worst-case geometry and reuse the shape so the jitted
    kernel never recompiles.
    """
    f = np.asarray(faces)
    if len(f) == 0:
        return (1, 1, 1)
    start, end = _np_windows(vertices, faces, origin, voxel_size, dims)
    w = (end - start).max(axis=0)
    return (max(1, int(w[0])), max(1, int(w[1])), max(1, int(w[2])))


def _chunk_hits(tri, origin, vs, half, dims, window, with_rank=False):
    """SAT-hit mask for one triangle chunk over its static window box.

    tri: (chunk, 3, 3) f32.  Returns (hit, lin, w) — and the serial rank
    within the true window when with_rank.  The exact reference math
    (VoxelBuilder.hpp:164-196): per-triangle clamped window, static
    unravel, 13-axis SAT — shared by voxelize_dense and the fused
    planned path so the f32 expression shapes stay identical.
    """
    nx, ny, nz = dims
    wx_c, wy_c, wz_c = window
    capacity = wx_c * wy_c * wz_c
    k = np.arange(capacity)
    dx = jnp.asarray((k % wx_c).astype(np.int32))
    dy = jnp.asarray(((k // wx_c) % wy_c).astype(np.int32))
    dz = jnp.asarray((k // (wx_c * wy_c)).astype(np.int32))

    v0, v1, v2 = tri[:, 0], tri[:, 1], tri[:, 2]
    tmin = jnp.minimum(v0, jnp.minimum(v1, v2))
    tmax = jnp.maximum(v0, jnp.maximum(v1, v2))
    # empty-window guard for padded/degenerate triangles
    finite = jnp.isfinite(tmin).all(axis=-1)
    tmin = jnp.where(finite[:, None], tmin, 0.0)
    tmax = jnp.where(finite[:, None], tmax, -1.0)
    start, end = window_bounds(tmin, tmax, origin, vs, (nx, ny, nz))
    w = jnp.maximum(end - start, 0)  # (chunk, 3) true window extents
    w = jnp.where(finite[:, None], w, 0)

    inside = (
        (dx[None, :] < w[:, 0:1])
        & (dy[None, :] < w[:, 1:2])
        & (dz[None, :] < w[:, 2:3])
    )  # (chunk, capacity)

    cx = start[:, 0:1] + dx[None, :]
    cy = start[:, 1:2] + dy[None, :]
    cz = start[:, 2:3] + dz[None, :]

    centers = jnp.stack(
        [
            origin[0] + (cx.astype(jnp.float32) + 0.5) * vs,
            origin[1] + (cy.astype(jnp.float32) + 0.5) * vs,
            origin[2] + (cz.astype(jnp.float32) + 0.5) * vs,
        ],
        axis=-1,
    )  # (chunk, capacity, 3)

    hit = inside & tri_box_overlap(
        centers, half, v0[:, None, :], v1[:, None, :], v2[:, None, :]
    )
    lin = cx + nx * (cy + ny * cz)  # (chunk, capacity)
    if with_rank:
        rank = (dz[None, :] * w[:, 1:2] + dy[None, :]) * w[:, 0:1] \
            + dx[None, :]
        return hit, lin, w, rank
    return hit, lin, w


def _scatter_bucket(occ_acc, calls, tri_verts, origin, vs, half, dims,
                    window, chunk):
    """Flat-scatter one bucket's SAT hits into the shared trash-slot
    occupancy buffer (static chunk loop, straight-line under jit)."""
    n_cells = dims[0] * dims[1] * dims[2]
    f_total = tri_verts.shape[0]
    n_chunks = max(1, -(-f_total // chunk))
    pad = n_chunks * chunk - f_total
    tri_verts = jnp.pad(tri_verts, ((0, pad), (0, 0), (0, 0)),
                        constant_values=np.inf)
    tri_chunks = tri_verts.reshape(n_chunks, chunk, 3, 3)

    def body(carry, tri):
        occ_acc, calls = carry
        hit, lin, _ = _chunk_hits(tri, origin, vs, half, dims, window)
        lin_t = jnp.where(hit, lin, n_cells)
        occ_acc = occ_acc.at[lin_t.reshape(-1)].set(
            jnp.uint8(1), mode="promise_in_bounds")
        return (occ_acc, calls + hit.sum(dtype=jnp.int32)), None

    (occ_acc, calls), _ = jax.lax.scan(body, (occ_acc, calls), tri_chunks)
    return occ_acc, calls


@functools.partial(
    jax.jit,
    static_argnames=("dims", "voxel_size_static", "layout", "count_only"),
)
def _voxelize_fused(v, faces_sorted, origin, *, dims, voxel_size_static,
                    layout, count_only=False):
    """ONE program for every bucket: shared trash-slot buffer, one vertex
    gather, no per-bucket dispatch or occupancy-merge chain.

    layout: static tuple of (offset, count, window, chunk) — bucket b's
    triangles are faces_sorted[offset : offset+count] (plan-time order).
    count_only=True skips the occupancy scatter (profiling attribution).
    """
    nx, ny, nz = dims
    n_cells = nx * ny * nz
    vs = jnp.float32(voxel_size_static)
    half = jnp.float32(voxel_size_static * 0.5)
    origin = jnp.asarray(origin, jnp.float32)
    occ_acc = jnp.zeros((max(n_cells, 1) + 1,), jnp.uint8)
    calls = jnp.int32(0)
    tri_all = v[faces_sorted]  # one gather covers every bucket
    for off, cnt, win, chunk in layout:
        tri = jax.lax.slice_in_dim(tri_all, off, off + cnt)
        if count_only:
            f_total = tri.shape[0]
            n_chunks = max(1, -(-f_total // chunk))
            pad = n_chunks * chunk - f_total
            trip = jnp.pad(tri, ((0, pad), (0, 0), (0, 0)),
                           constant_values=np.inf)
            for c in range(n_chunks):
                hit, _, _ = _chunk_hits(
                    trip.reshape(n_chunks, chunk, 3, 3)[c], origin, vs,
                    half, dims, win)
                calls = calls + hit.sum(dtype=jnp.int32)
        else:
            occ_acc, calls = _scatter_bucket(
                occ_acc, calls, tri, origin, vs, half, dims, win, chunk)
    return occ_acc[:n_cells].reshape(nz, ny, nx), calls


@functools.partial(
    jax.jit,
    static_argnames=("dims", "voxel_size_static", "window", "chunk",
                     "with_hit_mask", "scatter"),
)
def voxelize_dense(tri_verts, origin, *, dims, voxel_size_static, window,
                   chunk=4096, with_hit_mask=False, scatter="auto"):
    """Voxelize triangles into a dense occupancy volume.

    tri_verts: (F, 3, 3) float32 world-space triangle vertices.
    origin:    (3,) float32 grid min corner.
    dims:      static (X, Y, Z) cell counts.
    voxel_size_static: static float cell edge.
    window:    static (WX, WY, WZ) per-triangle window box; triangles whose
               clamped window exceeds it on any axis are truncated — callers
               pick it from required_window_shape(...).
    chunk:     static triangle chunk size for the scan (memory knob).
    with_hit_mask: also return per-(triangle, slot) hit mask, linear cell
               index, and the serial-order rank within the triangle's true
               window — needed by the duplicate-preserving Vec encoding.
    scatter:   "flat" = one scatter element per (triangle, window slot)
               into the flattened volume; "window" = ONE scatter index
               per triangle writing its dense (WZ, WY, WX) hit-mask
               block via lax.scatter_max into a window-padded volume.
               Window has ~WX*WY*WZ x fewer scatter indices; "auto" =
               flat (the GPU A/B is not measured yet), "window" remains
               for that A/B.  Both produce identical occupancy (max over
               {0,1} hits == OR).

    Returns occ (Z, Y, X) uint8 in {0,1}, set_calls (int32 scalar: total
    SAT hits including duplicates — the reference's m_voxelSet counter),
    and optionally (hit_mask, hit_lin, hit_rank).
    """
    if scatter == "auto":
        scatter = "flat"
    nx, ny, nz = dims
    wx_c, wy_c, wz_c = window
    capacity = wx_c * wy_c * wz_c
    n_cells = nx * ny * nz
    vs = jnp.float32(voxel_size_static)
    half = jnp.float32(voxel_size_static * 0.5)
    origin = jnp.asarray(origin, dtype=jnp.float32)

    f_total = tri_verts.shape[0]
    n_chunks = max(1, -(-f_total // chunk))
    f_padded = n_chunks * chunk
    pad = f_padded - f_total
    # Padded triangles get +inf vertices: their window is empty.
    tri_verts = jnp.pad(tri_verts, ((0, pad), (0, 0), (0, 0)),
                        constant_values=np.inf)
    # chunks run as a lax.scan: one compiled body however many chunks
    # (an unrolled chunk loop at 1M triangles took ~10 min to compile)
    tri_chunks = tri_verts.reshape(n_chunks, chunk, 3, 3)

    def body(carry, tri):
        occ_acc, calls = carry
        hit, lin, w, rank = _chunk_hits(tri, origin, vs, half,
                                        (nx, ny, nz), window,
                                        with_rank=True)
        if scatter == "window":
            tmin = jnp.minimum(tri[:, 0],
                               jnp.minimum(tri[:, 1], tri[:, 2]))
            finite = jnp.isfinite(tmin).all(axis=-1)
            tmin = jnp.where(finite[:, None], tmin, 0.0)
            tmax = jnp.maximum(tri[:, 0],
                               jnp.maximum(tri[:, 1], tri[:, 2]))
            tmax = jnp.where(finite[:, None], tmax, -1.0)
            start, _ = window_bounds(tmin, tmax, origin, vs, (nx, ny, nz))
            # ONE scatter index per triangle: its dense hit-mask block
            # max-combines (== OR for {0,1}) into the padded volume.
            # The capacity unravel is x-fastest, so the block reshapes
            # directly to (WZ, WY, WX).
            upd = hit.astype(jnp.uint8).reshape(-1, wz_c, wy_c, wx_c)
            idx = jnp.stack([start[:, 2], start[:, 1], start[:, 0]],
                            axis=-1)
            dnums = jax.lax.ScatterDimensionNumbers(
                update_window_dims=(1, 2, 3), inserted_window_dims=(),
                scatter_dims_to_operand_dims=(0, 1, 2))
            occ_acc = jax.lax.scatter_max(
                occ_acc, idx, upd, dnums, indices_are_sorted=False,
                unique_indices=False,
                mode=jax.lax.GatherScatterMode.CLIP)
        else:
            # misses write into the trash slot at the end of the buffer;
            # all real writes are the constant 1, so `set` is
            # deterministic and cheaper than `max`
            lin_t = jnp.where(hit, lin, n_cells)
            occ_acc = occ_acc.at[lin_t.reshape(-1)].set(
                jnp.uint8(1), mode="promise_in_bounds")
        calls = calls + hit.sum(dtype=jnp.int32)
        if with_hit_mask:
            # rank: serial order within the triangle's true window,
            # (dz*wy + dy)*wx + dx — computed in _chunk_hits
            lin_m = jnp.where(hit, lin, n_cells)
            return (occ_acc, calls), (hit, lin_m, rank)
        return (occ_acc, calls), None

    if scatter == "window":
        carry = (jnp.zeros((nz + wz_c, ny + wy_c, nx + wx_c),
                           dtype=jnp.uint8), jnp.int32(0))
    else:
        # one extra trash slot absorbs the miss writes
        carry = (jnp.zeros((max(n_cells, 1) + 1,), dtype=jnp.uint8),
                 jnp.int32(0))
    (occ_acc, calls), extras = jax.lax.scan(body, carry, tri_chunks)
    if scatter == "window":
        occ = occ_acc[:nz, :ny, :nx]
    else:
        occ = occ_acc[:n_cells].reshape(nz, ny, nx)
    if with_hit_mask:
        hit, lin, rank = (e.reshape((f_padded,) + e.shape[2:])[:f_total]
                          for e in extras)
        return occ, calls, hit, lin, rank
    return occ, calls


def plan_buckets(vertices, faces, origin, voxel_size, dims,
                 max_buckets: int = 6, effective: bool = True):
    """Group triangles by EXACT per-axis window extents.

    Returns [(window_shape, tri_indices), ...].  Greedy merge (smallest
    groups absorbed into their elementwise-max shape, preferring the
    merge with the least wasted slot volume) keeps the number of distinct
    compiled kernel variants bounded.

    Every (triangle, window-slot) pair costs one scatter slot whether or
    not the SAT hits, so a single global max window (6, 4, 6) made 1M
    small triangles pay 144 slots each when their exact windows average
    ~12.  Exact-shape buckets cut slot count ~10x; pow2 rounding (the old
    scheme) gave back a factor ~3 of that.
    """
    f = np.asarray(faces)
    if len(f) == 0:
        return []
    # bucket by EFFECTIVE extents (dead final slabs cut — see
    # _np_effective_extents): the device kernel still masks candidates
    # with its own reference window math (`dx < w_true`), so a bucket
    # shape below the reference extent merely skips slabs proven
    # SAT-false, and any merge-widening above it is re-clipped by that
    # mask.  Occupancy, set_calls, and Vec ranks are unchanged (ranks
    # are mixed-radix in the TRUE window, monotone in (dz, dy, dx)).
    # The cut is proven for THESE vertices only — effective=False
    # buckets by the full reference windows instead, the shape a plan
    # must use when it will be re-executed against deformed vertices
    # (review r3: a deformation can stay within the reference window's
    # trunc+2 slack yet outgrow the cut slab).
    if effective:
        start, w = _np_effective_extents(vertices, faces, origin,
                                         voxel_size, dims)
    else:
        start, end = _np_windows(vertices, faces, origin, voxel_size,
                                 dims)
        w = np.maximum(end - start, 1).astype(np.int32)
    keys, inverse, counts = np.unique(w, axis=0, return_inverse=True,
                                      return_counts=True)
    order = np.argsort(inverse, kind="stable")
    bounds = np.cumsum(counts)[:-1]
    groups = np.split(order, bounds)  # group g = tri indices of keys[g]
    items = [(tuple(int(x) for x in keys[g]), list(groups[g]))
             for g in range(len(keys))]
    items.sort(key=lambda kv: -len(kv[1]))
    while len(items) > max_buckets:
        # absorb the smallest group into whichever other group wastes the
        # least extra slot volume under the merged (elementwise max) shape
        ka, ia = items[-1]
        best_j, best_cost, best_shape = None, None, None
        for j in range(len(items) - 1):
            kb, ib = items[j]
            merged = tuple(max(a, b) for a, b in zip(ka, kb))
            vol = merged[0] * merged[1] * merged[2]
            cost = (vol - ka[0] * ka[1] * ka[2]) * len(ia) \
                + (vol - kb[0] * kb[1] * kb[2]) * len(ib)
            if best_cost is None or cost < best_cost:
                best_j, best_cost, best_shape = j, cost, merged
        kb, ib = items[best_j]
        items[best_j] = (best_shape, ib + ia)
        items.pop()
        items.sort(key=lambda kv: -len(kv[1]))
    return [((int(k[0]), int(k[1]), int(k[2])), np.asarray(i))
            for k, i in items]


class VoxelizePlan:
    """Precomputed bucketing for repeated (per-frame) voxelization.

    Host work (window stats, bucketing, index gathers) happens ONCE at
    plan time; voxelize_planned then runs pure device code per frame —
    the deforming-mesh model (BASELINE config 5): topology is fixed, so
    bucket membership and window shapes are planned from worst-case
    geometry and reused.
    """

    def __init__(self, vertices, faces, voxel_size, *, bb_min=None,
                 bb_max=None, max_buckets=24, chunk=16384,
                 window_slack=(0, 0, 0), deform_safe=False):
        # deform_safe=True buckets by the FULL reference windows (no
        # dead-slab cut), restoring the original deformation contract:
        # re-executing the plan against moved vertices stays bit-exact
        # as long as no triangle's reference window outgrows its bucket
        # shape.  The default (False) applies the measured ~3x slot cut,
        # which is proven only for the plan-time vertices — use it for
        # fixed-geometry reuse (bench re-runs, repeated renders).  Every
        # (triangle, window slot) pair costs one scatter slot hit or miss,
        # so exact-shape buckets (24 by default) keep padded-slot waste
        # low; chunk and bucket count are not tuned for the GPU yet.
        from .geometry import grid_dims, mesh_bbox

        v = np.asarray(vertices, np.float32).reshape(-1, 3)
        f = np.asarray(faces).reshape(-1, 3)
        if bb_min is None or bb_max is None:
            bb_min, bb_max = mesh_bbox(v)
        self.origin = np.asarray(bb_min, np.float32)
        self.voxel_size = float(voxel_size)
        self.dims = grid_dims(self.origin, np.asarray(bb_max, np.float32),
                              voxel_size)
        self.chunk = int(chunk)
        buckets = plan_buckets(v, f, self.origin, voxel_size, self.dims,
                               max_buckets, effective=not deform_safe)
        # per-bucket static (window, device face-index array)
        self.buckets = [
            (tuple(int(w + s) for w, s in zip(win, window_slack)),
             jnp.asarray(f[idx]))
            for win, idx in buckets
        ]
        self.n_triangles = len(f)
        # fused single-program layout: all bucket faces concatenated in
        # plan order + static (offset, count, window, chunk) per bucket —
        # ONE dispatch, one vertex gather, one shared trash-slot buffer
        # instead of 24 programs merged by a jnp.maximum chain over the
        # full volume
        budget = (1 << 22) if jax.default_backend() != "cpu" else (1 << 14)
        layout = []
        off = 0
        for win, fidx in self.buckets:
            cap = win[0] * win[1] * win[2]
            bchunk = int(min(self.chunk, max(8, budget // cap)))
            layout.append((off, int(fidx.shape[0]), win, bchunk))
            off += int(fidx.shape[0])
        self.layout = tuple(layout)
        self.faces_sorted = (jnp.concatenate([f_ for _, f_ in self.buckets])
                             if self.buckets else
                             jnp.zeros((0, 3), jnp.int32))

    def __call__(self, vertices):
        return voxelize_planned(self, vertices)


def plan_voxelize(vertices, faces, voxel_size, **kw) -> VoxelizePlan:
    return VoxelizePlan(vertices, faces, voxel_size, **kw)


def voxelize_planned(plan: VoxelizePlan, vertices, scatter="auto",
                     count_only=False):
    """Execute a VoxelizePlan against (possibly deformed) vertices.

    vertices: (V, 3) float32 (host or device).  ONE jitted program runs
    every bucket (static layout from plan time): one vertex gather, a
    shared trash-slot scatter buffer, no per-bucket dispatch or
    occupancy-merge chain.  Occupancy is bit-exact vs the serial
    reference as long as no triangle's window outgrew its plan-time
    bucket shape — for DEFORMED vertices that guarantee needs a
    deform_safe=True plan (full reference windows from worst-case
    geometry); the default plan's dead-slab cut is proven only for the
    plan-time vertices (see plan_buckets).  scatter="window"
    keeps the old per-bucket A/B path.  count_only=True returns only
    set_calls work (profiling attribution — skips the occupancy
    scatter).
    """
    v = jnp.asarray(vertices, jnp.float32).reshape(-1, 3)
    nx, ny, nz = plan.dims
    org = jnp.asarray(plan.origin)
    if scatter in ("auto", "flat"):
        return _voxelize_fused(
            v, plan.faces_sorted, org, dims=plan.dims,
            voxel_size_static=plan.voxel_size, layout=plan.layout,
            count_only=count_only)
    occ = jnp.zeros((nz, ny, nx), jnp.uint8)
    calls = jnp.int32(0)
    for (off, cnt, win, bchunk), (_, fidx) in zip(plan.layout,
                                                  plan.buckets):
        occ_b, calls_b = voxelize_dense(
            v[fidx], org, dims=plan.dims,
            voxel_size_static=plan.voxel_size, window=win, chunk=bchunk,
            scatter=scatter)
        occ = jnp.maximum(occ, occ_b)
        calls = calls + calls_b
    return occ, calls


def voxelize_mesh(vertices, faces, voxel_size, *, bb_min=None, bb_max=None,
                  window=None, chunk=4096, max_buckets=4):
    """Host-facing wrapper: mesh in, occupancy + grid metadata out.

    Computes bbox/dims host-side (exact reference math), buckets triangles
    by window shape, and runs the jitted kernel per bucket.  Returns a dict
    with occ (Z,Y,X) uint8 on device plus dims/origin/voxel_size/set_calls.
    """
    from .geometry import grid_dims, mesh_bbox

    v = np.asarray(vertices, dtype=np.float32).reshape(-1, 3)
    f = np.asarray(faces).reshape(-1, 3)
    if len(v) == 0 or len(f) == 0:
        return {
            "occ": jnp.zeros((0, 0, 0), dtype=jnp.uint8),
            "dims": (0, 0, 0),
            "origin": np.zeros(3, np.float32),
            "voxel_size": float(voxel_size),
            "set_calls": 0,
        }
    if bb_min is None or bb_max is None:
        bb_min, bb_max = mesh_bbox(v)
    bb_min = np.asarray(bb_min, dtype=np.float32)
    bb_max = np.asarray(bb_max, dtype=np.float32)
    dims = grid_dims(bb_min, bb_max, voxel_size)
    nx, ny, nz = dims

    if nx == 0 or ny == 0 or nz == 0:
        return {
            "occ": jnp.zeros((nz, ny, nx), dtype=jnp.uint8),
            "dims": dims, "origin": bb_min,
            "voxel_size": float(voxel_size),
            "set_calls": 0,
        }

    tri_all = v[f]  # (F, 3, 3)
    if window is not None:
        buckets = [(tuple(int(x) for x in window), np.arange(len(f)))]
    else:
        buckets = plan_buckets(v, f, bb_min, voxel_size, dims, max_buckets)

    occ = jnp.zeros((nz, ny, nx), dtype=jnp.uint8)
    total_calls = 0
    # chunk*capacity budget: large on accelerators for throughput, small
    # on CPU (XLA:CPU scatter compile time grows with scatter size)
    budget = (1 << 22) if jax.default_backend() != "cpu" else (1 << 14)
    for win, idx in buckets:
        if len(idx) == 0:
            continue
        cap = win[0] * win[1] * win[2]
        bchunk = int(min(chunk, max(8, budget // cap)))
        occ_b, calls = voxelize_dense(
            jnp.asarray(tri_all[idx]), jnp.asarray(bb_min),
            dims=dims, voxel_size_static=float(voxel_size),
            window=win, chunk=bchunk,
        )
        occ = jnp.maximum(occ, occ_b)
        total_calls += int(calls)

    return {
        "occ": occ, "dims": dims, "origin": bb_min,
        "voxel_size": float(voxel_size),
        "set_calls": total_calls,
    }
