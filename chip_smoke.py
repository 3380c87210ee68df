"""On-device smoke test: the main path on one GPU, at full width.

    python chip_smoke.py              # one card (the default)
    python chip_smoke.py --devices 4  # the multi-card paths on four cards

One card: the 1M-triangle torus knot voxelized to a 512^3 grid
(GridBool.from_mesh, checked bit-exact against the native oracle), a
scene with the ground plane and its triangle accel (build_scene), four
orbit frames at 1920x1080 with shadows (render_image, backend="fast"),
AABB extraction (get_aabbs_fixed), then the brick_dda kernel against the
plain XLA dda on the same scene and cameras (hits, cells, shaded image,
ms/frame), and the octree gate.  --devices 4 runs only the sharded
paths of parallel.comm and the one-card results they must reproduce.

Each phase prints one line; any failed check raises, so the script exits
non-zero.  The last line of stdout is the JSON result.  Without a GPU
(or without the rest of the repository) it fails before printing one.
"""
import argparse
import json
import subprocess
import sys
import tempfile
import time

import numpy as np

W, H = 1920, 1080
KNOT_VOXEL = 4.3 / 512          # BASELINE config 4: knot1m -> 512^3


def log(msg):
    print(msg, flush=True)


def check(ok, what):
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def timed(fn):
    import jax
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    return out, time.perf_counter() - t0


def best_ms(fn, reps=3):
    """Best of `reps` synchronized calls after one warm-up, in ms."""
    import jax
    jax.block_until_ready(fn())
    return min(timed(fn)[1] for _ in range(reps)) * 1e3


def image_match(a, b):
    """Share of pixels whose RGBA agree within the hit-adjudication
    envelope (bench.py's parity gate tolerance)."""
    close = np.isclose(np.asarray(a), np.asarray(b), rtol=2e-5, atol=1e-6)
    return float(close.all(axis=-1).mean())


def knot_grid():
    from voxelray_tpu.io import meshes
    from voxelray_tpu.models.grids import GridBool

    v, f = meshes.make_scene_mesh("knot1m")
    grid, secs = timed(lambda: GridBool.from_mesh(v, f, KNOT_VOXEL))
    return v, f, grid, secs


def knot_scene(grid):
    from voxelray_tpu.io import meshes
    from voxelray_tpu.io.objload import ObjLoader, write_obj
    from voxelray_tpu.models.scene import build_scene

    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/plane.obj"
        write_obj(path, *meshes.plane(20.0))
        plane = ObjLoader().load_model(path)
    return build_scene(models=[plane], grid=grid, tri_accel=True)


def orbit(v, n=4):
    from voxelray_tpu.ops.geometry import mesh_bbox
    from voxelray_tpu.render.camera import orbit_path

    bb_min, bb_max = mesh_bbox(v)
    center = (bb_min + bb_max) * 0.5
    extent = float(max(bb_max - bb_min))
    cams = orbit_path(
        n, center=tuple(float(c) for c in center),
        radius=float(np.linalg.norm(np.asarray([0.9, 0.55, -0.9]) * extent)),
        height=float(center[1] + 0.55 * extent))
    return [c.matrices(W, H)[2:] for c in cams]


def render_all(scene, mats, backend, shadows=True):
    from voxelray_tpu.render.pipeline import render_image
    return [render_image(scene, vi, pi, width=W, height=H, backend=backend,
                         shadows=shadows) for vi, pi in mats]


def pipelined_ms(scene, mats, backend, shadows):
    """ms per frame over the orbit, all frames in flight, one sync."""
    return best_ms(lambda: render_all(scene, mats, backend, shadows),
                   reps=2) / len(mats)


def phase_voxelize():
    from voxelray_tpu import native

    v, f, grid, secs = knot_grid()
    ref = native.voxelize_native(v, f, KNOT_VOXEL, np.asarray(grid.origin),
                                 grid.dims)
    check(ref is not None, "native oracle library builds")
    occ_ref, calls_ref = ref
    occ = np.asarray(grid.occupancy())
    check(np.array_equal(occ.astype(bool), occ_ref.astype(bool)),
          "occupancy bit-exact vs the native oracle")
    drift = abs(grid.set_calls - calls_ref)
    check(drift <= max(16, 2e-6 * calls_ref), "set_calls within envelope")
    _, warm = timed(lambda: knot_grid()[2].words)
    log(f"phase voxelize: ok  {len(f)} tris -> {grid.dims}, "
        f"{int(occ.sum())} occupied, bit-exact, set_calls drift {drift} "
        f"of {calls_ref}; GridBool.from_mesh {secs:.2f} s cold, "
        f"{warm:.2f} s warm")
    return v, grid, occ


def phase_scene(grid):
    scene, secs = timed(lambda: knot_scene(grid))
    check(scene.accel is not None and scene.tri_accel is not None,
          "brick accel and triangle accel built")
    log(f"phase scene: ok  build_scene with ground plane + tri_accel "
        f"{secs:.2f} s")
    return scene


def phase_render(scene, mats):
    imgs, secs = timed(lambda: render_all(scene, mats, "fast"))
    for img in imgs:
        img = np.asarray(img)
        check(img.shape == (H, W, 4) and np.isfinite(img).all(),
              "finite (H, W, 4) frame")
        check(img[..., :3].std() > 0.01, "frame is not uniform")
    log(f"phase render: ok  {len(imgs)} orbit frames {W}x{H} with shadows "
        f"(backend fast), first call incl. compile {secs:.2f} s")
    return imgs


def phase_aabbs(grid, occ):
    n_occ = int(occ.sum())
    cap = -(-n_occ // 8192) * 8192
    (boxes, count), secs = timed(lambda: grid.get_aabbs_fixed(capacity=cap))
    check(int(count) == n_occ, "one AABB per occupied cell")
    # same boxes in the same order; corners are float values from two
    # separately compiled programs, so equal to a few ulp
    check(np.allclose(np.asarray(boxes)[:n_occ],
                      np.asarray(grid.get_aabbs()), rtol=2e-6, atol=1e-6),
          "fixed-capacity AABBs equal the ordered extraction")
    _, warm = timed(lambda: grid.get_aabbs_fixed(capacity=cap))
    log(f"phase aabbs: ok  {n_occ} boxes, get_aabbs_fixed {secs:.2f} s "
        f"first call, {warm * 1e3:.2f} ms warm")


def phase_kernel_vs_dda(scene, mats, occ, imgs_fast, card):
    import jax.numpy as jnp

    from bench import adjudicate_hit_diffs
    from voxelray_tpu.ops.intersect import make_camera_rays
    from voxelray_tpu.ops.traverse import trace_grid_dda
    from voxelray_tpu.ops.traverse_fast import trace_grid_fast

    occ_b = occ.astype(bool)
    bb_min = np.asarray(scene.grid_origin)
    diffs = 0
    for vi, pi in mats:
        o, d = make_camera_rays(W, H, jnp.asarray(vi), jnp.asarray(pi))
        t_f, lin_f, unresolved = trace_grid_fast(o, d, scene.accel,
                                                 return_stats=True)
        t_d, lin_d = trace_grid_dda(
            o, d, scene.occ_flat, scene.grid_origin, dims=scene.grid_dims,
            voxel_size_static=scene.grid_voxel_size)
        check(int(unresolved) == 0, "unresolved == 0")
        t_f, lin_f, t_d, lin_d = (np.asarray(x).reshape(-1)
                                  for x in (t_f, lin_f, t_d, lin_d))
        hf, hd = np.isfinite(t_f), np.isfinite(t_d)
        idx = np.flatnonzero((hf != hd) | (hf & hd & (lin_f != lin_d)))
        check(len(idx) <= 2048, f"{len(idx)} differing rays <= 2048")
        same = np.setdiff1d(np.flatnonzero(hd), idx)
        check(np.allclose(t_f[same], t_d[same], rtol=2e-6, atol=0),
              "t of equal hits within 2e-6")
        if len(idx):
            adj = adjudicate_hit_diffs(
                np.asarray(o).reshape(-1, 3), np.asarray(d).reshape(-1, 3),
                occ_b, bb_min, scene.grid_voxel_size, idx, t_f, lin_f, t_d,
                lin_d)
            check(adj["adjudication_ok"], f"hit diffs adjudicated: {adj}")
        diffs += len(idx)
    imgs_dda = render_all(scene, mats, "dda")
    match = min(image_match(a, b) for a, b in zip(imgs_fast, imgs_dda))
    check(match >= 0.999, f"shadowed image match {match:.6f} >= 0.999")
    log(f"phase kernel_vs_dda: ok  unresolved 0, {diffs} differing rays "
        f"over {len(mats)} frames, all adjudicated; "
        f"shadowed image match {match:.6f}")
    times = {}
    for backend in ("fast", "dda"):
        for shadows in (False, True):
            times[backend, shadows] = pipelined_ms(scene, mats, backend,
                                                   shadows)
    parts = []
    for (backend, shadows), ms in times.items():
        kind = "shadowed" if shadows else "primary"
        parts.append(f"{backend} {kind} {ms:.2f} ms/frame "
                     f"({W * H / ms / 1e3:.1f} Mrays/s)")
    # the traversal alone, on the first orbit frame's camera rays
    o, d = make_camera_rays(W, H, *(jnp.asarray(m) for m in mats[0]))
    fast_ms = best_ms(lambda: trace_grid_fast(o, d, scene.accel))
    dda_ms = best_ms(lambda: trace_grid_dda(
        o, d, scene.occ_flat, scene.grid_origin, dims=scene.grid_dims,
        voxel_size_static=scene.grid_voxel_size))
    log(f"phase timing: ok  [{card}] {W}x{H}, 512^3 knot + plane, "
        f"pipelined x{len(mats)}: " + "; ".join(parts)
        + f"; primary trace alone: fast {fast_ms:.3f} ms, "
        f"dda {dda_ms:.3f} ms")


def phase_octree():
    from voxelray_tpu.utils.gates import run_gate

    res, secs = timed(lambda: run_gate("vec256", scale=1.0))
    check(res["hit_pixels"] > 0 and res["normals_unit"],
          "octree AOV hits with unit normals")
    log(f"phase octree: ok  gate vec256 scale 1.0: {res['octree_nodes']} "
        f"nodes, {res['hit_pixels']} hit pixels, {secs:.2f} s")


def run_one_card(card):
    v, grid, occ = phase_voxelize()
    scene = phase_scene(grid)
    mats = orbit(v)
    imgs = phase_render(scene, mats)
    phase_aabbs(grid, occ)
    phase_kernel_vs_dda(scene, mats, occ, imgs, card)
    phase_octree()


def run_four_cards(n):
    import jax
    import jax.numpy as jnp

    from voxelray_tpu.io import meshes
    from voxelray_tpu.ops.voxelize import (required_window_shape,
                                           voxelize_dense)
    from voxelray_tpu.parallel.comm import (make_mesh, render_sharded,
                                            render_zslab_sharded,
                                            shard_grid_zslab,
                                            voxelize_frames_sharded,
                                            voxelize_sharded)
    from voxelray_tpu.render.pipeline import render_image

    mesh = make_mesh(n)
    v, f, grid, secs = knot_grid()
    scene = knot_scene(grid)
    mats = orbit(v, 1)
    (vi, pi), = mats
    ref_img = np.asarray(render_image(scene, vi, pi, width=W, height=H,
                                      backend="fast"))
    log(f"phase reference: ok  one-card grid {grid.dims} ({secs:.2f} s) "
        f"and 1080p render on {jax.devices()[0]}")

    slabs = shard_grid_zslab(scene, mesh)
    in_use = [d.memory_stats()["bytes_in_use"] for d in jax.devices()[:n]]
    grid_bytes = int(scene.occ_flat.nbytes)
    check(all(b < grid_bytes for b in in_use[1:]),
          "cards 1.. hold less than one dense grid")
    img, secs = timed(lambda: render_zslab_sharded(
        scene, vi, pi, mesh, width=W, height=H, slabs=slabs))
    match = image_match(img, ref_img)
    check(match >= 0.999, f"zslab render match {match:.6f}")
    log(f"phase zslab: ok  bytes_in_use per card {in_use} (dense grid "
        f"{grid_bytes}); 1080p match {match:.6f}, {secs:.2f} s")
    del slabs, img

    img, secs = timed(lambda: render_sharded(scene, vi, pi, mesh, width=W,
                                             height=H))
    match = image_match(img, ref_img)
    check(match >= 0.999, f"row-sharded render match {match:.6f}")
    log(f"phase render_sharded: ok  1080p match {match:.6f}, {secs:.2f} s")
    del img

    origin = np.asarray(grid.origin)
    win = required_window_shape(v, f, origin, KNOT_VOXEL, grid.dims)
    (occ, calls), secs = timed(lambda: voxelize_sharded(
        v[f], origin, mesh, dims=grid.dims, voxel_size=KNOT_VOXEL,
        window=win))
    check(np.array_equal(np.asarray(occ), np.asarray(grid.occupancy())),
          "sharded occupancy bit-exact vs GridBool.from_mesh")
    drift = abs(int(calls) - grid.set_calls)
    check(drift <= max(16, 2e-6 * grid.set_calls), "set_calls envelope")
    log(f"phase voxelize_sharded: ok  bit-exact, set_calls drift {drift}, "
        f"{secs:.2f} s")
    del occ

    frames = np.stack([meshes.deformed(v, 2 * np.pi * i / n)
                       for i in range(n)])
    win = tuple(np.max([required_window_shape(fv, f, origin, KNOT_VOXEL,
                                              grid.dims) for fv in frames],
                       axis=0).tolist())
    (occ_f, calls_f), secs = timed(lambda: voxelize_frames_sharded(
        frames, f, origin, mesh, dims=grid.dims, voxel_size=KNOT_VOXEL,
        window=win))
    for i in range(n):
        occ_i, calls_i = voxelize_dense(
            jnp.asarray(frames[i][f]), jnp.asarray(origin), dims=grid.dims,
            voxel_size_static=KNOT_VOXEL, window=win)
        check(np.array_equal(np.asarray(occ_f[i]), np.asarray(occ_i))
              and int(calls_f[i]) == int(calls_i),
              f"deformed frame {i} bit-exact vs one card")
    log(f"phase voxelize_frames_sharded: ok  {n} deformed frames bit-exact,"
        f" {secs:.2f} s")


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--devices", type=int, default=1, choices=(1, 4),
                        help="4 runs only the multi-card paths")
    args = parser.parse_args()

    card = card_line()
    log(card)
    import jax
    devices = jax.devices()
    log(f"devices: {devices}")
    if devices[0].platform != "gpu":
        sys.exit(f"chip_smoke needs a GPU, JAX found {devices[0].platform}")
    if len(devices) < args.devices:
        sys.exit(f"--devices {args.devices} but JAX sees {len(devices)}")

    from voxelray_tpu.utils.cache import enable_compile_cache
    enable_compile_cache()
    if args.devices == 1:
        run_one_card(card.splitlines()[0])
    else:
        run_four_cards(args.devices)
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}))


if __name__ == "__main__":
    main()
