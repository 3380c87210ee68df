"""Texture subsystem: decoders, mip chain, atlas sampling, UV fidelity.

The latent bug this pins down: mixed-size textures in one stack
were padded to the max (H, W) and sampled with the padded dims, so every
smaller texture read into its zero padding.
"""
import struct

import jax.numpy as jnp
import numpy as np
import pytest

from voxelray_tpu.io.objload import LoadedModel, Material
from voxelray_tpu.io.textures import (build_mip_chain, load_texture,
                                      read_bmp, read_image, read_png,
                                      read_pnm, read_tga, write_png)
from voxelray_tpu.models.scene import build_scene
from voxelray_tpu.render.pipeline import _sample_texture


def _rand_img(rng, h, w, ch=3):
    return rng.integers(0, 256, size=(h, w, ch), dtype=np.uint8)


# ---------------------------------------------------------------- formats
def test_png_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    img = _rand_img(rng, 7, 5)
    p = str(tmp_path / "t.png")
    write_png(p, img)
    assert np.array_equal(read_png(p), img)
    assert np.array_equal(read_image(p), img)


def test_bmp_24bit(tmp_path):
    rng = np.random.default_rng(1)
    img = _rand_img(rng, 3, 5)
    h, w = img.shape[:2]
    stride = (w * 3 + 3) & ~3
    rows = np.zeros((h, stride), np.uint8)
    bgr = img[::-1, :, ::-1]  # bottom-up, BGR
    rows[:, : w * 3] = bgr.reshape(h, w * 3)
    pix = rows.tobytes()
    hdr = (b"BM" + struct.pack("<IHHI", 54 + len(pix), 0, 0, 54)
           + struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0, len(pix),
                         2835, 2835, 0, 0))
    p = str(tmp_path / "t.bmp")
    with open(p, "wb") as fh:
        fh.write(hdr + pix)
    assert np.array_equal(read_bmp(p), img)
    assert np.array_equal(read_image(p), img)


def test_tga_uncompressed_and_rle(tmp_path):
    rng = np.random.default_rng(2)
    img = _rand_img(rng, 4, 3)
    h, w = img.shape[:2]
    bgr = img[::-1, :, ::-1].reshape(-1, 3)  # bottom-up, BGR
    head = bytes([0, 0, 2]) + b"\x00" * 9 \
        + struct.pack("<HH", w, h) + bytes([24, 0])
    p = str(tmp_path / "t.tga")
    with open(p, "wb") as fh:
        fh.write(head + bgr.tobytes())
    assert np.array_equal(read_tga(p), img)

    # RLE: one run of 4 identical pixels then 8 raw
    run_pix = np.array([10, 20, 30], np.uint8)   # BGR on disk
    raw = rng.integers(0, 256, size=(8, 3), dtype=np.uint8)
    head = bytes([0, 0, 10]) + b"\x00" * 9 \
        + struct.pack("<HH", 3, 4) + bytes([24, 0x20])  # top-down
    body = bytes([0x80 | 3]) + run_pix.tobytes() \
        + bytes([7]) + raw.tobytes()
    p2 = str(tmp_path / "rle.tga")
    with open(p2, "wb") as fh:
        fh.write(head + body)
    got = read_tga(p2)
    want = np.concatenate([np.tile(run_pix, (4, 1)), raw])[:, ::-1] \
        .reshape(4, 3, 3)
    assert np.array_equal(got, want)


def test_pnm_binary_and_ascii(tmp_path):
    rng = np.random.default_rng(3)
    img = _rand_img(rng, 2, 3)
    p6 = str(tmp_path / "t.ppm")
    with open(p6, "wb") as fh:
        fh.write(b"P6\n# comment\n3 2\n255\n" + img.tobytes())
    assert np.array_equal(read_pnm(p6), img)
    p3 = str(tmp_path / "a.ppm")
    with open(p3, "wb") as fh:
        fh.write(b"P3\n3 2\n255\n"
                 + " ".join(str(v) for v in img.reshape(-1)).encode())
    assert np.array_equal(read_pnm(p3), img)
    assert np.array_equal(read_image(p6), img)


def test_unsupported_falls_back_magenta(tmp_path):
    p = str(tmp_path / "bad.xyz")
    with open(p, "wb") as fh:
        fh.write(b"garbage")
    assert np.allclose(load_texture(p), [[[1.0, 0.0, 1.0]]])


# ------------------------------------------------------------------- mips
def test_mip_chain_dims_and_values():
    img = np.zeros((8, 4, 3), np.float32)
    img[0:2, 0:2] = 1.0  # one constant 2x2 block
    chain = build_mip_chain(img)
    assert [lv.shape[:2] for lv in chain] == [
        (8, 4), (4, 2), (2, 1), (1, 1)]
    assert chain[1][0, 0, 0] == 1.0          # the block averages to itself
    assert chain[1][1:, :, 0].max() == 0.0
    assert np.isclose(chain[-1][0, 0, 0], img[..., 0].mean())


def test_mip_chain_odd_dims():
    img = np.arange(5 * 3 * 3, dtype=np.float32).reshape(5, 3, 3)
    chain = build_mip_chain(img)
    # max(1, d // 2) halving like vkCmdBlitImage (hello_vulkan.cpp:335-340)
    assert [lv.shape[:2] for lv in chain] == [(5, 3), (2, 1), (1, 1)]


# ---------------------------------------------------------- scene + atlas
def _tri_model(tex_path):
    verts = np.zeros((3, 11), np.float32)
    verts[:, 0:3] = [[-1, -1, 2], [1, -1, 2], [0, 1, 2]]
    verts[:, 3:6] = [0, 0, -1]
    verts[:, 6:9] = 1.0
    verts[:, 9:11] = [[0, 0], [1, 0], [0.5, 1]]
    mat = Material(diffuse=(1, 1, 1), texture_id=0).as_row()[None]
    return LoadedModel(vertices=verts,
                       indices=np.arange(3, dtype=np.uint32),
                       materials=mat, textures=[tex_path],
                       mat_index=np.zeros(1, np.int32))


@pytest.fixture()
def mixed_scene(tmp_path):
    rng = np.random.default_rng(4)
    small = _rand_img(rng, 4, 4)
    big = _rand_img(rng, 16, 16)
    ps = str(tmp_path / "small.png")
    pb = str(tmp_path / "big.png")
    write_png(ps, small)
    write_png(pb, big)
    scene = build_scene(models=[_tri_model(ps), _tri_model(pb)])
    return scene, load_texture(ps), load_texture(pb)


def test_mixed_size_stack_samples_own_dims(mixed_scene):
    """Smaller texture must sample its own texels, not the padded zeros
    of the max-size stack (the padded-dims UV bug)."""
    scene, small, big = mixed_scene
    meta = np.asarray(scene.tex_meta)
    assert tuple(meta[0, 0, 2:4]) == (4, 4)
    assert tuple(meta[1, 0, 2:4]) == (16, 16)

    def sample(layer, uv):
        out = _sample_texture(
            scene.textures, scene.tex_meta,
            jnp.asarray([layer], jnp.int32),
            jnp.asarray([uv], jnp.float32))
        return np.asarray(out)[0]

    # texel centers -> exact texel values, including the far corner that
    # previously landed in zero padding
    for (ty, tx) in [(0, 0), (3, 3), (2, 1)]:
        uv = ((tx + 0.5) / 4, (ty + 0.5) / 4)
        assert np.allclose(sample(0, uv), small[ty, tx], atol=1e-6), \
            (ty, tx)
    for (ty, tx) in [(15, 15), (7, 3)]:
        uv = ((tx + 0.5) / 16, (ty + 0.5) / 16)
        assert np.allclose(sample(1, uv), big[ty, tx], atol=1e-6)
    # layer -1 -> white
    assert np.allclose(sample(-1, (0.5, 0.5)), 1.0)


def test_repeat_addressing(mixed_scene):
    scene, small, _ = mixed_scene

    def sample(uv):
        out = _sample_texture(
            scene.textures, scene.tex_meta,
            jnp.asarray([0], jnp.int32), jnp.asarray([uv], jnp.float32))
        return np.asarray(out)[0]

    base = sample(((1 + 0.5) / 4, (2 + 0.5) / 4))
    assert np.allclose(sample((1.0 + (1 + 0.5) / 4, -2.0 + (2 + 0.5) / 4)),
                       base, atol=1e-6)


def test_trilinear_levels(mixed_scene):
    scene, _, big = mixed_scene
    chain = build_mip_chain(big)

    def sample(uv, lod):
        out = _sample_texture(
            scene.textures, scene.tex_meta,
            jnp.asarray([1], jnp.int32), jnp.asarray([uv], jnp.float32),
            lod=jnp.asarray([lod], jnp.float32))
        return np.asarray(out)[0]

    # integer lod k == bilinear sample of level k
    uv = ((3 + 0.5) / 8, (5 + 0.5) / 8)
    assert np.allclose(sample(uv, 1.0), chain[1][5, 3], atol=1e-5)
    uv = ((1 + 0.5) / 4, (2 + 0.5) / 4)
    assert np.allclose(sample(uv, 2.0), chain[2][2, 1], atol=1e-5)
    # fractional lod blends adjacent levels
    a, b = sample((0.5, 0.5), 3.0), sample((0.5, 0.5), 4.0)
    mid = sample((0.5, 0.5), 3.5)
    assert np.allclose(mid, 0.5 * (a + b), atol=1e-5)
    # lod far past the chain clamps to the 1x1 tail == global mean
    assert np.allclose(sample((0.1, 0.9), 99.0), big.mean(axis=(0, 1)),
                       atol=1e-4)


def test_textured_render_end_to_end(tmp_path):
    """A textured triangle renders its texture colors (RT path, mip 0)."""
    img = np.zeros((8, 8, 3), np.uint8)
    img[:, :4] = [255, 0, 0]
    img[:, 4:] = [0, 0, 255]
    p = str(tmp_path / "rb.png")
    write_png(p, img)
    from voxelray_tpu.models.scene import Light
    from voxelray_tpu.render.pipeline import render_scene
    from voxelray_tpu.render.camera import Camera

    scene = build_scene(models=[_tri_model(p)])
    out = np.asarray(render_scene(
        scene, Camera(eye=(0, 0, 0), center=(0, 0, 2)),
        width=32, height=32, shadows=False,
        light=Light(position=(0.0, 0.0, -3.0), intensity=50.0)))
    hit = out[..., 0:3].std(axis=-1) > 1e-3
    assert hit.any()
    reds = out[..., 0] > out[..., 2]
    blues = out[..., 2] > out[..., 0]
    assert (hit & reds).any() and (hit & blues).any()


def test_raster_mip_minification(tmp_path):
    """A distant checkerboard through the raster path (trilinear mips)
    renders close to the checker mean — no high-frequency aliasing."""
    n = 64
    img = ((np.indices((n, n)).sum(axis=0) % 2) * 255).astype(np.uint8)
    img = np.stack([img] * 3, axis=-1)
    p = str(tmp_path / "checker.png")
    write_png(p, img)

    verts = np.zeros((6, 11), np.float32)
    # large quad far away, steeply minified
    quad = [[-40, -40, 60], [40, -40, 60], [40, 40, 60],
            [-40, -40, 60], [40, 40, 60], [-40, 40, 60]]
    uvq = [[0, 0], [40, 0], [40, 40], [0, 0], [40, 40], [0, 40]]
    verts[:, 0:3] = quad
    verts[:, 3:6] = [0, 0, -1]
    verts[:, 6:9] = 1.0
    verts[:, 9:11] = uvq
    mat = Material(diffuse=(1, 1, 1), texture_id=0, illum=1).as_row()[None]
    model = LoadedModel(vertices=verts,
                        indices=np.arange(6, dtype=np.uint32),
                        materials=mat, textures=[p],
                        mat_index=np.zeros(2, np.int32))
    scene = build_scene(models=[model])
    from voxelray_tpu.render.raster import rasterize_scene
    from voxelray_tpu.render.camera import Camera

    out = np.asarray(rasterize_scene(
        scene, Camera(eye=(0, 0, 0), center=(0, 0, 60)),
        width=48, height=48, clear_color=(0.0, 0.0, 0.0, 1.0)))
    # with trilinear mips the minified checker flattens toward its mean:
    # pixel-to-pixel jumps on covered pixels must be tiny (aliasing would
    # flip between the checker extremes, ~0.9 contrast per step; lighting
    # gradients ~0.01).  Background pixels are excluded: shared-edge ties
    # can leave a 1-px crack on some XLA codegens — a coverage artifact,
    # not a filtering one.
    inner = out[16:32, 16:32, 0]
    lit = inner > 0.05
    both = lit[:, 1:] & lit[:, :-1]
    jumps = np.abs(np.diff(inner, axis=1))[both]
    assert jumps.size > 100
    assert jumps.max() < 0.05, jumps.max()


@pytest.mark.parametrize("mode,size,subsampling,quality", [
    ("RGB", (32, 24), 0, 95),    # 4:4:4
    ("RGB", (33, 17), 2, 90),    # 4:2:0, odd dims
    ("L", (16, 16), 0, 95),      # grayscale
])
def test_jpeg_decode_vs_pillow(tmp_path, mode, size, subsampling, quality):
    """Baseline JPEG decode matches Pillow's within DCT tolerance."""
    PIL = pytest.importorskip("PIL.Image")
    rng = np.random.default_rng(42)
    # smooth-ish content so quantization error stays small
    base = rng.integers(0, 256, (4, 4, 3), np.uint8)
    img = np.kron(base, np.ones((size[1] // 4 + 1, size[0] // 4 + 1, 1),
                                np.uint8))[: size[1], : size[0]]
    pim = PIL.fromarray(img if mode == "RGB" else img[..., 0], mode)
    p = str(tmp_path / "t.jpg")
    pim.save(p, "JPEG", quality=quality, subsampling=subsampling)

    from voxelray_tpu.io.jpeg import read_jpeg
    got = read_jpeg(p).astype(np.int32)
    want = np.asarray(PIL.open(p).convert("RGB"), np.int32)
    if got.shape[-1] == 1:
        got = got.repeat(3, axis=-1)
    assert got.shape == want.shape
    # decoders differ in chroma upsampling filters; mean error must be
    # tiny and worst pixels bounded
    err = np.abs(got - want)
    assert err.mean() < 3.0, err.mean()
    assert np.percentile(err, 99) <= 30, np.percentile(err, 99)


@pytest.mark.parametrize("mode,size,subsampling,quality", [
    ("RGB", (70, 57), 0, 90),    # 4:4:4
    ("RGB", (64, 48), 2, 50),    # 4:2:0 + heavy quantization
    ("L", (40, 24), 0, 85),      # grayscale
])
def test_jpeg_progressive_vs_pillow(tmp_path, mode, size, subsampling,
                                    quality):
    """Progressive (SOF2) decode — spectral selection + successive
    approximation scans — matches Pillow within DCT tolerance
    (the stb_image format tail, hello_vulkan.cpp:321-331)."""
    PIL = pytest.importorskip("PIL.Image")
    rng = np.random.default_rng(7)
    y, x = np.mgrid[0: size[1], 0: size[0]]
    img = np.stack([np.sin(x / 7.0) * 127 + 128,
                    np.cos(y / 5.0) * 100 + 120,
                    (x + 2 * y) % 256], axis=-1)
    img = np.clip(img + rng.normal(0, 10, img.shape), 0,
                  255).astype(np.uint8)
    pim = PIL.fromarray(img if mode == "RGB" else img[..., 0], mode)
    p = str(tmp_path / "prog.jpg")
    pim.save(p, "JPEG", progressive=True, quality=quality,
             subsampling=subsampling)
    # confirm the encoder really wrote SOF2
    assert b"\xff\xc2" in open(p, "rb").read()

    from voxelray_tpu.io.jpeg import read_jpeg
    got = read_jpeg(p).astype(np.int32)
    want = np.asarray(PIL.open(p).convert("RGB"), np.int32)
    if got.shape[-1] == 1:
        got = got.repeat(3, axis=-1)
    assert got.shape == want.shape
    err = np.abs(got - want)
    assert err.mean() < 3.0, err.mean()
    assert np.percentile(err, 99) <= 30, np.percentile(err, 99)


def test_jpeg_unsupported_rejected(tmp_path):
    """Arithmetic/lossless variants still raise; load_texture falls back
    to magenta rather than raising (hello_vulkan.cpp:323-331)."""
    from voxelray_tpu.io.jpeg import read_jpeg
    # hand-built SOF3 (lossless) header after SOI
    p = str(tmp_path / "bad.jpg")
    with open(p, "wb") as fh:
        fh.write(b"\xff\xd8\xff\xc3\x00\x0b\x08\x00\x10\x00\x10\x01"
                 b"\x01\x11\x00\xff\xd9")
    with pytest.raises(ValueError):
        read_jpeg(p)
    assert np.allclose(load_texture(p), [[[1.0, 0.0, 1.0]]])
