"""The port's native decode library (``pysp_tpu_torch/io/native.py``).

The library is compiled from ``native/dng_fast.cc`` with g++ at first use into
``pysp_tpu_torch/_build/``; its bindings must give the JAX package's bytes and
arrays: LJ92 encode and decode, the PNG writer (8- and 16-bit, grey and RGB),
the format codecs, and the PNG files ``save_image`` / ``save_png16`` write.
"""
import threading
import warnings

import numpy as np
import pytest
import torch

from pysp_tpu.io import image_out as jax_image_out
from pysp_tpu.io import native as jax_native
from pysp_tpu_torch.io import image_out, native
from pysp_tpu_torch.utils.testing import read_png

torch.set_num_threads(1)

pytestmark = pytest.mark.skipif(
    not jax_native.available(), reason="the JAX package's native library is not built"
)


def test_the_library_is_built_under_the_port_build_dir():
    assert native.available()
    assert native.loaded_path == str(native.library_path())
    assert native.library_path().parent == native.BUILD_DIR
    assert native.BUILD_DIR.name == "_build" and native.BUILD_DIR.parent.name == "pysp_tpu_torch"
    assert "libdng_fast.so" not in native.loaded_path.split("/")[-1]


def test_concurrent_builds_land_one_complete_library(tmp_path, monkeypatch):
    """Builds racing for one name each write a temporary file and rename it
    into place: every caller gets the same loadable library and no temporary
    file is left behind."""
    import ctypes

    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    paths, errors = [], []

    def build():
        try:
            paths.append(native.build_library())
        except Exception as e:  # pragma: no cover - reported below
            errors.append(e)

    threads = [threading.Thread(target=build) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    assert len(set(paths)) == 1
    assert [p.name for p in tmp_path.iterdir()] == [paths[0].name]
    assert hasattr(ctypes.CDLL(str(paths[0])), "png_encode_fast")


def test_a_failed_build_warns_with_the_compiler_output(tmp_path, monkeypatch):
    broken = tmp_path / "dng_fast.cc"
    broken.write_text("int broken( {\n")
    monkeypatch.setattr(native, "SOURCE", broken)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_TRIED", False)
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "loaded_path", None)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        assert not native.available()
    assert len(caught) == 1 and caught[0].category is RuntimeWarning
    message = str(caught[0].message)
    assert "did not build" in message and "dng_fast.cc" in message and "error" in message
    assert not any((tmp_path / "build").iterdir())
    with pytest.raises(RuntimeError, match="unavailable"):
        native.ljpeg_encode(np.zeros((2, 2), np.uint16))


def _smooth(h, w, seed, top):
    rng = np.random.default_rng(seed)
    base = top // 3 + np.cumsum(rng.integers(-40, 41, (h, w)), axis=1)
    return np.clip(base, 0, top).astype(np.uint16)


@pytest.mark.parametrize("shape,precision", [((24, 40), 16), ((24, 40), 14), ((16, 12, 2), 12),
                                             ((9, 7), 16)])
def test_ljpeg_encode_and_decode_match_the_jax_package(shape, precision):
    rng = np.random.default_rng(sum(shape))
    img = rng.integers(0, 1 << precision, shape).astype(np.uint16)
    blob = native.ljpeg_encode(img, precision=precision)
    assert blob == jax_native.ljpeg_encode(img, precision=precision)
    got = native.ljpeg_decode(blob)
    np.testing.assert_array_equal(got, jax_native.ljpeg_decode(blob))
    np.testing.assert_array_equal(got, img)


def test_ljpeg_tile_decode_matches_the_jax_package():
    img = _smooth(40, 48, 1, 65535)
    tiles = [img[y:y + 16, x:x + 16] for y in range(0, 48, 16) for x in range(0, 48, 16)]
    tiles = [np.pad(t, ((0, 16 - t.shape[0]), (0, 16 - t.shape[1])), mode="edge") for t in tiles]
    blobs = [native.ljpeg_encode(t) for t in tiles]
    data = b"".join(blobs)
    offsets = np.cumsum([0] + [len(b) for b in blobs[:-1]])
    counts = [len(b) for b in blobs]
    got = native.ljpeg_decode_tiles(data, offsets, counts, 40, 48, 16, 16)
    np.testing.assert_array_equal(
        got, jax_native.ljpeg_decode_tiles(data, offsets, counts, 40, 48, 16, 16))
    np.testing.assert_array_equal(got, img)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("channels", [1, 3])
def test_png_encode_matches_the_jax_package(dtype, channels):
    rng = np.random.default_rng(channels)
    shape = (23, 17) if channels == 1 else (23, 17, 3)
    img = rng.integers(0, np.iinfo(dtype).max + 1, shape).astype(dtype)
    blob = native.png_encode(img)
    assert blob == jax_native.png_encode(img)
    np.testing.assert_array_equal(read_png(blob), img)


def test_save_image_and_save_png16_write_the_jax_package_bytes(tmp_path):
    rng = np.random.default_rng(4)
    srgb = rng.uniform(-0.1, 1.1, (19, 21, 3)).astype(np.float32)
    image_out.save_image(str(tmp_path / "port.png"), torch.from_numpy(srgb))
    jax_image_out.save_image(str(tmp_path / "jax.png"), srgb)
    image_out.save_png16(str(tmp_path / "port16.png"), torch.from_numpy(srgb))
    jax_image_out.save_png16(str(tmp_path / "jax16.png"), srgb)
    for name in ("", "16"):
        port = (tmp_path / f"port{name}.png").read_bytes()
        assert port == (tmp_path / f"jax{name}.png").read_bytes()
    np.testing.assert_array_equal(
        read_png((tmp_path / "port.png").read_bytes()), image_out.to_uint8(srgb))
    np.testing.assert_array_equal(
        read_png((tmp_path / "port16.png").read_bytes()), image_out.to_uint16(srgb))


def test_pil_png_is_used_only_without_fast_png(tmp_path):
    from PIL import Image

    srgb = np.random.default_rng(5).uniform(0, 1, (8, 6, 3)).astype(np.float32)
    image_out.save_image(str(tmp_path / "pil.png"), srgb, fast_png=False)
    jax_image_out.save_image(str(tmp_path / "jax.png"), srgb, fast_png=False)
    assert (tmp_path / "pil.png").read_bytes() == (tmp_path / "jax.png").read_bytes()
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "pil.png")),
                                  image_out.to_uint8(srgb))


@pytest.mark.parametrize("codec", ["rw2", "orf", "nef"])
def test_codec_encoders_match_the_jax_package(codec):
    img = _smooth(8, 56, 2, 4095)
    if codec == "rw2":
        blob, achieved = native.rw2_encode(img)
        want_blob, want_achieved = jax_native.rw2_encode(img)
        np.testing.assert_array_equal(achieved, want_achieved)
        np.testing.assert_array_equal(native.rw2_decode(blob, 8, 56), achieved)
    elif codec == "orf":
        blob, want_blob = native.orf_encode(img), jax_native.orf_encode(img)
        np.testing.assert_array_equal(native.orf_decode(blob, 8, 56), img)
    else:
        vpred = np.array([[512, 512], [512, 512]], np.uint16)
        blob = native.nef_encode(img, 0, vpred)
        want_blob = jax_native.nef_encode(img, 0, vpred)
        curve = np.arange(1 << 14, dtype=np.uint16)
        np.testing.assert_array_equal(
            native.nef_decode(blob, 8, 56, 0, vpred, 0, curve),
            jax_native.nef_decode(blob, 8, 56, 0, vpred, 0, curve))
    assert blob == want_blob


@pytest.mark.parametrize("codec", ["rw2", "orf", "arw2"])
def test_codec_decoders_match_the_jax_package_on_random_bytes(codec):
    rng = np.random.default_rng(len(codec))
    h, w = 4, (56 if codec == "rw2" else 64)
    blob = rng.integers(0, 256, 0x4000 + h * w * 2, dtype=np.uint8).tobytes()
    decode = getattr(native, f"{codec}_decode")
    np.testing.assert_array_equal(decode(blob, h, w),
                                  getattr(jax_native, f"{codec}_decode")(blob, h, w))


def test_normalize_and_swap_match_the_jax_package():
    rng = np.random.default_rng(6)
    mosaic = rng.integers(0, 4096, (10, 12)).astype(np.uint16)
    black = np.array([60, 61, 62, 63], np.float32)
    sat = np.array([4000, 4001, 4002, 4003], np.float32)
    np.testing.assert_array_equal(native.normalize_mosaic(mosaic, black, sat),
                                  jax_native.normalize_mosaic(mosaic, black, sat))
    data = rng.integers(0, 256, 64, dtype=np.uint8).tobytes()
    np.testing.assert_array_equal(native.swap16(data), jax_native.swap16(data))
