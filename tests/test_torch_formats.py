"""The port's raw-format decoders against the JAX package's, on the CPU.

One seeded mosaic goes into every format the built-in decoders read (the LJ92
DNG, CR2, MRW, RAF, ORF, RW2, NEF, ARW, PEF and SRW): the port's writers give
the JAX package's bytes, and ``load_raw`` through both packages gives the same
frame bit for bit. Then ``load_raw``'s fall-throughs (X-Trans RAF, ARW
compression 7, RW2 v5+, SRW samsung2/3, a NEF that is not a DNG, CR3 and
unknown bytes), the ``info`` subcommand against the JAX CLI's, and the whole
slice, load -> Best develop -> PNG, against the JAX chain.
"""
import importlib
import json
import struct
import sys
import types

import jax
import numpy as np
import pytest
import torch

import pysp_tpu.io.camera_matrices as jax_cm
import pysp_tpu_torch.io.camera_matrices as port_cm
from pysp_tpu.cli import main as jax_main
from pysp_tpu.io import raw_loader as jax_raw_loader
from pysp_tpu.io.cr3 import load_raw_cr3_rawpy as jax_load_raw_cr3_rawpy
from pysp_tpu_torch.cli import main
from pysp_tpu_torch.io import raw_loader
from pysp_tpu_torch.io.cr3 import cr3_info, load_raw_cr3_rawpy, write_synthetic_cr3
from pysp_tpu_torch.utils.testing import (
    LOSSY_RAW_FORMATS,
    RAW_FORMATS,
    arw2_error_bound,
    make_scene,
    mosaic_rggb,
    psnr,
    raw_format_mosaic,
    read_png,
    write_raw_format,
)

torch.set_num_threads(1)
# The writers' synthetic bodies have no calibration rows: the loaders warn.
pytestmark = pytest.mark.filterwarnings("ignore:no color calibration")

# 224 = the writers' width multiples (ARW 32, SRW 16, RW2 14)
H, W = 32, 224
FORMATS = sorted(RAW_FORMATS)
FIELDS = ("bayer", "cam_mat", "cam_white", "wb_neutral", "ev", "lim_sat")
LOADERS = {"dng": "raw_loader.load_raw_dng", **{
    fmt: f"{fmt}.load_raw_{fmt}" for fmt in FORMATS if fmt != "dng"}}


@pytest.fixture(autouse=True)
def fresh_matrix_cache(tmp_path, monkeypatch):
    """Both packages' camera-matrix registries empty, as in a fresh process
    (other tests' loads and registrations leave bodies in them), over an
    empty cache file of this test's own; restored afterwards."""
    monkeypatch.setenv("PYSP_TPU_MATRIX_CACHE", str(tmp_path / "harvested_matrices.json"))
    before = {}
    for cm in (jax_cm, port_cm):
        monkeypatch.setattr(cm, "_cache_loaded", False)
        before[cm] = dict(cm._REGISTRY)
        cm._REGISTRY.clear()
    yield
    for cm, registry in before.items():
        cm._REGISTRY.clear()
        cm._REGISTRY.update(registry)


def _stored(fmt, seed=11):
    return raw_format_mosaic(fmt, mosaic_rggb(make_scene(H, W, seed=seed)))


def _writer_defaults(package, fmt, stored):
    """``stored`` through ``fmt``'s writer with its default keywords (blacks,
    CFA phases and WB of the writer's own; the DNG in LJ92)."""
    module, writer, _, _ = RAW_FORMATS[fmt]
    write = getattr(importlib.import_module(f"{package}.{module}"), writer)
    out = write(stored, compression=7) if fmt == "dng" else write(stored)
    return out[0] if fmt == "rw2" else out


def _assert_same_frame(got, want):
    assert got.source_pattern == want.source_pattern
    assert got.is_hdr == want.is_hdr
    for k in FIELDS:
        g = getattr(got, k)
        assert g.device.type == "cpu" and g.dtype == torch.float32, k
        np.testing.assert_array_equal(g.numpy(), np.asarray(getattr(want, k)), err_msg=k)


@pytest.mark.parametrize("writer", ["zero_black_rggb", "writer_defaults"])
@pytest.mark.parametrize("fmt", FORMATS)
def test_writers_and_load_raw_match_the_jax_package(fmt, writer, tmp_path):
    """The port's writer gives the JAX writer's bytes, and ``load_raw`` of a
    path and of bytes gives the JAX package's frame bit for bit."""
    stored = _stored(fmt)
    if writer == "zero_black_rggb":
        blob = write_raw_format("pysp_tpu_torch.io", fmt, stored)
        assert blob == write_raw_format("pysp_tpu.io", fmt, stored)
    else:
        blob = _writer_defaults("pysp_tpu_torch.io", fmt, stored)
        assert blob == _writer_defaults("pysp_tpu.io", fmt, stored)
    path = tmp_path / f"shot.{fmt}"
    path.write_bytes(blob)
    want = jax_raw_loader.load_raw(blob)
    for source in (blob, str(path)):
        _assert_same_frame(raw_loader.load_raw(source, device="cpu"), want)


@pytest.mark.parametrize("fmt", FORMATS)
def test_decoded_values_are_the_written_values(fmt):
    """Lossless codecs give back the stored values; ARW2 within its block
    shift (tests/test_arw.py's bound), its max and min exactly."""
    stored = _stored(fmt, seed=12)
    frame = raw_loader.load_raw(write_raw_format("pysp_tpu_torch.io", fmt, stored),
                                device="cpu")
    top = (1 << RAW_FORMATS[fmt][2]) - 1
    assert tuple(frame.bayer.shape) == stored.shape
    got = np.round(frame.bayer.numpy().astype(np.float64) * top)
    if fmt in LOSSY_RAW_FORMATS:
        err = np.abs(got - stored)
        assert np.all(err <= arw2_error_bound(stored)) and err.max() > 0
    else:
        np.testing.assert_array_equal(got, stored)


@pytest.mark.parametrize("fmt", FORMATS)
def test_each_format_loader_defaults_to_the_card(fmt):
    module, name = LOADERS[fmt].split(".")
    load = getattr(importlib.import_module(f"pysp_tpu_torch.io.{module}"), name)
    blob = write_raw_format("pysp_tpu_torch.io", fmt, _stored(fmt))
    np.testing.assert_array_equal(load(blob, device="cpu").bayer.numpy(),
                                  raw_loader.load_raw(blob, device="cpu").bayer.numpy())
    if torch.cuda.is_available():
        assert load(blob).bayer.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load(blob)


@pytest.mark.parametrize("fmt", FORMATS + ["cr3"])
def test_format_detectors_claim_only_their_own_files(fmt):
    """Every ``is_<fmt>`` of the port claims exactly its own format's file."""
    blob = (write_synthetic_cr3() if fmt == "cr3"
            else write_raw_format("pysp_tpu_torch.io", fmt, _stored(fmt)))
    for other in FORMATS + ["cr3"]:
        if other == "dng":
            continue
        probe = getattr(importlib.import_module(f"pysp_tpu_torch.io.{other}"), f"is_{other}")
        assert probe(blob) == (fmt == other), (fmt, other)


def _patched(fmt):
    """A file of ``fmt`` that its decoder refuses with the ValueError that
    ``load_raw`` falls through on."""
    if fmt == "raf":
        from pysp_tpu_torch.io.raf import write_synthetic_raf

        return write_synthetic_raf(_stored("raf"), xtrans=True)
    data = bytearray(write_raw_format("pysp_tpu_torch.io", fmt, _stored(fmt)))
    if fmt == "rw2":   # RawFormat 4 -> 6
        idx = data.find(struct.pack("<HHL", 0x2D, 3, 1))
        struct.pack_into("<H", data, idx + 8, 6)
    else:              # the raw IFD's Compression: ARW 32767 -> 7, SRW 32770 -> 32772
        idx = data.find(struct.pack("<HH", 0x0103, 3))
        struct.pack_into("<H", data, idx + 8, 7 if fmt == "arw" else 32772)
    assert idx > 0
    return bytes(data)


FALL_THROUGHS = {
    "raf": "X-Trans", "arw": "unsupported compression 7",
    "rw2": "unsupported RawFormat", "srw": "unsupported compression",
}


@pytest.mark.parametrize("fmt", sorted(FALL_THROUGHS) + ["cr3", "garbage"])
def test_load_raw_falls_through_to_rawpy_as_the_jax_package_does(fmt, monkeypatch):
    """Without rawpy both packages raise the same ValueError; with rawpy
    importable both hand the file to ``load_raw_rawpy`` (CR3: to
    ``load_raw_cr3_rawpy``)."""
    if fmt == "cr3":
        blob = write_synthetic_cr3()
    elif fmt == "garbage":
        blob = b"not a raw file at all"
    else:
        blob = _patched(fmt)
        module = importlib.import_module(f"pysp_tpu_torch.io.{fmt}")
        with pytest.raises(ValueError, match=FALL_THROUGHS[fmt]):
            getattr(module, f"load_raw_{fmt}")(blob, device="cpu")
    with pytest.raises(ValueError, match="rawpy") as port_error:
        raw_loader.load_raw(blob, device="cpu")
    with pytest.raises(ValueError) as jax_error:
        jax_raw_loader.load_raw(blob)
    # the same words, each package naming its own module
    assert str(port_error.value) == str(jax_error.value).replace("pysp_tpu.", "pysp_tpu_torch.")

    monkeypatch.setitem(sys.modules, "rawpy", types.ModuleType("rawpy"))
    reached = []
    if fmt == "cr3":
        import pysp_tpu.io.cr3 as jax_cr3
        import pysp_tpu_torch.io.cr3 as port_cr3

        for mod in (jax_cr3, port_cr3):
            monkeypatch.setattr(mod, "load_raw_cr3_rawpy",
                                lambda source, **kw: reached.append(source) or "rawpy")
    else:
        for mod in (jax_raw_loader, raw_loader):
            monkeypatch.setattr(mod, "load_raw_rawpy",
                                lambda source, **kw: reached.append(source) or "rawpy")
    assert raw_loader.load_raw(blob, device="cpu") == "rawpy"
    assert jax_raw_loader.load_raw(blob) == "rawpy"
    assert reached == [blob, blob]


def test_a_nef_reaches_its_decoder_after_the_dng_attempt():
    from pysp_tpu_torch.io.nef import load_raw_nef

    blob = write_raw_format("pysp_tpu_torch.io", "nef", _stored("nef"))
    with pytest.raises((ValueError, KeyError, NotImplementedError)):
        raw_loader.load_raw_dng(blob, device="cpu")
    got = raw_loader.load_raw(blob, device="cpu")
    _assert_same_frame(got, jax_raw_loader.load_raw(blob))
    np.testing.assert_array_equal(got.bayer.numpy(), load_raw_nef(blob, device="cpu").bayer.numpy())


def _fake_rawpy(bayer):
    class FakeRaw:
        raw_image = bayer
        black_level_per_channel = [256] * 4
        camera_white_level_per_channel = [4095] * 4
        raw_pattern = np.array([[0, 1], [3, 2]])
        color_desc = b"RGBG"
        camera_whitebalance = [2.0, 1.0, 1.5, 1.0]

        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

    fake = types.ModuleType("rawpy")
    fake.imread = lambda reader: FakeRaw()
    return fake


@pytest.mark.parametrize("route", ["cr3", "dng_strict", "dng_lenient"])
def test_the_rawpy_routes_match_the_jax_package(route, monkeypatch):
    """With a stand-in for libraw, ``load_raw_cr3_rawpy`` and both modes of
    ``load_raw_rawpy`` give the JAX package's frame."""
    from pysp_tpu.io.tiff import write_synthetic_dng

    bayer = np.random.default_rng(3).integers(300, 3900, (32, 48)).astype(np.uint16)
    monkeypatch.setitem(sys.modules, "rawpy", _fake_rawpy(bayer))
    if route == "cr3":
        blob = write_synthetic_cr3(model=b"Canon EOS R5")
        got, want = load_raw_cr3_rawpy(blob, device="cpu"), jax_load_raw_cr3_rawpy(blob)
    else:
        blob = write_synthetic_dng(bayer)
        strict = route == "dng_strict"
        got = raw_loader.load_raw_rawpy(blob, strict=strict, device="cpu")
        want = jax_raw_loader.load_raw_rawpy(blob, strict=strict)
    _assert_same_frame(got, want)


def test_cr3_metadata_matches_the_jax_package():
    from pysp_tpu.io.cr3 import cr3_info as jax_cr3_info

    blob = write_synthetic_cr3(model=b"Canon EOS R6", wb_rggb=(2000, 1024, 1024, 1600))
    assert cr3_info(blob) == jax_cr3_info(blob)
    with pytest.raises(ValueError, match="rawpy"):
        load_raw_cr3_rawpy(blob, device="cpu")


@pytest.mark.parametrize("fmt", FORMATS + ["cr3"])
def test_info_prints_what_the_jax_cli_prints(fmt, tmp_path, capsys):
    blob = (write_synthetic_cr3() if fmt == "cr3"
            else _writer_defaults("pysp_tpu_torch.io", fmt, _stored(fmt)))
    path = tmp_path / f"shot.{fmt}"
    path.write_bytes(blob)
    assert jax_main(["info", str(path)]) == 0
    want = capsys.readouterr().out
    assert main(["info", str(path), "--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert got == want
    assert json.loads(got)["format"] in (fmt.upper(), "DNG/TIFF")


@pytest.mark.parametrize("fmt,bit_depth", [("cr2", 8), ("nef", 16)])
def test_the_slice_matches_the_jax_chain(fmt, bit_depth, tmp_path):
    """``develop x.<fmt>`` through the port's CLI (Best, default output
    ``x.png`` beside the input) against the JAX package's load -> develop ->
    ``save_image`` / ``save_png16`` (op by op): the same PNG size and depth,
    >= 50 dB (the AHD tie-flip floor of DIVERGENCES.md on synthetic scenes)."""
    from pysp_tpu.io.image_out import save_image as jax_save_image
    from pysp_tpu.io.image_out import save_png16 as jax_save_png16
    from pysp_tpu.pipeline.develop import DevelopConfig, develop

    h, w = 96, 128
    stored = raw_format_mosaic(fmt, mosaic_rggb(make_scene(h, w, seed=21)))
    path = tmp_path / f"x.{fmt}"
    path.write_bytes(write_raw_format("pysp_tpu_torch.io", fmt, stored))
    args = ["develop", str(path), "--device", "cpu"]
    if bit_depth == 16:
        args += ["--bit-depth", "16"]
    assert main(args) == 0
    got = read_png((tmp_path / "x.png").read_bytes())

    with jax.disable_jit():
        img = np.asarray(develop(jax_raw_loader.load_raw(str(path)), DevelopConfig()))
    (jax_save_png16 if bit_depth == 16 else jax_save_image)(str(tmp_path / "jax.png"), img)
    want = read_png((tmp_path / "jax.png").read_bytes())
    assert got.shape == want.shape == (h, w, 3) and got.dtype == want.dtype
    top = np.iinfo(got.dtype).max
    assert psnr(got.astype(np.float64) / top, want.astype(np.float64) / top) >= 50.0


def test_info_of_a_dng_reads_no_frame(tmp_path, capsys, monkeypatch):
    """``info`` of a DNG is metadata only: it runs with the default device
    (the card) where no card is present, and loads no frame."""
    monkeypatch.setattr(raw_loader, "load_raw",
                        lambda *a, **k: pytest.fail("info of a DNG loaded a frame"))
    path = tmp_path / "shot.dng"
    path.write_bytes(write_raw_format("pysp_tpu_torch.io", "dng", _stored("dng")))
    assert main(["info", str(path)]) == 0
    assert json.loads(capsys.readouterr().out)["format"] == "DNG/TIFF"
