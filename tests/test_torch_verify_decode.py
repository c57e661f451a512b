"""The port's decode cross-check (``io/verify_decode.py``) against the JAX
package's: the same report for every format without rawpy (``rawpy-unavailable``
for the built-in formats, ``no-builtin`` for CR3 and the fall-throughs), and
with a stand-in for libraw (``match`` and ``mismatch``); the directory sweep,
its table and the ``verify-decode`` subcommand's output and exit code.
"""
import sys
import types

import numpy as np
import pytest
import torch

import pysp_tpu.io.camera_matrices as jax_cm
import pysp_tpu.io.verify_decode as jax_vd
import pysp_tpu_torch.io.camera_matrices as port_cm
import pysp_tpu_torch.io.verify_decode as port_vd
from pysp_tpu.cli import main as jax_main
from pysp_tpu_torch.cli import main
from pysp_tpu_torch.io.cr3 import write_synthetic_cr3
from pysp_tpu_torch.io.raf import write_synthetic_raf
from pysp_tpu_torch.io.tiff import write_synthetic_dng
from pysp_tpu_torch.utils.testing import (
    RAW_FORMATS,
    make_scene,
    mosaic_rggb,
    raw_format_mosaic,
    write_raw_format,
)

torch.set_num_threads(1)
# The writers' synthetic bodies have no calibration rows: the loaders warn.
pytestmark = pytest.mark.filterwarnings("ignore:no color calibration")

H, W = 32, 224


@pytest.fixture(autouse=True)
def fresh_matrix_cache(tmp_path, monkeypatch):
    """Both packages' camera-matrix registries empty, as in a fresh process,
    over an empty cache file of this test's own; restored afterwards."""
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


def _file(tmp_path, fmt):
    if fmt == "cr3":
        blob = write_synthetic_cr3()
    elif fmt == "xtrans.raf":
        blob = write_synthetic_raf(raw_format_mosaic("raf", mosaic_rggb(make_scene(H, W))),
                                   xtrans=True)
    elif fmt == "garbage":
        blob = b"not a raw file at all"
    elif fmt == "broken.mrw":   # MRW magic, no block directory
        blob = b"\x00MRM" + b"\xff" * 4
    else:
        blob = write_raw_format("pysp_tpu_torch.io", fmt,
                                raw_format_mosaic(fmt, mosaic_rggb(make_scene(H, W, seed=2))))
    path = tmp_path / f"shot.{fmt}"
    path.write_bytes(blob)
    return str(path)


@pytest.mark.parametrize("fmt", sorted(RAW_FORMATS) + ["cr3", "xtrans.raf", "garbage", "broken.mrw"])
def test_reports_match_the_jax_package_without_rawpy(fmt, tmp_path):
    path = _file(tmp_path, fmt)
    got = port_vd.verify_decode(path, name=path, device="cpu")
    assert got == jax_vd.verify_decode(path, name=path)
    want_verdict = {"cr3": "no-builtin", "xtrans.raf": "no-builtin", "garbage": "no-builtin",
                    "broken.mrw": "builtin-error"}.get(fmt, "rawpy-unavailable")
    assert got["verdict"] == want_verdict


def _fake_rawpy(bayer, black):
    class FakeRaw:
        raw_image = bayer
        black_level_per_channel = [black] * 4
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


@pytest.mark.parametrize("libraw_black,verdict", [(0, "match"), (400, "mismatch")])
def test_reports_match_the_jax_package_with_libraw(libraw_black, verdict, tmp_path, monkeypatch):
    """A stand-in libraw that reads the DNG's stored values: with the file's
    black level the decodes agree bit for bit, with another they do not."""
    bayer = (256 + mosaic_rggb(make_scene(H, W)) * 3000).astype(np.uint16)
    path = tmp_path / "shot.dng"
    path.write_bytes(write_synthetic_dng(bayer, black_level=0))
    monkeypatch.setitem(sys.modules, "rawpy", _fake_rawpy(bayer, libraw_black))
    got = port_vd.verify_decode(str(path), device="cpu")
    assert got == jax_vd.verify_decode(str(path))
    assert got["verdict"] == verdict


def test_the_sweep_and_the_subcommand_match_the_jax_cli(tmp_path, capsys):
    shots = tmp_path / "shots"
    (shots / "nested").mkdir(parents=True)
    for fmt in ("cr2", "nef", "orf"):
        _file(shots, fmt)
    _file(shots / "nested", "cr3")
    (shots / "notes.txt").write_text("not a raw file")
    paths = list(port_vd.iter_raw_files(str(shots)))
    assert paths == list(jax_vd.iter_raw_files(str(shots))) and len(paths) == 4
    reports, summary = port_vd.sweep_decode(paths, device="cpu")
    want_reports, want_summary = jax_vd.sweep_decode(paths)
    assert (reports, summary) == (want_reports, want_summary)
    assert port_vd.summary_table(summary) == jax_vd.summary_table(want_summary)

    rc = jax_main(["verify-decode", str(shots)])
    want = capsys.readouterr().out
    assert main(["verify-decode", str(shots), "--device", "cpu"]) == rc == 0
    assert capsys.readouterr().out == want

    bad = _file(tmp_path, "broken.mrw")
    rc = jax_main(["verify-decode", paths[0], bad])
    want = capsys.readouterr().out
    assert main(["verify-decode", paths[0], bad, "--device", "cpu"]) == rc == 1
    assert capsys.readouterr().out == want
