"""The port's camera-matrix registry and persistent harvest cache against the
JAX package's (``io/camera_matrices.py``, ``io/matrix_cache.py``).

The registry resolves every body as the JAX package does; a cache file that
either package writes is the other's byte for byte and is read by the other;
a dual-illuminant DNG's load harvests its rows (``PYSP_TPU_NO_AUTOHARVEST``
turns that off); ``controller_for_source`` finds harvested rows for a MakerNote
format; the ``harvest`` subcommand prints what the JAX CLI prints.
"""
import json

import numpy as np
import pytest
import torch

import pysp_tpu.io.camera_matrices as jax_cm
import pysp_tpu.io.matrix_cache as jax_mc
import pysp_tpu_torch.io.camera_matrices as port_cm
import pysp_tpu_torch.io.matrix_cache as port_mc
from pysp_tpu.cli import main as jax_main
from pysp_tpu.io.raw_loader import controller_for_source as jax_controller_for_source
from pysp_tpu.io.raw_loader import load_raw as jax_load_raw
from pysp_tpu_torch.cli import main
from pysp_tpu_torch.io.cr2 import write_synthetic_cr2
from pysp_tpu_torch.io.image_out import save_tiff16
from pysp_tpu_torch.io.raw_loader import controller_for_source, load_raw
from pysp_tpu_torch.io.tiff import write_synthetic_dng

torch.set_num_threads(1)

CM1 = np.array([[0.81, -0.11, -0.05], [-0.31, 1.21, 0.15], [0.01, -0.21, 1.11]])
CM2 = np.array([[0.61, 0.05, -0.08], [-0.51, 1.41, 0.21], [-0.11, 0.15, 0.71]])
BODY = "Canon EOS 5D Mark III"
PACKAGES = {"jax": (jax_cm, jax_mc), "port": (port_cm, port_mc)}


@pytest.fixture(autouse=True)
def cache_file(tmp_path, monkeypatch):
    """An empty cache file of this test's own, both registries empty as in a
    fresh process (other tests' loads and registrations leave bodies in
    them), and both restored afterwards."""
    path = tmp_path / "harvested_matrices.json"
    monkeypatch.setenv("PYSP_TPU_MATRIX_CACHE", str(path))
    monkeypatch.delenv("PYSP_TPU_NO_AUTOHARVEST", raising=False)
    before = {}
    for cm, _ in PACKAGES.values():
        monkeypatch.setattr(cm, "_cache_loaded", False)
        before[cm] = dict(cm._REGISTRY)
        cm._REGISTRY.clear()
    yield path
    for cm, registry in before.items():
        cm._REGISTRY.clear()
        cm._REGISTRY.update(registry)


def _fresh_process():
    for cm, _ in PACKAGES.values():
        cm._REGISTRY.pop(BODY, None)
        cm._REGISTRY.pop(cm._norm_model(BODY), None)
        cm._cache_loaded = False


def _dng(model=None):
    """A dual-illuminant DNG; its EXIF model is the writer's ``synthetic``
    unless ``model`` (at most nine characters) replaces it."""
    blob = write_synthetic_dng(np.full((8, 8), 1000, np.uint16),
                               color_matrix_1=CM1, color_matrix_2=CM2)
    if model is not None:
        blob = blob.replace(b"synthetic\x00", model.ljust(9, b"\x00") + b"\x00")
    return blob


def _as_tuples(mats):
    return [(np.asarray(m.mat).tolist(), np.asarray(m.xyz).tolist(), m.series, m.provenance)
            for m in mats]


@pytest.mark.parametrize("model", [BODY, "EOS 5D Mark III", "NIKON D850", "ILCE-7M3",
                                   "DMC-G7", "GFX 50S", "unknown body", None])
def test_the_registry_resolves_what_the_jax_package_resolves(model):
    assert _as_tuples(port_cm.resolve_camera_matrices(model)) == _as_tuples(
        jax_cm.resolve_camera_matrices(model))
    jax_rows = jax_cm.lookup_camera_matrices(model)
    port_rows = port_cm.lookup_camera_matrices(model)
    assert (port_rows is None) == (jax_rows is None)
    if jax_rows is not None:
        assert _as_tuples(port_rows) == _as_tuples(jax_rows)


def test_the_stda_estimate_matches_the_jax_package():
    for key, row in sorted(port_cm._ADOBE_D65.items()):
        assert jax_cm._ADOBE_D65[key] == row
        d65 = np.asarray(row, np.float64).reshape(3, 3) / 10000
        np.testing.assert_array_equal(port_cm.estimate_std_a_matrix(d65),
                                      jax_cm.estimate_std_a_matrix(d65), err_msg=key)
    assert port_mc.CACHE_FORMAT_VERSION == jax_mc.CACHE_FORMAT_VERSION == 1


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_a_cache_one_package_writes_the_other_reads(writer, reader, cache_file):
    """The harvest of one DNG writes the same cache file in either package,
    and a fresh process of the other package serves its rows."""
    w_cm, _ = PACKAGES[writer]
    w_cm.harvest_camera_matrices_from_dng(_dng(), model=BODY, source_name="5d3.dng")
    written = cache_file.read_bytes()
    cache_file.unlink()
    PACKAGES[reader][0].harvest_camera_matrices_from_dng(_dng(), model=BODY,
                                                         source_name="5d3.dng")
    assert cache_file.read_bytes() == written
    doc = json.loads(written)
    assert doc["version"] == 1 and BODY in doc["bodies"]

    _fresh_process()
    r_cm, _ = PACKAGES[reader]
    rows = r_cm.lookup_camera_matrices("EOS 5D Mark III")
    assert all(m.provenance == "harvested" for m in rows)
    assert _as_tuples(rows) == _as_tuples(w_cm.lookup_camera_matrices("EOS 5D Mark III"))


@pytest.mark.parametrize("opt_out", [False, True])
def test_a_dng_load_harvests_its_rows(opt_out, cache_file, monkeypatch):
    """The port's DNG load writes the JAX package's cache file; a repeat load
    leaves it alone; ``PYSP_TPU_NO_AUTOHARVEST`` stops the write."""
    if opt_out:
        monkeypatch.setenv("PYSP_TPU_NO_AUTOHARVEST", "1")
    load_raw(_dng(), device="cpu")
    if opt_out:
        assert not cache_file.exists()
        return
    written = cache_file.read_bytes()
    mtime = cache_file.stat().st_mtime_ns
    load_raw(_dng(), device="cpu")
    assert cache_file.stat().st_mtime_ns == mtime
    cache_file.unlink()
    jax_load_raw(_dng())
    assert cache_file.read_bytes() == written


def test_controller_for_source_serves_harvested_rows_to_a_cr2(cache_file):
    """A CR2 of a body harvested from a DNG in an earlier process: the
    controller holds the harvested rows, and its WB for a colour temperature
    is the JAX package's."""
    port_cm.harvest_camera_matrices_from_dng(_dng(), model=BODY)
    _fresh_process()
    rng = np.random.default_rng(3)
    blob = write_synthetic_cr2(rng.integers(300, 3900, (24, 32)).astype(np.uint16),
                               model=BODY.encode())
    got = controller_for_source(blob, load_raw(blob, device="cpu"))
    want = jax_controller_for_source(blob, jax_load_raw(blob))
    assert all(m.provenance == "harvested" for m in got._mats)
    assert _as_tuples(got._mats) == _as_tuples(want._mats)
    for ctrl in (got, want):
        ctrl.update_by_temperature(4300, allow_cross_blend=True)
    np.testing.assert_array_equal(got.get_neutral(), want.get_neutral())
    np.testing.assert_array_equal(got.get_matrix().mat, want.get_matrix().mat)


def test_harvest_prints_what_the_jax_cli_prints(tmp_path, cache_file, capsys):
    shots = tmp_path / "shots"
    shots.mkdir()
    (shots / "a.dng").write_bytes(_dng())
    (shots / "b.dng").write_bytes(_dng(model=b"othercam"))
    (shots / "notes.txt").write_text("not a raw file")
    bad = tmp_path / "rgb.tif"   # a TIFF without calibration rows: skipped
    save_tiff16(str(bad), np.zeros((4, 6, 3), np.float32))
    args = ["harvest", str(shots), str(bad)]
    assert jax_main(args) == 0
    want = capsys.readouterr().out
    written = cache_file.read_bytes()
    cache_file.unlink()
    _fresh_process()
    assert main(args) == 0
    got = capsys.readouterr().out
    assert got == want
    assert cache_file.read_bytes() == written
    assert "harvested 2 bodies from 2/3 files" in got
