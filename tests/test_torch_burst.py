"""io/raw_loader.load_burst of pysp_tpu_torch against pysp_tpu's, on the CPU,
on the blobs of ``tests/test_io.py::test_load_burst``."""
import threading

import jax
import numpy as np
import pytest
import torch

from pysp_tpu.const import QualityDemosaic as JaxQuality
from pysp_tpu.io.raw_loader import load_burst as jax_load_burst
from pysp_tpu.pipeline.develop import DevelopConfig as JaxConfig
from pysp_tpu.pipeline.develop import develop_burst as jax_develop_burst
from pysp_tpu_torch import (
    DevelopConfig,
    QualityDemosaic,
    develop_burst,
    load_burst,
    load_raw,
    stack_frames,
)
from pysp_tpu_torch.io import native
from pysp_tpu_torch.io import tiff as T

torch.set_num_threads(1)

FIELDS = ("bayer", "cam_mat", "cam_white", "wb_neutral", "ev", "lim_sat")
GAMMA_ATOL = 12.92 * 1e-6    # Draft, gamma-encoded (test_torch_tiers.py)


def _bayer_u16(h, w, seed):
    return np.random.default_rng(seed).integers(200, 4000, (h, w)).astype(np.uint16)


def _blobs(n=4, h=32, w=32):
    return [T.write_synthetic_dng(_bayer_u16(h, w, 20 + i), exposure_time=(1, 100 + i))
            for i in range(n)]


def test_load_burst_matches_the_jax_burst():
    blobs = _blobs()
    got = load_burst(blobs, device="cpu")
    want = jax_load_burst(blobs)
    assert got.bayer.shape == (4, 32, 32) and got.ev.shape == (4,)
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(got, k).numpy(), np.asarray(getattr(want, k)),
                                      err_msg=k)
    assert got.is_hdr == want.is_hdr and int(got.source_pattern) == int(want.source_pattern)

    out = develop_burst(got, DevelopConfig(quality=QualityDemosaic.Draft))
    with jax.disable_jit():
        ref = np.asarray(jax_develop_burst(want, JaxConfig(quality=JaxQuality.Draft)))
    assert out.shape == ref.shape == (4, 32, 32, 3)
    assert np.abs(out.numpy() - ref).max() <= GAMMA_ATOL


@pytest.mark.parametrize("max_workers", [1, 3, 8])
def test_load_burst_equals_the_frames_stacked(max_workers):
    """One stacked copy of the host frames: the frames loaded one by one,
    stacked, bit for bit, whatever the pool's size."""
    blobs = _blobs(n=5)
    got = load_burst(blobs, max_workers=max_workers, device="cpu")
    want = stack_frames([load_raw(b, device="cpu") for b in blobs], device="cpu")
    for k in FIELDS:
        assert torch.equal(getattr(got, k), getattr(want, k)), k


@pytest.mark.parametrize("case", ["shape", "pattern"])
def test_frames_that_disagree_raise_the_jax_error(case):
    blobs = _blobs(n=2)
    if case == "shape":
        blobs.append(T.write_synthetic_dng(_bayer_u16(32, 48, 9)))
        match = r"burst frames disagree: shapes=\{.*\(32, 48\).*\}"
    else:
        blobs.append(T.write_synthetic_dng(_bayer_u16(32, 32, 9), cfa_pattern=(2, 1, 1, 0)))
        match = r"burst frames disagree: .*patterns="
    with pytest.raises(ValueError, match=match):
        load_burst(blobs, device="cpu")
    with pytest.raises(ValueError, match=match):
        jax_load_burst(blobs)


def test_no_sources_raise_the_jax_error():
    with pytest.raises(ValueError, match="load_burst needs at least one source"):
        load_burst([], device="cpu")
    with pytest.raises(ValueError, match="load_burst needs at least one source"):
        jax_load_burst([])


def test_load_burst_defaults_to_the_card():
    if torch.cuda.is_available():
        assert load_burst(_blobs(n=2)).bayer.is_cuda
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_burst(_blobs(n=2))


def test_the_native_library_binds_once_for_threads_that_ask_at_once(monkeypatch):
    """Decode threads that make the native library's first call together
    all find it (the first builds and binds it, the others wait)."""
    monkeypatch.setattr(native, "_TRIED", False)
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "loaded_path", None)
    start = threading.Barrier(8)
    seen = []

    def ask():
        start.wait(timeout=30)
        seen.append(native.available() and native._LIB is not None)

    threads = [threading.Thread(target=ask) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert seen == [True] * 8
