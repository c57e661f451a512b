"""pipeline/stream.py of pysp_tpu_torch against pysp_tpu's, on the CPU.

The JAX stream runs op by op (``jax.disable_jit``, as the other port tests
run the JAX develop), at the tolerances of ``test_torch_develop.py`` (Best:
>= 50 dB) and ``test_torch_tiers.py`` (Fast and Draft: 12.92e-6 on the
gamma-encoded image). Against its own sequential develop the port's stream
is held bit for bit: the same develop on the same frames.
"""
import threading
import time

import jax
import numpy as np
import pytest
import torch

from pysp_tpu.const import QualityDemosaic as JaxQuality
from pysp_tpu.pipeline.develop import DevelopConfig as JaxConfig
from pysp_tpu.pipeline.stream import develop_files as jax_develop_files
from pysp_tpu.pipeline.stream import develop_stream as jax_develop_stream
from pysp_tpu_torch import (
    DevelopConfig,
    QualityDemosaic,
    develop,
    develop_files,
    develop_stream,
    load_raw,
)
from pysp_tpu_torch.io import tiff as T
from pysp_tpu_torch.utils.testing import make_scene, mosaic_rggb, psnr, read_png

torch.set_num_threads(1)

MIN_PSNR = 50.0              # Best: the AHD tie-flip floor (test_torch_develop.py)
GAMMA_ATOL = 12.92 * 1e-6    # Fast and Draft, gamma-encoded (test_torch_tiers.py)
QUALITIES = ["Best", "Fast", "Draft"]


def _write_dngs(folder, n=4, h=48, w=64):
    """``n`` small RGGB DNGs of the test scene, every other one LJ92."""
    paths = []
    for i in range(n):
        u16 = (200 + mosaic_rggb(make_scene(h, w, seed=40 + i)) * 3800).astype(np.uint16)
        path = folder / f"f{i}.dng"
        path.write_bytes(T.write_synthetic_dng(
            u16, exposure_time=(1, 100 + 10 * i), compression=7 if i % 2 else 1))
        paths.append(str(path))
    return paths


@pytest.fixture(scope="module")
def dngs(tmp_path_factory):
    return _write_dngs(tmp_path_factory.mktemp("stream"))


def _cfgs(quality):
    return (DevelopConfig(quality=getattr(QualityDemosaic, quality)),
            JaxConfig(quality=getattr(JaxQuality, quality)))


@pytest.mark.parametrize("quality", QUALITIES)
def test_stream_matches_the_jax_stream(dngs, quality):
    cfg, jax_cfg = _cfgs(quality)
    got = list(develop_stream(dngs, cfg, device="cpu"))
    with jax.disable_jit():
        want = list(jax_develop_stream(dngs, jax_cfg))
    assert [s for s, _ in got] == [s for s, _ in want] == dngs
    for (_, g), (_, w) in zip(got, want):
        assert isinstance(g, np.ndarray) and g.shape == w.shape == (48, 64, 3)
        assert g.dtype == np.float32
        if quality == "Best":
            assert psnr(g, w) >= MIN_PSNR
        else:
            assert np.abs(g - w).max() <= GAMMA_ATOL


@pytest.mark.parametrize("decode_workers,prefetch", [(1, 0), (2, 1), (4, 2), (3, 5)])
def test_stream_equals_the_sequential_develop(dngs, decode_workers, prefetch):
    cfg = DevelopConfig()
    got = list(develop_stream(dngs, cfg, decode_workers=decode_workers, prefetch=prefetch,
                              device="cpu"))
    assert [s for s, _ in got] == dngs
    for src, img in got:
        np.testing.assert_array_equal(img, develop(load_raw(src, device="cpu"), cfg).numpy())


def test_order_is_kept_when_later_files_decode_first(dngs):
    """The first file decodes last; the stream still yields in input order."""
    done = []

    def slow_first(src):
        if src == dngs[0]:
            time.sleep(0.3)
        done.append(src)
        return load_raw(src, device="cpu")

    got = [s for s, _ in develop_stream(dngs, DevelopConfig(quality=QualityDemosaic.Draft),
                                        decode_workers=4, loader=slow_first, device="cpu")]
    assert done[-1] == dngs[0]
    assert got == dngs


def test_develop_files_writes_the_jax_pngs(dngs, tmp_path):
    """Both drivers' PNGs of the same files: equal names, within 1 LSB."""
    written = develop_files(dngs, str(tmp_path / "torch"), device="cpu")
    with jax.disable_jit():
        want = jax_develop_files(dngs, str(tmp_path / "jax"), JaxConfig())
    assert [p.split("/")[-1] for p in written] == [p.split("/")[-1] for p in want] == \
        [f"f{i}.png" for i in range(4)]
    for g, w in zip(written, want):
        with open(g, "rb") as a, open(w, "rb") as b:
            got, ref = read_png(a.read()), read_png(b.read())
        assert got.shape == ref.shape == (48, 64, 3) and got.dtype == ref.dtype == np.uint8
        assert np.abs(got.astype(np.int64) - ref.astype(np.int64)).max() <= 1


def test_an_empty_list_yields_nothing(tmp_path):
    assert list(develop_stream([], device="cpu")) == []
    assert develop_files([], str(tmp_path / "none"), device="cpu") == []
    assert (tmp_path / "none").is_dir()


def test_a_truncated_file_raises_and_names_it(dngs, tmp_path):
    bad = tmp_path / "cut.dng"
    with open(dngs[1], "rb") as fh:
        bad.write_bytes(fh.read()[:300])
    files = [dngs[0], str(bad), dngs[2]]
    with pytest.raises(ValueError, match="cut.dng"):
        list(develop_stream(files, device="cpu"))
    with pytest.raises(ValueError, match="cut.dng"):
        develop_files(files, str(tmp_path / "out"), device="cpu")


def test_a_save_error_raises_and_names_its_file(dngs, tmp_path):
    out = tmp_path / "out"
    (out / "f2.png").mkdir(parents=True)  # the destination is a directory
    with pytest.raises(OSError, match="f2.png"):
        develop_files(dngs, str(out), DevelopConfig(quality=QualityDemosaic.Draft),
                      device="cpu")


@pytest.mark.parametrize("decode_workers,prefetch", [(1, 0), (2, 1), (3, 2)])
def test_prefetch_bounds_the_frames_decoded_ahead(tmp_path, decode_workers, prefetch):
    """When the first image is yielded, the loader has been called for the
    ``prefetch + 1`` frames launched and the ``decode_workers + prefetch``
    waiting on the host, and for no other until the caller takes another."""
    paths = _write_dngs(tmp_path, n=decode_workers + 2 * prefetch + 4, h=16, w=16)
    calls, lock = [], threading.Lock()

    def counting(src):
        with lock:
            calls.append(src)
        return load_raw(src, device="cpu")

    bound = decode_workers + 2 * prefetch + 1
    stream = develop_stream(paths, DevelopConfig(quality=QualityDemosaic.Draft),
                            decode_workers=decode_workers, prefetch=prefetch,
                            loader=counting, device="cpu")
    first, _ = next(stream)
    deadline = time.monotonic() + 30
    while len(calls) < bound and time.monotonic() < deadline:
        time.sleep(0.01)
    time.sleep(0.2)
    assert first == paths[0]
    assert sorted(calls) == sorted(paths[:bound])
    rest = [s for s, _ in stream]
    assert [first] + rest == paths
    assert sorted(calls) == sorted(paths)


def test_the_stream_defaults_to_the_card(dngs):
    """Without ``device`` the stream develops on the card; with no GPU it raises."""
    if torch.cuda.is_available():
        assert len(list(develop_stream(dngs[:1]))) == 1
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        list(develop_stream(dngs))
