"""The lens-corrected chain on the card: against the benchmark's plain
reference there, the reference's row bands against its whole frame, and the
chain's spans, counter and remap launches.

Every test here needs an NVIDIA GPU and skips without one. The file imports
neither JAX nor the JAX package:

    python -m pytest --noconftest tests/test_torch_lens_cuda.py -q
"""
import json
from pathlib import Path

import pytest
import torch

from isp_bench import gen
from isp_bench.drivers import resident
from isp_bench.reference import develop as ref
from isp_bench.reference import lens as ref_lens
from pysp_tpu_torch import (
    DevelopConfig,
    Poly3CorrectionModel,
    develop_lens_corrected,
    encode_warp_rectilinear,
)
from pysp_tpu_torch.utils import tracing

pytestmark = pytest.mark.cuda

REPO = Path(__file__).resolve().parent.parent
CONF = json.loads((REPO / "isp_bench" / "configs" / "mf102.json").read_text())
CAMERA = CONF["camera"]
WARP = CONF["lens"]["warp_rectilinear"]
LIMITS = json.loads((REPO / "isp_bench" / "checks" / "mf102.lens.json").read_text())["limits"]
# About 2 px of CA at most at this size, as the configuration's k1 at 102 MP.
K1 = {"r": 0.0035, "b": -0.0035}
LENS = {"ca_models": {k: {"type": "Poly3", "k1": v} for k, v in K1.items()},
        "warp_rectilinear": WARP}
H, W = 1200, 1600


@pytest.fixture(scope="module", autouse=True)
def scratch_matrix_cache(tmp_path_factory):
    patch = pytest.MonkeyPatch()
    patch.setenv("PYSP_TPU_MATRIX_CACHE",
                 str(tmp_path_factory.mktemp("matrix_cache") / "harvested_matrices.json"))
    yield
    patch.undo()


@pytest.fixture(scope="module")
def counts():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    mosaic = gen.scene_mosaic(H, W, 2**31 + 5, 0, "cuda")
    sites = gen.hot_sites(mosaic, gen.sub_seed(2**31 + 5, 3), 20, 4)
    return gen.bracket_counts(mosaic, sites, [1.0])[0]


def _chain(counts):
    frame = resident._frame(counts, CAMERA, resident._controller(CAMERA),
                            CAMERA["exposure_time"], "cuda")
    models = tuple(Poly3CorrectionModel(K1[k]) for k in ("r", "b"))
    block = encode_warp_rectilinear(WARP["coefficients"], tuple(WARP["center"]))
    return develop_lens_corrected(frame, DevelopConfig(), ca_models=models,
                                  repair_hot_pixels=True, warp_block=block)


def _reference(counts, band_rows=None):
    return ref_lens.lens_chain(ref.frame(counts, CAMERA), LENS, CONF["detector"],
                               CONF["develop"], band_rows)


def test_the_chain_on_the_card_is_within_the_cells_limits(counts):
    got, want = _chain(counts), _reference(counts, 512)
    checks = {c.name: c for c in resident.compare(got, want, LIMITS)}
    assert all(c.ok for c in checks.values()), {n: c.value for n, c in checks.items()}


@pytest.mark.parametrize("band_rows", [512, 333])
def test_the_reference_in_bands_equals_the_whole_frame_on_the_card(counts, band_rows):
    assert torch.equal(_reference(counts, band_rows), _reference(counts))


def test_the_chain_spans_on_the_card(counts):
    from pysp_tpu_torch.ops import cuda_kernels as K

    _chain(counts)
    torch.cuda.synchronize()
    tracing.drain()
    launches = K.launch_counts["remap"], K.launch_counts["eag_resample"]
    tracing.enable()
    try:
        before = tracing.counters()
        _chain(counts)
    finally:
        tracing.disable()
    rec = tracing.drain()
    assert K.launch_counts["remap"] - launches[0] == 5
    assert K.launch_counts["eag_resample"] - launches[1] == 3
    names = [s.name for s in rec.spans]
    assert names.count("ca.remap") == 4 and names.count("warp.remap") == 1
    # the Poly3 models' coordinates are computed in the remap kernel: no
    # plain coordinate field, no ca.maps span
    assert names.count("ca.maps") == 0 and names.count("warp.maps") == 1
    # and the resamples run in the EAG kernels
    names = ("ca.maps_in_kernel", "ca.maps_built", "ca.resample_in_kernel")
    assert {k: rec.counters.get(k, 0) - before.get(k, 0) for k in names} == {
        "ca.maps_in_kernel": 4, "ca.maps_built": 0, "ca.resample_in_kernel": 3}
    # the chain's own spans are timed on the device; the develop's children
    # (develop.color_matrix, ...) are not
    timed = {s.name: s.device_ms for s in rec.spans
             if s.name.startswith(("ca.", "warp.")) or s.name in ("pipeline.detect", "develop")}
    assert len(timed) == 8
    assert all(ms is not None and ms > 0 for ms in timed.values()), timed
    by = {n: sum(s.device_ms for s in rec.spans if s.name == n)
          for n in ("ca.remove", "ca.maps", "ca.resample", "ca.remap")}
    assert by["ca.maps"] + by["ca.resample"] + by["ca.remap"] <= by["ca.remove"] * 1.01
