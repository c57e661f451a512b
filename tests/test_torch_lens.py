"""The lens-corrected chain (``pipeline/lens.py``), on the CPU: against the
benchmark's plain reference (``isp_bench/reference/lens.py``), the command
line's output against the composition it ran before the chain was one
function, the reference's row bands against its whole frame, the chain's
spans and counter, and the remap roofline's counted work."""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from isp_bench import gen, roofline, roofline_remap
from isp_bench.drivers import resident
from isp_bench.reference import develop as ref
from isp_bench.reference import lens as ref_lens
from pysp_tpu_torch import (
    DevelopConfig,
    Poly3CorrectionModel,
    apply_opcode_3_warp,
    develop,
    develop_lens_corrected,
    encode_warp_rectilinear,
    find_erroneous_pixels_median,
    load_raw,
    remove_ca_from_raw,
    repair_bad_pixels,
)
from pysp_tpu_torch.cli import main
from pysp_tpu_torch.io import tiff as T
from pysp_tpu_torch.io.image_out import to_uint16
from pysp_tpu_torch.utils import tracing
from pysp_tpu_torch.utils.sidecar import save_sidecar

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
CONF = json.loads((REPO / "isp_bench" / "configs" / "mf102.json").read_text())
CAMERA = CONF["camera"]
WARP = CONF["lens"]["warp_rectilinear"]
# At these sizes a Poly3 k1 of 0.02 moves R and B by about 2 px at most, as
# the configuration's k1 does at 102 MP.
K1 = {"r": 0.02, "b": -0.02}
LENS = {"ca_models": {k: {"type": "Poly3", "k1": v} for k, v in K1.items()},
        "warp_rectilinear": WARP}
SHAPES = [(256, 384), (200, 296)]      # 296 is not a multiple of 16


def _counts(h, w, seed):
    mosaic = gen.scene_mosaic(h, w, seed, 0, "cpu")
    sites = gen.hot_sites(mosaic, gen.sub_seed(seed, 3), 6, 0)
    return gen.bracket_counts(mosaic, sites, [1.0])[0]


def _program_frame(counts):
    return resident._frame(counts, CAMERA, resident._controller(CAMERA),
                           CAMERA["exposure_time"], "cpu")


def _models():
    return Poly3CorrectionModel(K1["r"]), Poly3CorrectionModel(K1["b"])


def _block():
    return encode_warp_rectilinear(WARP["coefficients"], tuple(WARP["center"]))


def _chain(frame, fault=None):
    """The chain as the benchmark's cell calls it, or with one fault."""
    if fault == "bilinear_warp":
        out = develop_lens_corrected(frame, DevelopConfig(), ca_models=_models(),
                                     repair_hot_pixels=True)
        return apply_opcode_3_warp(out, _block(), interpolation="bilinear")
    return develop_lens_corrected(
        frame, DevelopConfig(), ca_models=None if fault == "no_ca" else _models(),
        repair_hot_pixels=fault != "no_heal", warp_block=_block())


def _reference(counts, band_rows=None):
    return ref_lens.lens_chain(ref.frame(counts, CAMERA), LENS, CONF["detector"],
                               CONF["develop"], band_rows)


@pytest.fixture(scope="module")
def scenes():
    return {shape: _counts(*shape, seed=2**31 + 97 + k) for k, shape in enumerate(SHAPES)}


@pytest.mark.parametrize("fault", [None, "no_ca", "bilinear_warp", "no_heal"])
@pytest.mark.parametrize("shape", SHAPES)
def test_the_chain_matches_the_plain_reference(scenes, shape, fault):
    """Exact on the CPU: the port runs its plain paths there (the remap
    kernel's plain version, the plain AHD, the plain multisection), which
    the reference copies operation for operation. The benchmark's own limits
    on the card (off_share, rms) are looser; the chain with the CA removal
    skipped, a bilinear warp or no heal exceeds the exact tolerance, and also
    the card's RMS limit."""
    counts = scenes[shape]
    got = _chain(_program_frame(counts), fault)
    want = _reference(counts)
    assert got.shape == want.shape == (*shape, 3)
    d = (got - want).abs()
    rms = float(torch.sqrt((d.double() ** 2).mean()))
    if fault is None:
        assert float(d.max()) == 0.0
    else:
        limit = json.loads((REPO / "isp_bench" / "checks" / "mf102.lens.json").read_text())
        assert float(d.max()) > 0.0
        assert rms > limit["limits"]["rms"], rms


# On the CPU a transcendental (pow, sin) takes its vectorised or its scalar
# path by the element's place in its tensor, which a band moves, and the two
# differ in the last bit; so a band's rows equal the whole frame's here up to
# two float32 roundings at 1.0. The card computes every element by one path,
# and tests/test_torch_lens_cuda.py holds the bands equal there.
BAND_TOLERANCE = 2.0**-22


@pytest.mark.parametrize("band_rows", [64, 50, 37])
def test_the_reference_in_bands_equals_the_whole_frame(scenes, band_rows):
    counts = scenes[SHAPES[1]]
    d = (_reference(counts, band_rows) - _reference(counts)).abs()
    assert float(d.max()) <= BAND_TOLERANCE
    assert float((d > 0).any(dim=-1).to(torch.float32).mean()) < 1e-3


def test_a_band_covers_the_rows_the_warp_reaches():
    """A warp whose maps reach past a band's rows still reads developed rows
    the band developed (the band is sized from the maps)."""
    counts = _counts(128, 192, seed=5)
    lens = {**LENS, "warp_rectilinear": {**WARP, "coefficients": [[0.9, 0.05, 0.0, 0.0, 0.0, 0.0]] * 3}}
    f = ref.frame(counts, CAMERA)
    whole = ref_lens.develop_and_warp(f, CONF["develop"], lens["warp_rectilinear"])
    banded = ref_lens.develop_and_warp(f, CONF["develop"], lens["warp_rectilinear"], 16)
    assert float((whole - banded).abs().max()) <= BAND_TOLERANCE


# --- the command line ---------------------------------------------------------------

def _read_rgb16(path) -> np.ndarray:
    tf = T.read_tiff(str(path))
    ifd = tf.ifds[0]
    h = ifd.require(T.TAG_IMAGE_LENGTH).as_ints()[0]
    w = ifd.require(T.TAG_IMAGE_WIDTH).as_ints()[0]
    (offset,) = ifd.require(T.TAG_STRIP_OFFSETS).as_ints()
    data = np.frombuffer(tf.data, dtype=tf.endian + "u2", count=h * w * 3, offset=offset)
    return data.reshape(h, w, 3)


def _parent_composition(path, sidecar, cfg, options):
    """What the command line composed for one input before the chain was one
    function: load, the sidecar's neutral, CA, heal, denoise, develop, the
    filters with clip and gamma, the warp."""
    from pysp_tpu_torch import denoise_bayer_wavelet, lin_srgb_to_srgb
    from pysp_tpu_torch.filters.sharpen import gaussian_rt_deconvolution_yuv, unsharp_mask_lab

    frame = load_raw(str(path), device="cpu")
    frame = frame.replace(wb_neutral=torch.tensor(sidecar["wb"], dtype=torch.float32))
    frame = remove_ca_from_raw(frame, *_models())
    frame = repair_bad_pixels(frame, find_erroneous_pixels_median(frame))
    if "denoise" in options:
        frame = denoise_bayer_wavelet(frame, 0.5)
    out = develop(frame, cfg)
    if "filters" in options:
        out = gaussian_rt_deconvolution_yuv(out, 1.0, 5)
        out = unsharp_mask_lab(out, 2.0, 0.5)
        out = lin_srgb_to_srgb(torch.clamp(out, 0.0, 1.0))
    return apply_opcode_3_warp(out, _block())


@pytest.mark.parametrize("options", [(), ("filters",), ("denoise", "stats")])
def test_the_cli_output_is_the_parent_composition_bit_for_bit(tmp_path, options):
    counts = _counts(160, 192, seed=11)
    path = tmp_path / "shot.dng"
    path.write_bytes(T.write_synthetic_dng(counts.numpy().astype(np.uint16),
                                           opcode_list_3=_block()))
    wb = [0.52, 1.0, 0.61]
    save_sidecar(str(tmp_path / "lens.json"), ca_model_r=_models()[0], ca_model_b=_models()[1],
                 wb_neutral=np.asarray(wb, np.float64))
    out = tmp_path / "out.tif"
    args = ["develop", str(path), "-o", str(out), "--device", "cpu", "--params",
            str(tmp_path / "lens.json"), "--repair-hot-pixels", "--warp"]
    if "filters" in options:
        args += ["--deconv", "1.0:5", "--unsharp", "0.5:2"]
    if "denoise" in options:
        args += ["--denoise", "0.5"]
    if "stats" in options:
        args += ["--stats"]
    assert main(args) == 0
    cfg = DevelopConfig(gamma_encode="filters" not in options)
    want = to_uint16(_parent_composition(path, {"wb": wb}, cfg, options))
    assert np.array_equal(_read_rgb16(out), want)


# --- spans and counters -----------------------------------------------------------

@pytest.fixture
def recorder():
    tracing.drain()
    tracing.enable()
    yield tracing
    tracing.disable()
    tracing.drain()


def test_the_chain_spans_nest_and_count_the_maps(recorder, scenes):
    frame = _program_frame(scenes[SHAPES[1]])
    before = tracing.counters().get("ca.maps_built", 0)
    _chain(frame)
    rec = recorder.drain()
    spans, by_id = rec.spans, {s.span_id: s for s in rec.spans}
    (root,) = [s for s in spans if s.name == "pipeline.develop_lens_corrected"]
    assert root.parent_id is None

    def children(parent):
        return [s.name for s in spans if s.parent_id == parent.span_id]

    assert children(root) == ["ca.remove", "pipeline.detect", "develop", "warp.opcode3"]
    (ca,) = [s for s in spans if s.name == "ca.remove"]
    assert children(ca) == ["ca.resample", "ca.maps", "ca.remap", "ca.resample", "ca.maps",
                            "ca.remap", "ca.maps", "ca.remap", "ca.resample", "ca.maps",
                            "ca.remap"]
    (warp,) = [s for s in spans if s.name == "warp.opcode3"]
    assert children(warp) == ["warp.maps", "warp.remap"]
    assert all(s.item == root.item for s in spans)
    assert all(by_id[s.parent_id].start_ns <= s.start_ns <= s.end_ns <= by_id[s.parent_id].end_ns
               for s in spans if s.parent_id is not None)
    assert rec.counters["ca.maps_built"] - before == 4
    # on the CPU nothing is timed on the device, and no span reads the CPU clock
    assert all(s.device_ms is None and s.cpu_ns is None for s in spans)


def test_a_burst_builds_the_maps_once_and_one_model_two(recorder, scenes):
    from pysp_tpu_torch import stack_frames

    frame = _program_frame(scenes[SHAPES[1]])
    before = tracing.counters().get("ca.maps_built", 0)
    remove_ca_from_raw(stack_frames([frame, frame], device="cpu"), *_models())
    remove_ca_from_raw(frame, _models()[0], None)
    rec = recorder.drain()
    assert rec.counters["ca.maps_built"] - before == 6
    assert [s.name for s in rec.spans].count("ca.remap") == 6


class _FormlessPoly3(Poly3CorrectionModel):
    """A reversible model that states no radial form: its remaps keep the
    plain coordinate maps."""

    def kernel_form(self):
        return None


@pytest.mark.parametrize("models", ["both_with_forms", "b_without"])
def test_the_counters_split_between_kernel_and_plain_maps(recorder, scenes, monkeypatch,
                                                           models):
    """With the device test passed over (``_kernel_form`` as it answers on the
    card) and the radial launch stubbed by its plain version, a model with a
    radial form remaps without a coordinate field: ``ca.maps_in_kernel``
    counts its two remaps, no ``ca.maps`` span opens; a model without one
    builds its two plain fields (``ca.maps_built``). The output lies within
    the one rounding that differs on the CPU (the radius over the corner's:
    a division here, a multiply by the reciprocal on the card) of the plain
    path's."""
    from pysp_tpu_torch.correct.ca import removal
    from pysp_tpu_torch.ops import cuda_kernels as K

    frame = _program_frame(scenes[SHAPES[1]])
    model_r = Poly3CorrectionModel(K1["r"])
    model_b = (Poly3CorrectionModel if models == "both_with_forms" else _FormlessPoly3)(K1["b"])
    want = remove_ca_from_raw(frame, model_r, model_b).bayer
    launches = []

    def radial(stack, form, inverse):
        launches.append((tuple(stack.shape), form[0], inverse))
        return K.remap_radial_plain(stack, form, inverse)

    monkeypatch.setattr(removal, "_kernel_form", lambda model, stack: model.kernel_form())
    monkeypatch.setattr(removal, "remap_radial_kernel", radial)
    recorder.drain()
    before = tracing.counters()
    got = remove_ca_from_raw(frame, model_r, model_b).bayer
    rec = recorder.drain()
    counted = {k: rec.counters.get(k, 0) - before.get(k, 0)
               for k in ("ca.maps_in_kernel", "ca.maps_built")}
    (ca,) = [s for s in rec.spans if s.name == "ca.remove"]
    children = [s.name for s in rec.spans if s.parent_id == ca.span_id]
    h, w = SHAPES[1]
    if models == "both_with_forms":
        assert launches == [((1, h, w), "poly3", True), ((1, h, w), "poly3", False)] * 2
        assert counted == {"ca.maps_in_kernel": 4, "ca.maps_built": 0}
        assert children == ["ca.resample", "ca.remap", "ca.resample", "ca.remap",
                            "ca.remap", "ca.resample", "ca.remap"]
    else:
        assert launches == [((1, h, w), "poly3", True), ((1, h, w), "poly3", False)]
        assert counted == {"ca.maps_in_kernel": 2, "ca.maps_built": 2}
        assert children == ["ca.resample", "ca.remap", "ca.resample", "ca.remap",
                            "ca.maps", "ca.remap", "ca.resample", "ca.maps", "ca.remap"]
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5)


def test_a_cpu_frame_takes_the_plain_maps(recorder, scenes):
    """On CPU tensors every model builds its plain coordinate maps, whatever
    its form, and the resamples run their plain versions: nothing counts in
    ``ca.maps_in_kernel`` or ``ca.resample_in_kernel``."""
    before = tracing.counters()
    remove_ca_from_raw(_program_frame(scenes[SHAPES[1]]), *_models())
    rec = recorder.drain()
    names = ("ca.maps_in_kernel", "ca.maps_built", "ca.resample_in_kernel")
    assert {k: rec.counters.get(k, 0) - before.get(k, 0) for k in names} == {
        "ca.maps_in_kernel": 0, "ca.maps_built": 4, "ca.resample_in_kernel": 0}


def test_the_recorder_off_records_nothing(scenes):
    tracing.disable()
    tracing.drain()
    before = tracing.counters().get("ca.maps_built", 0)
    _chain(_program_frame(scenes[SHAPES[1]]))
    assert tracing.drain().spans == []
    assert tracing.counters().get("ca.maps_built", 0) == before


# --- the remap roofline's counted work ------------------------------------------------

def test_the_remap_operations_a_pixel_recounted():
    h, w = 64, 96
    g = torch.Generator().manual_seed(3)
    img = torch.rand((3, h, w), generator=g)
    mx = (torch.arange(w, dtype=torch.float32)[None, :] + 0.3 * torch.rand((h, w), generator=g))
    my = (torch.arange(h, dtype=torch.float32)[:, None] + 0.3 * torch.rand((h, w), generator=g))
    with roofline.FloatOpCount() as counter:
        ref_lens.remap_bilinear(img[0], mx, my)
    assert counter.ops / (h * w) == roofline_remap.BILINEAR_OPS_PER_PX
    with roofline.FloatOpCount() as counter:
        ref_lens.remap_lanczos4(img, mx, my)
    assert counter.ops / (h * w) == roofline_remap.LANCZOS4_OPS_PER_PX


def test_the_least_time_of_a_102mp_item():
    px = 8736 * 11648
    ca = 16 * px / 3.35e12                      # bound by bytes
    warp = 738 * px / 67e12                     # bound by operations
    assert roofline_remap.item_least_s(px) == pytest.approx(4 * ca + warp)
    assert 32 * px / 3.35e12 < warp and 16 * px / 67e12 < ca
    assert roofline_remap.is_remap_kernel("(anonymous namespace)::bilinear_kernel<true, int>")
    assert roofline_remap.is_remap_kernel("(anonymous namespace)::lanczos4_kernel<3>")
    assert not roofline_remap.is_remap_kernel("at::native::upsample_bilinear2d_out_frame<float>")
    assert not roofline_remap.is_remap_kernel("pysp::ahd_kernel<1>")

