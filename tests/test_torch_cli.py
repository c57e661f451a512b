"""The port's command line (``python -m pysp_tpu_torch develop``) on the CPU.

The finishing path, ``develop --device cpu --deconv --unsharp --warp``, and the
corrections (``--flat --repair-hot-pixels``, ``--dark --denoise``, ``--hdr``)
are held against the same chains composed from the JAX package's functions,
run op by op (``jax.disable_jit()``), on the 16-bit TIFF they write.
"""
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pysp_tpu.colorimetry.transforms import lin_srgb_to_srgb
from pysp_tpu.filters.sharpen import gaussian_rt_deconvolution_yuv, unsharp_mask_lab
from pysp_tpu.io.raw_loader import load_raw_dng as jax_load_raw_dng
from pysp_tpu.pipeline.develop import DevelopConfig, develop
from pysp_tpu.pipeline.pipeline import PipelineConfig, develop_pipeline
from pysp_tpu.warp.opcodes import apply_opcode_3_warp
from pysp_tpu_torch.cli import main
from pysp_tpu_torch.io import tiff as T
from pysp_tpu_torch.io.image_out import to_uint16
from pysp_tpu_torch.utils.testing import make_scene, mosaic_rggb, psnr, read_png
from pysp_tpu_torch.warp.opcodes import encode_warp_rectilinear

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
# The AHD tie-flip floor of DIVERGENCES.md on synthetic quantized scenes.
MIN_PSNR = 50.0
WARP = [(1.0, -0.02, 0.0, 0.0, 0.0, 0.0)] * 3


@pytest.fixture(scope="module")
def warped_dng(tmp_path_factory):
    """A 160x192 RGGB DNG carrying an OpcodeList3 WarpRectilinear block."""
    rgb = make_scene(160, 192, seed=3)
    u16 = (200 + mosaic_rggb(rgb) * 3800).astype(np.uint16)
    block = encode_warp_rectilinear(WARP, (0.5, 0.5))
    path = tmp_path_factory.mktemp("cli") / "shot.dng"
    path.write_bytes(T.write_synthetic_dng(u16, opcode_list_3=block))
    return path, block


def _read_rgb16(path) -> np.ndarray:
    tf = T.read_tiff(str(path))
    ifd = tf.ifds[0]
    h = ifd.require(T.TAG_IMAGE_LENGTH).as_ints()[0]
    w = ifd.require(T.TAG_IMAGE_WIDTH).as_ints()[0]
    (offset,) = ifd.require(T.TAG_STRIP_OFFSETS).as_ints()
    data = np.frombuffer(tf.data, dtype=tf.endian + "u2", count=h * w * 3, offset=offset)
    return data.reshape(h, w, 3)


def test_finishing_path_matches_the_jax_chain(warped_dng, tmp_path):
    path, block = warped_dng
    out = tmp_path / "out.tif"
    assert main(["develop", str(path), "-o", str(out), "--device", "cpu",
                 "--deconv", "1.0:20", "--unsharp", "0.5:2", "--warp"]) == 0
    got = _read_rgb16(out)

    with jax.disable_jit():
        img = develop(jax_load_raw_dng(path.read_bytes()), DevelopConfig(gamma_encode=False))
        img = gaussian_rt_deconvolution_yuv(img, 1.0, 20)
        img = unsharp_mask_lab(img, 2.0, 0.5)
        img = lin_srgb_to_srgb(jnp.clip(img, 0.0, 1.0))
        img = np.asarray(apply_opcode_3_warp(img, block))
    want = to_uint16(img)
    assert got.shape == want.shape == (160, 192, 3)
    assert psnr(got.astype(np.float64) / 65535, want.astype(np.float64) / 65535) >= MIN_PSNR


@pytest.mark.parametrize("quality", ["draft", "fast"])
def test_draft_and_fast_match_the_jax_chain(warped_dng, tmp_path, quality):
    """``develop --quality draft|fast`` against ``develop`` of the JAX package,
    op by op: >= 50 dB on the TIFF, as the other CLI cases (neither tier has a
    pick to flip: measured, no sample more than one 16-bit code off)."""
    from pysp_tpu.const import QualityDemosaic

    path, _ = warped_dng
    out = tmp_path / f"{quality}.tif"
    assert main(["develop", str(path), "-o", str(out), "--device", "cpu",
                 "--quality", quality]) == 0
    got = _read_rgb16(out)

    cfg = DevelopConfig(quality={"draft": QualityDemosaic.Draft,
                                 "fast": QualityDemosaic.Fast}[quality])
    with jax.disable_jit():
        img = np.asarray(develop(jax_load_raw_dng(path.read_bytes()), cfg))
    want = to_uint16(img)
    assert got.shape == want.shape == (160, 192, 3)
    assert psnr(got.astype(np.float64) / 65535, want.astype(np.float64) / 65535) >= MIN_PSNR
    assert np.abs(got.astype(np.int64) - want.astype(np.int64)).max() <= 1


def test_the_cli_runs_as_a_module(warped_dng, tmp_path):
    path, _ = warped_dng
    out = tmp_path / "plain.tif"
    proc = subprocess.run(
        [sys.executable, "-m", "pysp_tpu_torch", "develop", str(path), "-o", str(out),
         "--device", "cpu", "--blur", "0.8", "--no-gamma"],
        capture_output=True, text=True, timeout=300, cwd=REPO,
    )
    assert proc.returncode == 0, proc.stderr
    assert f"-> {out}" in proc.stdout
    assert _read_rgb16(out).shape == (160, 192, 3)


def test_the_cli_defaults_to_the_card(warped_dng, tmp_path):
    """Without --device the CLI develops on the card; with no GPU it raises."""
    path, _ = warped_dng
    args = ["develop", str(path), "-o", str(tmp_path / "card.tif")]
    if torch.cuda.is_available():
        assert main(args) == 0
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(args)


def _dng(path, rgb_scale=1.0, exposure=(1, 100), hot=(), seed=3, flat=False):
    """A 160x192 RGGB DNG of the test scene (or of a vignetting flat field),
    with photosites at full scale at ``hot``."""
    if flat:
        yy, xx = np.mgrid[0:160, 0:192].astype(np.float32)
        mosaic = 1.0 - 0.4 * (((yy - 80) / 160) ** 2 + ((xx - 96) / 192) ** 2) * 2
    else:
        mosaic = np.clip(mosaic_rggb(make_scene(160, 192, seed=seed)) * rgb_scale, 0, 1)
    u16 = (200 + mosaic * 3800).astype(np.uint16)
    for y, x in hot:
        u16[y, x] = 4095
    path.write_bytes(T.write_synthetic_dng(u16, exposure_time=exposure))
    return path


HOT = [(31, 40), (90, 121), (120, 17), (52, 150), (53, 151)]


@pytest.mark.parametrize("case", ["flat_heal", "dark_denoise", "hdr"])
def test_corrections_match_the_jax_chain(case, tmp_path):
    """``--flat --repair-hot-pixels``, ``--dark --denoise 1.0`` and ``--hdr`` on
    three brackets (a stop apart, with hot photosites, healed by the burst's
    consensus masks as the JAX CLI does with --repair-hot-pixels) against
    ``develop_pipeline`` of the JAX package: >= 50 dB on the TIFF."""
    out = tmp_path / "out.tif"
    shot = _dng(tmp_path / "shot.dng", hot=HOT)
    if case == "flat_heal":
        aux = _dng(tmp_path / "flat.dng", flat=True)
        args, kw = ["--flat", str(aux), "--repair-hot-pixels"], {"flat": aux}
        pcfg = PipelineConfig(flat_field=True, repair_hot_pixels=True)
        inputs = [shot]
    elif case == "dark_denoise":
        aux = tmp_path / "dark.dng"
        aux.write_bytes(T.write_synthetic_dng(np.full((160, 192), 260, np.uint16)))
        args, kw = ["--dark", str(aux), "--denoise", "1.0"], {"dark": aux}
        pcfg = PipelineConfig(dark_frame=True, denoise_strength=1.0)
        inputs = [shot]
    else:
        inputs = [_dng(tmp_path / f"b{k}.dng", rgb_scale=2.0 ** (k - 1), hot=HOT,
                       exposure=(1, 200 // 2 ** k)) for k in range(3)]
        args, kw = ["--hdr", "--repair-hot-pixels"], {}
        pcfg = PipelineConfig(repair_hot_pixels=True, hot_pixel_shared_ratio=0.5,
                              fuse_hdr=True)
    assert main(["develop", *map(str, inputs), "-o", str(out), "--device", "cpu", *args]) == 0
    got = _read_rgb16(out)

    with jax.disable_jit():
        frames = [jax_load_raw_dng(p.read_bytes()) for p in inputs]
        frame = (jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *frames)
                 if case == "hdr" else frames[0])
        aux_frames = {k: jax_load_raw_dng(v.read_bytes()) for k, v in kw.items()}
        img = np.asarray(develop_pipeline(frame, pcfg, **aux_frames))
    want = to_uint16(img)
    assert got.shape == want.shape == (160, 192, 3)
    assert psnr(got.astype(np.float64) / 65535, want.astype(np.float64) / 65535) >= MIN_PSNR


def test_hdr_output_is_named_after_the_first_input(tmp_path):
    inputs = [_dng(tmp_path / f"b{k}.dng", rgb_scale=2.0 ** (k - 1),
                   exposure=(1, 200 // 2 ** k)) for k in range(2)]
    proc = subprocess.run(
        [sys.executable, "-m", "pysp_tpu_torch", "develop", *map(str, inputs),
         "--hdr", "--device", "cpu"],
        capture_output=True, text=True, timeout=300, cwd=REPO,
    )
    assert proc.returncode == 0, proc.stderr
    assert read_png((tmp_path / "b0_hdr.png").read_bytes()).shape == (160, 192, 3)


@pytest.fixture(scope="module")
def blown_dng(tmp_path_factory):
    """A 160x192 RGGB DNG whose bright blob clips: stored counts reach
    black + white (256 + 4095), which normalizes to 1.0."""
    h, w = 160, 192
    rgb = make_scene(h, w, seed=8)
    yy, xx = np.mgrid[0:h, 0:w]
    blob = np.exp(-(((yy - h / 2) / (h / 6)) ** 2 + ((xx - w / 3) / (w / 6)) ** 2))
    mosaic = mosaic_rggb((rgb * (1 + 1.5 * blob[..., None])).astype(np.float32))
    u16 = (256 + np.minimum(mosaic, 1.0) * 4095).astype(np.uint16)
    assert (u16 == 256 + 4095).mean() > 0.01
    path = tmp_path_factory.mktemp("cli_blown") / "blown.dng"
    path.write_bytes(T.write_synthetic_dng(u16))
    return path


def test_highlights_reconstruct_and_stats_match_the_jax_chain(blown_dng, tmp_path, capsys):
    """``develop --highlights reconstruct --stats`` writes the JAX chain's
    TIFF (op by op, within one 16-bit code) and prints the JAX CLI's stats
    JSON to stderr: the same keys, the sensor values within 1e-6 relative and
    the output's within 1e-5."""
    from pysp_tpu.pipeline.develop import develop_with_stats

    out = tmp_path / "rec.tif"
    assert main(["develop", str(blown_dng), "-o", str(out), "--device", "cpu",
                 "--highlights", "reconstruct", "--stats"]) == 0
    stats = json.loads(capsys.readouterr().err)
    got = _read_rgb16(out)

    with jax.disable_jit():
        frame = jax_load_raw_dng(blown_dng.read_bytes())
        img, want = develop_with_stats(frame, DevelopConfig(highlights="reconstruct"))
    want_img = to_uint16(np.asarray(img))
    assert got.shape == want_img.shape == (160, 192, 3)
    assert np.abs(got.astype(np.int64) - want_img.astype(np.int64)).max() <= 1
    assert {k: sorted(v) for k, v in stats.items()} == {k: sorted(v) for k, v in want.items()}
    for k, v in want["sensor"].items():
        np.testing.assert_allclose(stats["sensor"][k], np.asarray(v), rtol=1e-6, err_msg=k)
    for k, v in want["output"].items():
        np.testing.assert_allclose(stats["output"][k], np.asarray(v), atol=1e-5, err_msg=k)
    assert stats["sensor"]["clip_high_frac"] > 0.01

    # without --stats nothing is printed, and the clip develop differs
    clip = tmp_path / "clip.tif"
    assert main(["develop", str(blown_dng), "-o", str(clip), "--device", "cpu"]) == 0
    assert capsys.readouterr().err == ""
    assert not np.array_equal(_read_rgb16(clip), got)


def _shots(folder, n=3):
    """``n`` 48x64 RGGB DNGs of the test scene (every other one LJ92)."""
    folder.mkdir(parents=True, exist_ok=True)
    paths = []
    for k in range(n):
        u16 = (200 + mosaic_rggb(make_scene(48, 64, seed=60 + k)) * 3800).astype(np.uint16)
        path = folder / f"s{k}.dng"
        path.write_bytes(T.write_synthetic_dng(u16, compression=7 if k % 2 else 1))
        paths.append(path)
    return paths


def test_several_inputs_stream_into_a_directory(tmp_path, capsys):
    """A plain call with three inputs streams into ``-o DIR`` (created), with
    the JAX CLI's lines, and writes the PNGs that three single calls write."""
    shots = _shots(tmp_path / "in")
    out = tmp_path / "out"
    assert main(["develop", *map(str, shots), "-o", str(out), "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[:3] == [f"{p} -> {out / p.stem}.png" for p in shots]
    assert lines[3].startswith("3 files in ") and lines[3].endswith(" ms (streamed)")
    for p in shots:
        single = tmp_path / f"single_{p.stem}.png"
        assert main(["develop", str(p), "-o", str(single), "--device", "cpu"]) == 0
        assert (out / f"{p.stem}.png").read_bytes() == single.read_bytes()


def test_several_inputs_stream_beside_the_first_input_like_the_jax_cli(tmp_path):
    """Without ``-o`` the stream writes into the first input's directory;
    the PNGs are the JAX CLI's (run op by op) within one 8-bit code."""
    from pysp_tpu.cli import main as jax_main

    shots = _shots(tmp_path / "in")
    assert main(["develop", *map(str, shots), "--device", "cpu"]) == 0
    jax_dir = tmp_path / "jax"
    with jax.disable_jit():
        assert jax_main(["develop", *map(str, shots), "-o", str(jax_dir)]) == 0
    for p in shots:
        got = read_png((tmp_path / "in" / f"{p.stem}.png").read_bytes())
        want = read_png((jax_dir / f"{p.stem}.png").read_bytes())
        assert got.shape == want.shape == (48, 64, 3) and got.dtype == want.dtype == np.uint8
        assert np.abs(got.astype(np.int64) - want.astype(np.int64)).max() <= 1


def test_several_inputs_with_options_develop_one_by_one(tmp_path, capsys):
    """``--unsharp`` makes the call not plain: each input develops on its own
    into a new ``-o`` directory, as a single call with that option would."""
    shots = _shots(tmp_path / "in")
    out = tmp_path / "new" / "dir"
    assert main(["develop", *map(str, shots), "-o", str(out), "--device", "cpu",
                 "--unsharp", "0.5:1"]) == 0
    assert "(streamed)" not in capsys.readouterr().out
    assert sorted(f.name for f in out.iterdir()) == [f"{p.stem}.png" for p in shots]
    for p in shots:
        single = tmp_path / f"single_{p.stem}.png"
        assert main(["develop", str(p), "-o", str(single), "--device", "cpu",
                     "--unsharp", "0.5:1"]) == 0
        assert (out / f"{p.stem}.png").read_bytes() == single.read_bytes()


def test_bit_depth_16_with_several_inputs_writes_16_bit_pngs(tmp_path):
    """C5: the JAX CLI streams ``--bit-depth 16`` with several inputs and its
    stream writes 8-bit PNGs; the port develops such a call file by file and
    writes each file's 16-bit PNG, the one a single call writes."""
    from pysp_tpu.cli import main as jax_main

    shots = _shots(tmp_path / "in", n=2)
    out, jax_out = tmp_path / "out", tmp_path / "jax"
    assert main(["develop", *map(str, shots), "-o", str(out), "--device", "cpu",
                 "--bit-depth", "16"]) == 0
    assert jax_main(["develop", *map(str, shots), "-o", str(jax_out),
                     "--bit-depth", "16"]) == 0
    for p in shots:
        got = read_png((out / f"{p.stem}.png").read_bytes())
        assert got.shape == (48, 64, 3) and got.dtype == np.uint16
        single = tmp_path / f"single_{p.stem}.png"
        assert main(["develop", str(p), "-o", str(single), "--device", "cpu",
                     "--bit-depth", "16"]) == 0
        assert (out / f"{p.stem}.png").read_bytes() == single.read_bytes()
        assert read_png((jax_out / f"{p.stem}.png").read_bytes()).dtype == np.uint8
