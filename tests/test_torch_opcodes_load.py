"""DNG OpcodeList1 / OpcodeList2 of pysp_tpu_torch against pysp_tpu, at load.

The same opcode blocks, written with the encoders as tests/test_warp.py
writes them, go through the JAX package's functions and the port's.
Tolerances: the gain maps and the vignette within 1e-6 relative (measured
bit-equal: the grid is the same host NumPy and the device multiply is one
float32 product); the opcode heal within 1e-6 (the diffusion's seed is a
plane mean, summed in another order); ``load_raw`` of a DNG with both lists
within 1e-6 of ``load_raw_dng``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pysp_tpu.io import tiff as JT
from pysp_tpu.io.raw_loader import load_raw_dng as jax_load_raw_dng
from pysp_tpu.warp import fix_opcodes as JF
from pysp_tpu.warp import gain_opcodes as JG
from pysp_tpu_torch import load_raw
from pysp_tpu_torch.io import tiff as TT
from pysp_tpu_torch.io.raw_loader import load_raw_dng
from pysp_tpu_torch.warp import fix_opcodes as TF
from pysp_tpu_torch.warp import gain_opcodes as TG

torch.set_num_threads(1)

FIELDS = ("bayer", "cam_mat", "cam_white", "wb_neutral", "ev", "lim_sat")


def _gain_map(h, w, gains, top=0, left=0, bottom=None, right=None, pitch=(1, 1),
              origin=(0.0, 0.0)):
    pv, ph = gains.shape
    return TG.GainMap(
        top=top, left=left, bottom=h if bottom is None else bottom,
        right=w if right is None else right, plane=0, planes=1,
        row_pitch=pitch[0], col_pitch=pitch[1], points_v=pv, points_h=ph,
        spacing_v=1.0 / max(pv - 1, 1), spacing_h=1.0 / max(ph - 1, 1),
        origin_v=origin[0], origin_h=origin[1], map_planes=1,
        gains=gains[..., None].astype(np.float32),
    )


def _gain_block(ops):
    return TG.encode_opcode_list(ops)


def _phase_maps(h, w, seed, points=5):
    """Four per-phase GainMaps (pitch 2) with gains in [0.8, 1.3]."""
    rng = np.random.default_rng(seed)
    return [(TG.OPCODE_GAIN_MAP, TG.encode_gain_map(_gain_map(
        h, w, rng.uniform(0.8, 1.3, (points, points)), top=dy, left=dx, pitch=(2, 2))))
        for dy in (0, 1) for dx in (0, 1)]


VIGNETTE = (TG.OPCODE_FIX_VIGNETTE_RADIAL,
            TG.encode_vignette_radial(TG.VignetteRadial((0.3, -0.1, 0.05, 0.0, 0.01), 0.45, 0.55)))


def test_encoders_write_the_jax_packages_bytes():
    gains = np.random.default_rng(0).uniform(0.8, 1.3, (3, 4)).astype(np.float32)
    gm = _gain_map(16, 20, gains, top=1, left=2, pitch=(2, 2))
    jgm = JG.GainMap(*gm)
    assert TG.encode_gain_map(gm) == JG.encode_gain_map(jgm)
    rt = TG.decode_gain_map(TG.encode_gain_map(gm))
    assert rt._replace(gains=None) == gm._replace(gains=None)
    np.testing.assert_array_equal(rt.gains, gm.gains)
    v = TG.VignetteRadial((0.3, 0.0, 0.1, 0.0, 0.0), 0.5, 0.4)
    assert TG.encode_vignette_radial(v) == JG.encode_vignette_radial(JG.VignetteRadial(*v))
    assert TG.decode_vignette_radial(TG.encode_vignette_radial(v)) == v
    ops = [(TG.OPCODE_GAIN_MAP, TG.encode_gain_map(gm)), VIGNETTE]
    assert TG.encode_opcode_list(ops) == JG.encode_opcode_list(ops)
    c = TF.BadPixelsConstant(4095, 0)
    assert TF.encode_fix_bad_pixels_constant(c) == JF.encode_fix_bad_pixels_constant(
        JF.BadPixelsConstant(*c))
    lst = TF.BadPixelsList(0, np.array([[3, 5], [9, 11]], np.int32),
                           np.array([[0, 0, 2, 2]], np.int32))
    assert TF.encode_fix_bad_pixels_list(lst) == JF.encode_fix_bad_pixels_list(
        JF.BadPixelsList(*lst))
    rt = TF.decode_fix_bad_pixels_list(TF.encode_fix_bad_pixels_list(lst))
    np.testing.assert_array_equal(rt.points, lst.points)
    np.testing.assert_array_equal(rt.rects, lst.rects)
    assert TF.decode_fix_bad_pixels_constant(b"\x00" * 7) is None
    assert TG.decode_gain_map(b"\x00" * 75) is None


# (name, block on an (h, w) = (30, 44) mosaic): a map for each CFA phase, a
# map whose area starts on an odd row (phase 1) and runs past the bottom and
# right edges, an offset origin, a vignette, all of them at once, and an
# unknown opcode among them, which is skipped.
H, W = 30, 44
GAIN_CASES = {
    "phases": _gain_block(_phase_maps(H, W, seed=1)),
    "odd_row_past_the_edge": _gain_block([(TG.OPCODE_GAIN_MAP, TG.encode_gain_map(_gain_map(
        H, W, np.random.default_rng(2).uniform(0.8, 1.3, (4, 6)), top=7, left=3,
        bottom=H + 9, right=W + 5, pitch=(2, 3))))]),
    "origin": _gain_block([(TG.OPCODE_GAIN_MAP, TG.encode_gain_map(_gain_map(
        H, W, np.random.default_rng(3).uniform(0.8, 1.3, (3, 3)), origin=(0.2, -0.1))))]),
    "vignette": _gain_block([VIGNETTE]),
    "all": _gain_block(_phase_maps(H, W, seed=4) + [VIGNETTE, (77, b"\x01\x02\x03")]),
}


@pytest.mark.parametrize("case", sorted(GAIN_CASES))
def test_apply_gain_opcodes_matches_jax(case):
    bayer = np.random.default_rng(5).uniform(0.0, 1.0, (H, W)).astype(np.float32)
    block = GAIN_CASES[case]
    with jax.disable_jit():
        want = np.asarray(JG.apply_gain_opcodes(jnp.asarray(bayer), block))
    source = torch.from_numpy(bayer.copy())
    got = TG.apply_gain_opcodes(source, block)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    assert torch.equal(source, torch.from_numpy(bayer)), "the input was changed"
    assert not np.array_equal(got.numpy(), bayer)
    if case == "odd_row_past_the_edge":
        touched = np.zeros((H, W), bool)
        touched[7::2, 3::3] = True
        np.testing.assert_array_equal(got.numpy()[~touched], bayer[~touched])


def _opcode_heal_case(h, w, seed):
    """Stored counts, a normalized mosaic and an OpcodeList1 with both bad
    pixel opcodes: points (some off the frame), rects (one past the edge) and
    a constant sentinel planted at a few sites."""
    rng = np.random.default_rng(seed)
    stored = rng.integers(300, 4000, (h, w)).astype(np.uint16)
    sentinel = rng.choice(h * w, 6, replace=False)
    stored.flat[sentinel] = 17
    points = np.array([[3, 5], [9, 11], [0, 0], [h - 1, w - 1], [h + 4, 2]], np.int32)
    rects = np.array([[12, 14, 15, 18], [h - 2, w - 3, h + 3, w + 3]], np.int32)
    block = TG.encode_opcode_list([
        (TF.OPCODE_FIX_BAD_PIXELS_CONSTANT,
         TF.encode_fix_bad_pixels_constant(TF.BadPixelsConstant(17, 0))),
        (TF.OPCODE_FIX_BAD_PIXELS_LIST,
         TF.encode_fix_bad_pixels_list(TF.BadPixelsList(0, points, rects))),
    ])
    bayer = (stored.astype(np.float32) - 256) / 4095
    return stored, np.clip(bayer, 0, 1).astype(np.float32), block


def test_bad_pixel_mask_matches_jax():
    stored, _, block = _opcode_heal_case(24, 32, seed=6)
    want = JF.bad_pixel_mask_from_opcodes(stored, block)
    got = TF.bad_pixel_mask_from_opcodes(stored, block)
    np.testing.assert_array_equal(got, want)
    # 6 sentinels, 4 points in the frame, rects of 12 and 6 sites; the last
    # point lies in the second rect
    assert got.sum() == 6 + 4 + 12 + 6 - 1
    assert TF.bad_pixel_mask_from_opcodes(stored, _gain_block([VIGNETTE])) is None


def test_heal_from_opcodes_matches_jax():
    stored, bayer, block = _opcode_heal_case(24, 32, seed=7)
    with jax.disable_jit():
        want = np.asarray(JF.heal_bad_pixels_from_opcodes(bayer, stored, block))
    got = TF.heal_bad_pixels_from_opcodes(torch.from_numpy(bayer), stored, block).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    mask = TF.bad_pixel_mask_from_opcodes(stored, block)
    np.testing.assert_array_equal(got[~mask], bayer[~mask])
    assert np.all(got[mask] != bayer[mask])
    # nothing flagged: the mosaic itself comes back
    t = torch.from_numpy(bayer)
    assert TF.heal_bad_pixels_from_opcodes(t, stored, _gain_block([VIGNETTE])) is t


def _opcode_dng(h=48, w=64, seed=8, linearize=False, **geometry):
    """A DNG whose stored counts carry a sentinel, listed defects, and an
    OpcodeList2 of per-phase gain maps and a vignette."""
    stored, _, block1 = _opcode_heal_case(h, w, seed)
    stored[9, 11] = 4095   # a listed hot defect
    table = None
    if linearize:
        # identity but for the sentinel: FixBadPixelsConstant sees the stored
        # counts after the table, as in the JAX loader
        table = np.arange(4096, dtype=np.uint16)
        table[17] = 25
        table[25] = 17
    block2 = _gain_block(_phase_maps(h, w, seed=seed + 1) + [VIGNETTE])
    return JT.write_synthetic_dng(stored, opcode_list_1=block1, opcode_list_2=block2,
                                  linearization_table=table, **geometry)


@pytest.mark.parametrize("case", ["plain", "linearized", "area_crop", "bggr"])
def test_load_raw_with_both_lists_matches_jax(case):
    kw = {}
    if case == "linearized":
        kw["linearize"] = True
    elif case == "area_crop":
        kw.update(active_area=(2, 4, 45, 61), crop_origin=(2, 2), crop_size=(52, 38))
    elif case == "bggr":
        kw["cfa_pattern"] = (2, 1, 1, 0)
    blob = _opcode_dng(**kw)
    with jax.disable_jit():
        want = jax_load_raw_dng(blob)
    got = load_raw(blob, device="cpu")
    assert got.source_pattern == want.source_pattern
    np.testing.assert_allclose(got.bayer.numpy(), np.asarray(want.bayer), rtol=0, atol=1e-6)
    for k in FIELDS[1:]:
        np.testing.assert_array_equal(getattr(got, k).numpy(), np.asarray(getattr(want, k)))
    # both lists changed the mosaic
    plain = load_raw_dng(blob, apply_gain_opcodes=False, device="cpu")
    assert plain.bayer.shape == got.bayer.shape
    assert float((plain.bayer != got.bayer).float().mean()) > 0.5
    with jax.disable_jit():
        want_plain = jax_load_raw_dng(blob, apply_gain_opcodes=False)
    np.testing.assert_array_equal(plain.bayer.numpy(), np.asarray(want_plain.bayer))


def test_loader_heals_listed_pixels_and_applies_gains():
    """The JAX tests' loader gates (tests/test_warp.py) on the port: a listed
    defect heals to its same-plane neighbours, a flat gain scales the mosaic."""
    h, w = 32, 40
    counts = np.full((h, w), 2000, np.uint16)
    counts[10, 14] = 4095
    op = TF.BadPixelsList(0, np.array([[10, 14]], np.int32), np.zeros((0, 4), np.int32))
    block = TG.encode_opcode_list([(TF.OPCODE_FIX_BAD_PIXELS_LIST,
                                    TF.encode_fix_bad_pixels_list(op))])
    base = (2000 - 256) / 4095
    frame = load_raw(TT.write_synthetic_dng(counts, opcode_list_1=block), device="cpu")
    np.testing.assert_allclose(frame.bayer.numpy(), base, rtol=1e-5)

    counts = np.full((h, w), 2304, np.uint16)
    gm = _gain_map(h, w, np.full((2, 2), 1.25, np.float32))
    block = TG.encode_opcode_list([(TG.OPCODE_GAIN_MAP, TG.encode_gain_map(gm))])
    blob = TT.write_synthetic_dng(counts, opcode_list_2=block)
    base = (2304 - 256) / 4095
    np.testing.assert_allclose(load_raw(blob, device="cpu").bayer.numpy(), base * 1.25,
                               rtol=1e-5)
    np.testing.assert_allclose(
        load_raw_dng(blob, apply_gain_opcodes=False, device="cpu").bayer.numpy(), base,
        rtol=1e-6)
