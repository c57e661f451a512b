#!/usr/bin/env python3
"""Times and checks the AHD, RL, postprocess, remap, heal, AHD decision, 5x5
median, homogeneity, multisection and EAG resample kernels of pysp_tpu_torch on one NVIDIA GPU, for one or
more builds of the kernel sources inside one process, so that two versions are
compared on the same card within one call.

    python3 tools/time_kernels.py [--variant NAME[:FLAG,FLAG...][@CSRC_DIR]]...
                                  [--kernels ahd,rl,postprocess,remap,heal,decision,
                                             median5,homogeneity,multisection,ca_radial,
                                             eag_resample]
                                  [--no-check]

Each variant is a build of the CUDA sources: NAME labels its lines, the FLAGs
are added to nvcc's (``-DAHD_TILE_W=64``), and CSRC_DIR is a directory that
holds another version of the sources (default: the package's own ``csrc``).
Without ``--variant`` the package's own build is the only one. The variants
are visited in the order given and then once more in reverse (a, b, b, a).

``--kernels`` keeps the named groups only (default: all eleven).

For every variant it prints the ptxas lines of the chosen kernels and holds
them against their plain versions: the AHD kernel over the whole frame at
512x768 and 510x762 (0 to 2 stages: the share of pixels that differ, and
whether every pixel outside the 4 S px dilation of the stage-0 differing set is
bit-equal); the RL kernel against ``rl_plain`` (``torch.equal``); the
postprocess kernel against ``postprocess_color_channels`` at 512x768, 510x762,
37x50 and 3x5 (``torch.equal``); the remap kernel at 4000x6000 on the lens
warp's maps and bounds (bilinear ``torch.equal`` to ``remap_plain``; Lanczos4
by its max abs error against ``remap_plain`` and against the same remap in
float64, beside the plain version's own error against float64) and on a random
map, and its bilinear kind (``torch.equal`` to ``remap_plain``) on random maps
at 4000x6000 and on config 5's CA stack (the upsampled greens of 16
``make_scene`` frames of 1000x1504 with the Poly3(0.01) model's shared maps,
as ``chip_smoke.py``'s ``ca_at_main_shapes`` builds them) and its first four
planes (the shard stack of the parallel path's (4, 1) mesh); the heal kernel against ``heal_plain`` on ``heal_case`` planes at
256x384, 253x381, 3x5 and 1x1 (``torch.equal``); the decision kernel's picks
against ``ahd_decision_plain`` at 512x768 and 510x762, HDR and not (the share
that differ); the median5 kernel against ``ops.stencil.median5`` and the
homogeneity kernel (both directions) against ``homogeneity_map_channels`` at
``STAGED_SHAPES``, from 512x768 down to 1x1, with rows on and off the 16-byte
alignment (``torch.equal``); the multisection kernel's quantile and masks
against the plain passes' (``torch.equal``) on the detector's delta planes of
a 24 MP frame with hot photosites and on ``multisection_case`` planes. For the
decision group it also prints the
innermost loops of the kernel's SASS with their instruction counts
(``tools/sass_count.py``).
Then it prints one JSON line with the times at 4000x6000 (CUDA events, median
of 10 after 2 warm-ups) and a SHA-256 of each output, so that two variants can
be compared bit for bit: the AHD kernel with 0, 1 and 2 stages and the fused
tail, the Best develop, and the host's time of one AHD wrapper call and of its
bare ctypes launch on an 8x8 frame (what the card waits for between two
launches); one RL iteration at sigma 1 and sigma 2 and 20
iterations at sigma 1; one postprocess stage on the r, g, b planes of the
frame's demosaic; the remap of the developed (H, W, 3) image by Lanczos4, also
with a map for each channel and on the random map; the bilinear remap of that
image, of it on the random map, of the CA stack and of the shard stack, each
also timed back to back (``chip_smoke.queued_ms``: calls queued behind a spin
kernel, so that the host's work before a launch is left out) and beside
``F.grid_sample`` (bilinear, border, align_corners) on the same inputs, both
ways, with its bound by bytes; the host's time of one bilinear wrapper call,
of the bare ctypes launch and of ``grid_sample`` on an 8x8 stack;
the heal of 4 x 2000 x 3000 planes (4 + 2 sweeps) with the hot-pixel
detector's masks of a frame with 500 planted hot photosites and with a random
mask at density 1e-2, each as the whole ``heal_kernel`` call, its
``torch.mean`` alone and the kernel's launch alone, the launch with no site
at all (the copy alone) and, as a yardstick for that copy, ``torch``'s own
copy of the planes; the pick of a frame's six candidate fields, HDR and not;
the 5x5 median of the R - G plane of the frame's demosaic; the homogeneity
count of the CIELAB planes of its horizontal candidate, both directions, and,
as a yardstick for its bytes, ``torch``'s own copy of those three planes;
the hot-pixel detector on the 24 MP frame, its four multisection passes (the
whole wrapper call), one counting pass alone (20 launches back to back, per
launch), one plain pass (the (4, 16, H/2, W/2) compare, its sum and the
narrowing: ``multisection_plain`` of one pass) and, as a
yardstick for the pass's 96 MB, ``torch``'s ``amax`` of the same planes.
The ``ca_radial`` group checks the remap kernel's radial kind (CA removal's
coordinates computed in the kernel) against the plain maps plus the bilinear
kind (``torch.equal``), forward and inverse, at one 8736x11648 plane with the
mf102 configuration's Poly3 model and at config 5's CA stack, and times both
ways there, as lone calls and back to back, beside the bilinear kind alone on
the plain maps and ``grid_sample`` on them, with the radial kind's bound
(8 B a pixel and plane; the plain version's float32 operations) and the SASS
instructions of a thread, which serves up to four mirrored pixels.
The ``eag_resample`` group checks the EAG fill kernel (on the green phases of
a mosaic, read in place) and the upsample kernel for R and B against their
plain versions (``torch.equal``) at mf102's 8736x11648 frame and at config 5's
stack of 16 x 1000x1504 mosaics, and times each there, as lone calls and back
to back, beside its plain version and its bound by bytes: the fill reads the
mosaic's rows and writes the green (8 B a pixel), an upsample reads the green
and the quarter plane and writes the channel (9 B a pixel).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pysp_tpu_torch import (  # noqa: E402
    DevelopConfig,
    Poly3CorrectionModel,
    RawFrame,
    develop,
    stack_frames,
)
from pysp_tpu_torch.colorimetry.transforms import cam_to_lin_srgb_matrix  # noqa: E402
from pysp_tpu_torch.core.bayer import bayer_to_planes, bayer_to_rgbg  # noqa: E402
from pysp_tpu_torch.correct.ca.removal import _maps_from_offsets  # noqa: E402
from pysp_tpu_torch.correct.bad_pixels import (  # noqa: E402
    find_erroneous_pixels_median,
    multisection_plain,
)
from pysp_tpu_torch.demosaic.ahd import (  # noqa: E402
    ahd_candidates,
    ahd_decision_plain,
    postprocess_color_channels,
)
from pysp_tpu_torch.demosaic.eag import (  # noqa: E402
    resample_channel_plain,
    resample_g_to_full_resolution,
    resample_g_to_full_resolution_plain,
)
from pysp_tpu_torch.demosaic.homogeneity import homogeneity_map_channels  # noqa: E402
from pysp_tpu_torch.filters.blur import get_1d_gaussian_filter  # noqa: E402
from pysp_tpu_torch.ops import cuda_kernels as K  # noqa: E402
from pysp_tpu_torch.ops.stencil import median2, median5  # noqa: E402
from pysp_tpu_torch.utils.testing import (  # noqa: E402
    chroma_case,
    heal_case,
    make_scene,
    mosaic_rggb,
    multisection_case,
    psnr,
)
from pysp_tpu_torch.warp.rectilinear import (  # noqa: E402
    compute_remapping_table,
    displacement_bounds,
)

CAM = np.array([[0.9, -0.2, -0.1], [-0.3, 1.1, 0.2], [0.0, -0.4, 1.3]], np.float32)
WB = np.array([0.45, 1.0, 0.62], np.float32)
FULL = (4000, 6000)
GROUPS = ("ahd", "rl", "postprocess", "remap", "heal", "decision", "median5", "homogeneity",
          "multisection", "ca_radial", "eag_resample")
# The lens warp of the finishing path: about 11 px at the corners of 4000x6000.
WARP_COEFFS = (1.0, -0.003, 0.0, 0.0, 0.0, 0.0)
WARP_CENTER = (0.5, 0.5)
# Lanczos4 against remap_plain, and how much further from the float64 remap
# than remap_plain the kernel may be.
LANCZOS4_ATOL = 5e-6
LANCZOS4_F64_SLACK = 1e-6
# Config 5's CA burst (bench.py): the bilinear remap of its upsampled greens
# with the Poly3 model's shared maps, as chip_smoke.py's ca path runs it, and
# the four of them that a shard of the parallel path's (4, 1) mesh holds.
CA_SHAPE = (16, 1000, 1504)
CA_K1 = 0.01
SHARD_PLANES = 4
# The radial kind of the remap kernel at the mf102 configuration's frame and
# R model, one plane as its CA removal remaps it.
MF102_SHAPE = (1, 8736, 11648)
MF102_K1 = 0.000714
HEAL_SWEEPS = (4, 2)
HEAL_DENSE = 1e-2
MAX_PICK_FLIPS = 5e-4   # picks that cbrtf may flip at exact ties (0.05%)
# The median5 and homogeneity kernels' checks: whole tiles and tiles that
# overhang, planes with interior blocks on the 16-byte path (100x260), rows
# off the 16-byte alignment (509x763, 97x203, 130x190), and planes thinner
# than the windows.
STAGED_SHAPES = ((512, 768), (509, 763), (100, 260), (97, 203), (130, 190), (3, 5),
                 (1, 7), (7, 1), (1, 1))
BASE_FLAGS = K.NVCC_FLAGS
BASE_CSRC = K.CSRC


def median_ms(fn, runs: int = 10, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_us(fn, calls: int = 2000) -> float:
    """Host time of one call of ``fn`` in microseconds, over ``calls`` calls in
    a row on inputs so small that the card keeps up: what the card waits for
    between two such launches."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    return host / calls * 1e6


def digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()[:16]


def frame(h, w, seed, is_hdr=False, noise=0.0) -> RawFrame:
    mosaic = mosaic_rggb(make_scene(h, w, seed=seed))
    if noise:
        rng = np.random.default_rng(seed)
        mosaic = np.clip(mosaic + rng.normal(0, noise, mosaic.shape), 0.02, 0.98)
    return RawFrame.synthetic(mosaic.astype(np.float32), cam_mat=CAM, wb_neutral=WB,
                              is_hdr=is_hdr, device="cuda")


def build_variants(variants) -> dict:
    """Every variant's library, built all at once: {name: (path, nvcc's output,
    seconds)}."""
    from concurrent.futures import ThreadPoolExecutor

    def one(variant):
        name, flags, csrc = variant
        return name, K.build_library(Path(csrc) if csrc else BASE_CSRC,
                                     BASE_FLAGS + tuple(flags))

    with ThreadPoolExecutor(len(variants)) as pool:
        return dict(pool.map(one, variants))


def load_variant(flags, csrc) -> None:
    K.NVCC_FLAGS = BASE_FLAGS + tuple(flags)
    K.CSRC = Path(csrc) if csrc else BASE_CSRC
    K._lib = None
    K.load_library()


def check_ahd(name: str) -> bool:
    ok = True
    for h, w in ((512, 768), (510, 762)):
        for is_hdr in (False, True):
            f = frame(h, w, seed=h + int(is_hdr), is_hdr=is_hdr, noise=0.03)
            mat = cam_to_lin_srgb_matrix(f.cam_mat, f.cam_white)
            wb = f.wb_reciprocal()
            flipped = None
            for stages in (0, 1, 2):
                got = K.ahd_kernel(f.bayer, mat, wb, is_hdr, stages)
                want = K.ahd_plain(f.bayer, mat, wb, is_hdr, stages)
                differs = (got != want).any(dim=0)
                if stages == 0:
                    flipped = differs
                k = 8 * stages + 1
                near = torch.nn.functional.max_pool2d(
                    flipped[None, None].float(), k, 1, k // 2)[0, 0] > 0
                stray = int((differs & ~near).sum())
                p = psnr(got.cpu().numpy(), want.cpu().numpy())
                print(f"{name}: AHD {h}x{w} hdr={is_hdr} stages={stages}: "
                      f"{float(differs.float().mean()):.6%} of pixels differ, {stray} of them "
                      f"outside the {4 * stages} px dilation of the stage-0 set, PSNR {p:.2f} dB",
                      flush=True)
                ok &= stray == 0 and float(flipped.float().mean()) <= 1e-4
    return ok


def check_rl(name: str) -> bool:
    ok = True
    for shape in ((512, 768), (509, 763), (509, 763, 3)):
        img = make_scene(shape[0], shape[1], seed=3) * 0.9 + 0.05
        img = img if len(shape) == 3 else img[..., 1]
        img = torch.from_numpy(np.ascontiguousarray(img, np.float32)).cuda()
        for sigma in (0.5, 0.7, 1.0, 1.4, 1.6, 2.0, 2.5, 10.5):
            taps = get_1d_gaussian_filter(sigma)
            same = torch.equal(K.rl_kernel(img, taps, 3), K.rl_plain(img, taps, 3))
            print(f"{name}: RL {shape} sigma {sigma} ({len(taps)} taps), 3 iterations: "
                  f"bit-exact {same}", flush=True)
            ok &= same
    return ok


def check_postprocess(name: str) -> bool:
    ok = True
    for h, w in ((512, 768), (510, 762), (37, 50), (3, 5)):
        planes = torch.from_numpy(chroma_case(h, w, seed=h)).cuda()
        got = K.postprocess_color_kernel(*planes)
        want = postprocess_color_channels(*planes)
        same = all(torch.equal(g, w_) for g, w_ in zip(got, want))
        print(f"{name}: postprocess {h}x{w}: bit-exact {same}", flush=True)
        ok &= same
    return ok


def warp_case(h: int, w: int):
    """The finishing path's lens warp: shared maps, clipped into the frame, and
    their displacement bounds."""
    mx, my = compute_remapping_table(WARP_COEFFS, w, h, WARP_CENTER, device="cuda")
    return (mx.clamp(0, w - 1).contiguous(), my.clamp(0, h - 1).contiguous(),
            displacement_bounds(WARP_COEFFS, w, h, WARP_CENTER))


def random_maps(h: int, w: int, seed: int):
    """Maps that send every pixel anywhere in the frame."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    mx = torch.rand((h, w), generator=g, device="cuda") * (w - 1)
    my = torch.rand((h, w), generator=g, device="cuda") * (h - 1)
    return mx, my


def ca_stack_state() -> dict:
    """Config 5's CA remap input: the upsampled greens of 16 1000x1504
    ``make_scene`` frames (N, H, W) and the Poly3(0.01) model's shared maps, as
    chip_smoke.py's ``ca_at_main_shapes`` builds them; the first four planes
    are the parallel path's shard stack."""
    n, h, w = CA_SHAPE
    burst = stack_frames([RawFrame.synthetic(
        mosaic_rggb(make_scene(h, w, seed=k)).astype(np.float32), device="cuda")
        for k in range(n)], device="cuda")
    _, g1, _, g2 = bayer_to_rgbg(burst.bayer)
    g = resample_g_to_full_resolution(g1, g2).contiguous()
    mx, my = _maps_from_offsets(Poly3CorrectionModel(CA_K1).get_undistorted_coordinates(g[0]),
                                h, w)
    return {"ca16": (g, mx, my), "shard4": (g[:SHARD_PLANES].contiguous(), mx, my)}


def bilinear_cases(state: dict):
    """(key, image, map_x, map_y, bounds, channels_last) of every bilinear
    case: the lens warp of the (H, W, 3) image, random maps on it, config 5's
    CA stack and the shard stack."""
    srgb = state["srgb"]
    h, w = srgb.shape[:2]
    mx, my, bounds = warp_case(h, w)
    yield "remap_bilinear", srgb, mx, my, bounds, True
    yield "remap_bilinear_random", srgb, *random_maps(h, w, seed=2), None, True
    for key, (g, cx, cy) in state["ca"].items():
        yield f"remap_bilinear_{key}", g, cx, cy, None, False


def grid_sample_call(img, mx, my, channels_last: bool):
    """``F.grid_sample`` (bilinear, border, align_corners) on the same image
    and maps: the one PyTorch call that computes the bilinear remap (it differs
    from the gather by rounding; timed as a yardstick only)."""
    planes = (img.permute(2, 0, 1) if channels_last else img)[None].contiguous()
    h, w = planes.shape[-2:]
    grid = torch.stack([mx / (w - 1) * 2 - 1, my / (h - 1) * 2 - 1], dim=-1)[None]
    return lambda: torch.nn.functional.grid_sample(planes, grid, mode="bilinear",
                                                   padding_mode="border",
                                                   align_corners=True)


def check_remap(name: str, state: dict) -> bool:
    ok = True
    for key, img, mx, my, bounds, last in bilinear_cases(state):
        got = K.remap_kernel(img, mx, my, "bilinear", bounds, channels_last=last)
        same = torch.equal(got, K.remap_plain(img, mx, my, "bilinear", bounds,
                                              channels_last=last))
        print(f"{name}: {key} {tuple(img.shape)}: bit-exact {same}", flush=True)
        ok &= same
        del got
    srgb = state["srgb"]
    h, w = srgb.shape[:2]
    mx, my, bounds = warp_case(h, w)
    cases = [("lens warp", srgb, mx, my, bounds)]
    small = srgb[:1000, :1500].contiguous()
    cases.append(("random map", small, *random_maps(1000, 1500, seed=1), None))
    for label, img, cx, cy, bnd in cases:
        got = K.remap_kernel(img, cx, cy, "lanczos4", bnd, channels_last=True)
        want = K.remap_plain(img, cx, cy, "lanczos4", bnd, channels_last=True)
        exact = K.remap_plain(img.double(), cx.double(), cy.double(), "lanczos4", bnd,
                              channels_last=True)
        err = (got - want).abs().max().item()
        err64 = (got.double() - exact).abs().max().item()
        plain64 = (want.double() - exact).abs().max().item()
        good = err <= LANCZOS4_ATOL and err64 <= plain64 + LANCZOS4_F64_SLACK
        print(f"{name}: remap Lanczos4 {tuple(img.shape)} {label}: max abs err {err:.3g} "
              f"against remap_plain, {err64:.3g} against float64 (remap_plain itself "
              f"{plain64:.3g}): {'ok' if good else 'OUTSIDE'}", flush=True)
        ok &= good
        del got, want, exact
    return ok


def ca_radial_state(ca: dict) -> dict:
    """The radial kind's inputs, (stack, model): one 8736x11648 plane with the
    mf102 configuration's R model, and config 5's CA stack with its Poly3
    model."""
    g = torch.Generator(device="cuda").manual_seed(11)
    plane = torch.rand(MF102_SHAPE, generator=g, device="cuda")
    return {"mf102": (plane, Poly3CorrectionModel(MF102_K1)),
            "ca16": (ca["ca16"][0], Poly3CorrectionModel(CA_K1))}


def plain_maps(stack, model, inverse: bool):
    """The clipped maps that CA removal builds with plain PyTorch."""
    coordinates = (model.get_undistorted_coordinates if inverse
                   else model.get_distorted_coordinates)
    return _maps_from_offsets(coordinates(stack[0]), *stack.shape[-2:])


def check_ca_radial(name: str, state: dict) -> bool:
    ok = True
    for key, (stack, model) in state.items():
        for inverse in (False, True):
            want = K.remap_kernel(stack, *plain_maps(stack, model, inverse), "bilinear")
            same = torch.equal(K.remap_radial_kernel(stack, model.kernel_form(), inverse), want)
            print(f"{name}: ca_radial {key} {tuple(stack.shape)} "
                  f"{'inverse' if inverse else 'forward'}: bit-exact to the maps path {same}",
                  flush=True)
            ok &= same
            del want
    return ok


def eag_state() -> dict:
    """The EAG resamples' inputs at mf102's frame and at config 5's stack:
    {key: (mosaic (N, H, W), its green phases as views, quarter planes for R
    and B, the filled green)}, from random mosaics."""
    out = {}
    for key, (n, h, w) in (("mf102", MF102_SHAPE), ("ca16", CA_SHAPE)):
        g = torch.Generator(device="cuda").manual_seed(h + n)
        mosaic = torch.rand((n, h, w), generator=g, device="cuda")
        r, g1, b, g2 = bayer_to_rgbg(mosaic)
        subs = {K.EAG_POSITIONS[0]: r.contiguous(), K.EAG_POSITIONS[1]: b.contiguous()}
        out[key] = (mosaic, (g1, g2), subs, K.eag_fill_kernel(g1, g2))
    return out


def check_eag(name: str, state: dict) -> bool:
    ok = True
    for key, (mosaic, phases, subs, green) in state.items():
        same = torch.equal(K.eag_fill_kernel(*phases), resample_g_to_full_resolution_plain(*phases))
        print(f"{name}: eag_fill {key} {tuple(mosaic.shape)}: bit-exact {same}", flush=True)
        ok &= same
        for position, sub in subs.items():
            same = torch.equal(K.eag_upsample_kernel(sub, green, position),
                               resample_channel_plain(sub, green, position))
            print(f"{name}: eag_upsample {key} {position.name}: bit-exact {same}", flush=True)
            ok &= same
    return ok


def radial_sass_instructions(form: int, inverse: bool):
    """SASS instructions of the radial kind's 32-bit instantiation from its
    entry to its last EXIT: a thread's straight line, one scale and the up to
    four pixels it serves (the IEEE division's slow path, placed after the
    EXIT, left out); None where the library holds no one function of that
    (mangled) name."""
    from tools.sass_count import _LINE, _cuobjdump

    text = subprocess.run([_cuobjdump(), "-sass", str(K._library_path())], check=True,
                          capture_output=True, text=True).stdout
    tag = f"RadialCoordsILi{form}ELb{int(inverse)}E"
    bodies = [b for b in text.split("Function : ")[1:]
              if "bilinear_kernelIi" in b.split("\n", 1)[0] and tag in b.split("\n", 1)[0]]
    if len(bodies) != 1:
        return None
    ops = [m.group(3) for m in _LINE.finditer(bodies[0]) if m.group(3) != "NOP"]
    last_exit = max(k for k, op in enumerate(ops) if op.startswith("EXIT"))
    return last_exit + 1


def check_heal(name: str) -> bool:
    ok = True
    for shape in ((256, 384), (253, 381), (3, 5), (1, 1)):
        for density in (1e-4, 3e-3, 0.6):
            planes, mask = (torch.from_numpy(a).cuda()
                            for a in heal_case(*shape, density, seed=shape[1]))
            for sweeps in ((4, 2), (6, 2)):
                same = torch.equal(K.heal_kernel(planes, mask, *sweeps),
                                   K.heal_plain(planes, mask, *sweeps))
                print(f"{name}: heal 4x{shape[0]}x{shape[1]} density {density:g}, "
                      f"{sweeps[0]} + {sweeps[1]} sweeps: bit-exact {same}", flush=True)
                ok &= same
    return ok


def check_decision(name: str) -> bool:
    ok = True
    for h, w in ((512, 768), (510, 762)):
        for is_hdr in (False, True):
            f = frame(h, w, seed=40 + int(is_hdr), is_hdr=is_hdr)
            mat = cam_to_lin_srgb_matrix(f.cam_mat, f.cam_white)
            wb = f.wb_reciprocal()
            fields = [x.contiguous() for x in ahd_candidates(f.bayer, wb)]
            got = K.decision_kernel(*fields, mat, wb, is_hdr)
            flips = float((got != ahd_decision_plain(*fields, mat, wb, is_hdr)).float().mean())
            print(f"{name}: decision {h}x{w} hdr={is_hdr}: {flips:.6%} of picks differ",
                  flush=True)
            ok &= flips <= MAX_PICK_FLIPS
    return ok


def lab_case(h: int, w: int, seed: int):
    """CIELAB planes of a noisy scene on the card, every corner of L and a an
    outlier, as the homogeneity kernel's cases."""
    from pysp_tpu_torch.colorimetry.transforms import rgb_to_lab_channels

    rgb = torch.from_numpy(chroma_case(h, w, seed)).cuda().clamp(0, 1)
    lum, a, b = (p.contiguous() for p in rgb_to_lab_channels(*rgb))
    for (y, x), vl, va in zip(((0, 0), (0, w - 1), (h - 1, 0), (h - 1, w - 1)),
                              (90.0, 5.0, 60.0, 20.0), (40.0, -40.0, 25.0, -25.0)):
        lum[y, x], a[y, x] = vl, va
    return lum, a, b


def check_median5(name: str) -> bool:
    ok = True
    for h, w in STAGED_SHAPES:
        x = torch.from_numpy(chroma_case(h, w, seed=h + w)[0]).cuda()
        same = torch.equal(K.median5_kernel(x), median5(x))
        print(f"{name}: median5 {h}x{w}: bit-exact {same}", flush=True)
        ok &= same
    return ok


def check_homogeneity(name: str) -> bool:
    ok = True
    for h, w in STAGED_SHAPES:
        lab = lab_case(h, w, seed=h)
        for vertical in (False, True):
            same = torch.equal(K.homogeneity_kernel(*lab, vertical),
                               homogeneity_map_channels(*lab, vertical))
            print(f"{name}: homogeneity {h}x{w} vertical={vertical}: bit-exact {same}",
                  flush=True)
            ok &= same
    return ok


def print_decision_sass(name: str) -> None:
    """The innermost loops of the decision kernel's SASS, their counts, and the
    instructions a pick (``chip_smoke.decision_pick_instructions``)."""
    from chip_smoke import INSTRUCTIONS_PER_S, decision_pick_instructions
    from tools.sass_count import kernel_loops

    loops = kernel_loops(K._library_path(), "decision_kernel")
    print(f"{name}: decision_kernel SASS, innermost loops (start-end: instructions, "
          f"shortest / longest path): " + ", ".join(
              f"{lp['start']:#x}-{lp['end']:#x}: {lp['count']} ({lp['shortest']} / "
              f"{lp['longest']})" for lp in loops), flush=True)
    per_pick, parts = decision_pick_instructions(K._library_path())
    print(f"{name}: decision issue floor {per_pick:.1f} instructions a pick ({parts}), "
          f"{per_pick * FULL[0] * FULL[1] / INSTRUCTIONS_PER_S * 1e3:.4f} ms at {FULL[0]}x{FULL[1]}",
          flush=True)


def heal_state() -> dict:
    """The 24 MP heal inputs: the CFA planes of a frame with 500 hot
    photosites planted where the scene is dark (``chip_smoke.plant_hot_sites``)
    and the median detector's masks of it; a random mask at HEAL_DENSE."""
    from chip_smoke import plant_hot_sites

    mosaic = mosaic_rggb(make_scene(*FULL, seed=13))
    hot = plant_hot_sites(mosaic)
    mosaic[hot[:, 0], hot[:, 1]] = 1.0
    f = RawFrame.synthetic(mosaic.astype(np.float32), device="cuda")
    planes = bayer_to_planes(f.bayer).contiguous()
    g = torch.Generator(device="cuda").manual_seed(5)
    dense = torch.rand(planes.shape, generator=g, device="cuda") < HEAL_DENSE
    return {"planes": planes, "masks": find_erroneous_pixels_median(f), "dense": dense}


def decision_state() -> dict:
    """The six candidate fields of the 24 MP frame, non-HDR and HDR, with
    their colour parameters."""
    out = {}
    for is_hdr in (False, True):
        f = frame(*FULL, seed=7, is_hdr=is_hdr)
        mat = cam_to_lin_srgb_matrix(f.cam_mat, f.cam_white)
        wb = f.wb_reciprocal()
        out[is_hdr] = ([x.contiguous() for x in ahd_candidates(f.bayer, wb)], mat, wb)
    return out


def staged_state() -> dict:
    """The median5 kernel's 24 MP input, the R - G plane of the frame's
    demosaic, and the homogeneity kernel's, the CIELAB planes of the frame's
    horizontal candidate (``chip_smoke.homogeneity_planes``)."""
    from chip_smoke import homogeneity_planes

    f = frame(*FULL, seed=7)
    mat = cam_to_lin_srgb_matrix(f.cam_mat, f.cam_white)
    wb = f.wb_reciprocal()
    r, g, _ = K.ahd_plain(f.bayer, mat, wb, f.is_hdr, 0)
    fields = ahd_candidates(f.bayer, wb)
    return {"chroma": (r - g).contiguous(), "lab": homogeneity_planes(fields[:3], mat, wb)}


def detector_state() -> dict:
    """The hot-pixel detector's 24 MP frame (500 hot photosites planted where
    the scene is dark, as ``heal_state``'s) and its delta planes, first
    bracket and target rank at the detector's quantile (0.9999)."""
    from chip_smoke import plant_hot_sites

    mosaic = mosaic_rggb(make_scene(*FULL, seed=13))
    hot = plant_hot_sites(mosaic)
    mosaic[hot[:, 0], hot[:, 1]] = 1.0
    f = RawFrame.synthetic(mosaic.astype(np.float32), device="cuda")
    planes = bayer_to_planes(f.bayer)
    delta = torch.abs(planes - median2(planes))
    delta = torch.abs(delta - delta.mean(dim=(-2, -1), keepdim=True))
    n = delta.shape[-2] * delta.shape[-1]
    return {"frame": f, "delta": delta, "lo": delta.amin(dim=(-2, -1)),
            "hi": delta.amax(dim=(-2, -1)), "target": float(np.float32(0.9999 * (n - 1)))}


def check_multisection(name: str, state: dict) -> bool:
    """The detector's masks and quantile with the kernel against the plain
    passes on the same planes."""
    ok = True
    f, delta = state["frame"], state["delta"]
    cases = [("24 MP detector delta", delta)] + [
        (f"{kind} 4x{h}x{w}", torch.from_numpy(multisection_case(h, w, kind, seed=h)).cuda())
        for kind, (h, w) in (("at_mids", (2000, 3000)), ("constant", (64, 96)),
                             ("levels", (300, 500)), ("noise", (3, 5)), ("noise", (1, 1)))]
    for label, d in cases:
        lo, hi = d.amin(dim=(-2, -1)), d.amax(dim=(-2, -1))
        target = float(np.float32(0.9999 * (d.shape[-2] * d.shape[-1] - 1)))
        same = all(torch.equal(a, b) for a, b in zip(
            K.multisection_kernel(d, lo, hi, target), multisection_plain(d, lo, hi, target)))
        print(f"{name}: multisection {label}: bit-exact {same}", flush=True)
        ok &= same
    real = K.multisection_kernel_admits
    K.multisection_kernel_admits = lambda *a: False
    try:
        plain_masks = find_erroneous_pixels_median(f)
    finally:
        K.multisection_kernel_admits = real
    same = torch.equal(find_erroneous_pixels_median(f), plain_masks)
    print(f"{name}: detector masks at 24 MP ({int(plain_masks.sum())} sites): bit-exact {same}",
          flush=True)
    return ok and same


def multisection_launch(delta, bracket, counts, target) -> None:
    """One counting pass of the multisection kernel alone (no narrowing)."""
    p, h, w = delta.shape
    err = K.load_library().pysp_multisection(
        delta.data_ptr(), p, h * w, delta.stride(0), bracket.data_ptr(), counts.data_ptr(),
        counts[p * 16:].data_ptr(), 16, target, 0, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"multisection launch failed: cudaError {err}")


def heal_launch(planes, masks, means, out, fill, smooth) -> None:
    """The heal kernel's launch alone, on means computed beforehand."""
    _, h, w = planes.shape
    err = K.load_library().pysp_heal(
        planes.data_ptr(), masks.data_ptr(), means.data_ptr(), out.data_ptr(), h, w,
        fill, smooth, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"heal launch failed: cudaError {err}")


def times(name: str, state: dict, groups) -> dict:
    out = {"variant": name}
    if "ahd" in groups:
        f = state["frame"]
        mat = cam_to_lin_srgb_matrix(f.cam_mat, f.cam_white)
        wb = f.wb_reciprocal()
        tail = (True, True)
        for stages in (0, 1, 2):
            run = lambda: K.ahd_kernel(f.bayer, mat, wb, f.is_hdr, stages, tail)  # noqa: E731
            out[f"ahd_s{stages}_ms"] = median_ms(run)
            out[f"ahd_s{stages}_sha"] = digest(run())
        cfg = DevelopConfig()
        out["develop_ms"] = [median_ms(lambda: develop(f, cfg), runs=5, warmup=1)
                             for _ in range(3)]
        # the host's time of an AHD wrapper call (tail fused) on an 8x8 frame,
        # and of its bare launch through ctypes
        tiny = frame(8, 8, seed=3)
        tmat, twb = cam_to_lin_srgb_matrix(tiny.cam_mat, tiny.cam_white), tiny.wb_reciprocal()
        out["ahd_wrapper_host_us"] = host_us(
            lambda: K.ahd_kernel(tiny.bayer, tmat, twb, False, 1, tail))
        params, buf = K._ahd_params(tmat, twb), torch.empty((8, 8, 3), device="cuda")
        lib, stream = K.load_library(), torch.cuda.current_stream().cuda_stream
        flags = K._F_TAIL | K._F_INTERLEAVED | K._F_CLIP | K._F_GAMMA
        out["ahd_launch_host_us"] = host_us(lambda: lib.pysp_ahd(
            tiny.bayer.data_ptr(), params.data_ptr(), buf.data_ptr(), 8, 8, 1, 0, flags, stream))
    if "rl" in groups:
        luma = state["luma"]
        for sigma in (1.0, 2.0):
            taps = get_1d_gaussian_filter(sigma)
            out[f"rl_sigma{sigma:g}_iter_ms"] = median_ms(lambda: K.rl_kernel(luma, taps, 1))
            out[f"rl_sigma{sigma:g}_sha"] = digest(K.rl_kernel(luma, taps, 2))
        taps = get_1d_gaussian_filter(1.0)
        out["rl_sigma1_20_ms"] = median_ms(lambda: K.rl_kernel(luma, taps, 20))
    if "postprocess" in groups:
        planes = state["planes"]
        out["postprocess_ms"] = median_ms(lambda: K.postprocess_color_kernel(*planes))
        out["postprocess_sha"] = digest(torch.stack(K.postprocess_color_kernel(*planes)))
    if "remap" in groups:
        srgb = state["srgb"]
        h, w = srgb.shape[:2]
        mx, my, bounds = warp_case(h, w)

        def remap(kind, cx=mx, cy=my, bnd=bounds):
            return K.remap_kernel(srgb, cx, cy, kind, bnd, channels_last=True)

        out["remap_lanczos4_ms"] = median_ms(lambda: remap("lanczos4"))
        out["remap_lanczos4_sha"] = digest(remap("lanczos4"))
        # a map for each channel: the lens warp's, a little apart
        cx = torch.stack([mx - 0.6, mx, mx + 0.7]).clamp(0, w - 1)
        cy = torch.stack([my + 0.4, my, my - 0.3]).clamp(0, h - 1)
        wide = ((bounds[0][0] - 1, bounds[0][1] + 1), (bounds[1][0] - 1, bounds[1][1] + 1))
        out["remap_lanczos4_per_channel_ms"] = median_ms(lambda: remap("lanczos4", cx, cy, wide))
        out["remap_lanczos4_per_channel_sha"] = digest(remap("lanczos4", cx, cy, wide))
        rx, ry = random_maps(h, w, seed=2)
        out["remap_lanczos4_random_ms"] = median_ms(lambda: remap("lanczos4", rx, ry, None))
        out["remap_lanczos4_random_sha"] = digest(remap("lanczos4", rx, ry, None))
        del cx, cy, rx, ry
        # the bilinear kind beside grid_sample on the same inputs, a lone call
        # (median_ms) and calls back to back (queued_ms), and its bound as
        # chip_smoke.py's records take it: image in and out once, two maps
        # (shared) once, and the plain version's float32 operations
        from chip_smoke import bound, float_ops, queued_ms

        for key, img, bx, by, bnd, last in bilinear_cases(state):
            def run(img=img, bx=bx, by=by, bnd=bnd, last=last):
                return K.remap_kernel(img, bx, by, "bilinear", bnd, channels_last=last)
            library = grid_sample_call(img, bx, by, last)
            out[f"{key}_ms"] = median_ms(run)
            out[f"{key}_queued_ms"] = queued_ms(run)
            out[f"{key}_sha"] = digest(run())
            out[f"{key}_grid_sample_ms"] = median_ms(library)
            out[f"{key}_grid_sample_queued_ms"] = queued_ms(library)
            out[f"{key}_bound_ms"] = bound(
                (2 * img.numel() + 2 * bx.numel()) * 4,
                float_ops(lambda: K.remap_plain(img, bx, by, "bilinear", bnd,
                                                channels_last=last)))[0]
        # the host's time of a call on an 8x8 stack: the wrapper, the bare
        # launch through ctypes, and grid_sample
        tiny, tx, ty = (a[..., :8, :8].contiguous() for a in state["ca"]["shard4"])
        out["remap_bilinear_wrapper_host_us"] = host_us(
            lambda: K.remap_kernel(tiny, tx, ty, "bilinear"))
        buf, lib = torch.empty_like(tiny), K.load_library()
        stream = torch.cuda.current_stream().cuda_stream
        out["remap_bilinear_launch_host_us"] = host_us(lambda: lib.pysp_remap(
            tiny.data_ptr(), tx.data_ptr(), ty.data_ptr(), buf.data_ptr(), 8, 8, 4, 64, 1, 0,
            0, 0, 0, 0, 0, 0, stream))
        out["grid_sample_host_us"] = host_us(grid_sample_call(tiny, tx, ty, False))
    if "ca_radial" in groups:
        # the radial kind against the plain maps plus the bilinear kind, lone
        # calls (median_ms) and back to back (queued_ms; the maps path one
        # call a spin, its ~130 launches a call outrun the spin at two), with
        # grid_sample on the plain maps as the library yardstick; the bound:
        # the plane in and out once (8 B a pixel and plane) and the plain
        # version's float32 operations
        from chip_smoke import bound, float_ops, queued_ms

        for key, (stack, model) in state["ca_radial"].items():
            form = model.kernel_form()
            for inverse in (False, True):
                k = f"ca_radial_{key}_{'inverse' if inverse else 'forward'}"
                mx, my = plain_maps(stack, model, inverse)

                def radial(stack=stack, form=form, inverse=inverse):
                    return K.remap_radial_kernel(stack, form, inverse)

                def maps_path(stack=stack, model=model, inverse=inverse):
                    return K.remap_kernel(stack, *plain_maps(stack, model, inverse), "bilinear")

                library = grid_sample_call(stack, mx, my, False)
                out[f"{k}_ms"] = median_ms(radial)
                out[f"{k}_queued_ms"] = queued_ms(radial)
                out[f"{k}_sha"] = digest(radial())
                out[f"{k}_maps_path_ms"] = median_ms(maps_path, runs=5)
                out[f"{k}_maps_path_queued_ms"] = queued_ms(maps_path, runs=1)
                out[f"{k}_maps_remap_queued_ms"] = queued_ms(
                    lambda: K.remap_kernel(stack, mx, my, "bilinear"))
                out[f"{k}_grid_sample_ms"] = median_ms(library)
                out[f"{k}_grid_sample_queued_ms"] = queued_ms(library)
                small = stack[:1, :64, :64].contiguous()
                ops = float_ops(lambda: K.remap_radial_plain(small, form, inverse))
                out[f"{k}_ops_per_px"] = ops / small.numel()
                out[f"{k}_bound_ms"], out[f"{k}_bound_by"] = bound(
                    2 * stack.numel() * 4, ops / small.numel() * stack.numel())
                out[f"{k}_sass_instructions_a_thread"] = radial_sass_instructions(
                    list(K.RADIAL_FORMS).index(form[0]), inverse)
                del mx, my, library
    if "eag_resample" in groups:
        # each kernel beside its plain version, lone calls (median_ms) and
        # back to back (queued_ms), with its bound by bytes
        from chip_smoke import bound, queued_ms

        for key, (mosaic, phases, subs, green) in state["eag"].items():
            px = mosaic.numel()
            calls = {"eag_fill": ((lambda: K.eag_fill_kernel(*phases)),
                                  (lambda: resample_g_to_full_resolution_plain(*phases)), 8)}
            for position, sub in subs.items():
                calls[f"eag_upsample_{position.name.lower()}"] = (
                    (lambda sub=sub, position=position: K.eag_upsample_kernel(sub, green,
                                                                               position)),
                    (lambda sub=sub, position=position: resample_channel_plain(sub, green,
                                                                                position)),
                    9)
            for label, (kernel, plain, bytes_per_px) in calls.items():
                k = f"{label}_{key}"
                out[f"{k}_ms"] = median_ms(kernel)
                out[f"{k}_queued_ms"] = queued_ms(kernel)
                out[f"{k}_sha"] = digest(kernel())
                out[f"{k}_plain_ms"] = median_ms(plain, runs=5)
                out[f"{k}_plain_queued_ms"] = queued_ms(plain, runs=1)
                out[f"{k}_bound_ms"], out[f"{k}_bound_by"] = bound(bytes_per_px * px, 0)
    if "heal" in groups:
        hs = state["heal"]
        planes = hs["planes"]
        means = planes.mean(dim=(-2, -1)).contiguous()
        buf = torch.empty_like(planes)
        none = torch.zeros_like(hs["masks"])
        out["heal_sites"] = int(hs["masks"].sum())
        out["heal_mean_ms"] = median_ms(lambda: planes.mean(dim=(-2, -1)))
        for key, masks in (("heal", hs["masks"]), ("heal_dense", hs["dense"])):
            out[f"{key}_ms"] = median_ms(lambda: K.heal_kernel(planes, masks, *HEAL_SWEEPS))
            out[f"{key}_launch_ms"] = median_ms(
                lambda: heal_launch(planes, masks, means, buf, *HEAL_SWEEPS))
            out[f"{key}_sha"] = digest(K.heal_kernel(planes, masks, *HEAL_SWEEPS))
        out["heal_copy_launch_ms"] = median_ms(
            lambda: heal_launch(planes, none, means, buf, *HEAL_SWEEPS))
        # a yardstick for the copy: torch's own copy of the planes (192 of
        # the kernel's 216 MB)
        out["heal_torch_copy_ms"] = median_ms(lambda: buf.copy_(planes))
    if "decision" in groups:
        for is_hdr, (fields, mat, wb) in state["decision"].items():
            key = "decision_hdr" if is_hdr else "decision"
            out[f"{key}_ms"] = median_ms(lambda: K.decision_kernel(*fields, mat, wb, is_hdr))
            out[f"{key}_sha"] = digest(K.decision_kernel(*fields, mat, wb, is_hdr))
    if "median5" in groups:
        chroma = state["staged"]["chroma"]
        out["median5_ms"] = median_ms(lambda: K.median5_kernel(chroma))
        out["median5_sha"] = digest(K.median5_kernel(chroma))
    if "homogeneity" in groups:
        lab = state["staged"]["lab"]
        for vertical in (False, True):
            key = "homogeneity_v" if vertical else "homogeneity_h"
            out[f"{key}_ms"] = median_ms(lambda: K.homogeneity_kernel(*lab, vertical))
            out[f"{key}_sha"] = digest(K.homogeneity_kernel(*lab, vertical))
        # a yardstick for its bytes: torch's own copy of the three input planes
        # (576 MB moved where the kernel moves 384 MB)
        src = torch.stack(lab)
        dst = torch.empty_like(src)
        copy_ms = median_ms(lambda: dst.copy_(src))
        out["homogeneity_torch_copy_ms"] = copy_ms
        out["homogeneity_tb_s"] = src[0].numel() * 16 / (out["homogeneity_h_ms"] * 1e9)
        out["homogeneity_torch_copy_tb_s"] = 2 * src.numel() * 4 / (copy_ms * 1e9)
        del src, dst
    if "multisection" in groups:
        ms = state["multisection"]
        delta, lo, hi, target = ms["delta"], ms["lo"], ms["hi"], ms["target"]
        out["detect_ms"] = median_ms(lambda: find_erroneous_pixels_median(ms["frame"]))
        out["multisection_ms"] = median_ms(lambda: K.multisection_kernel(delta, lo, hi, target))
        out["multisection_sha"] = digest(torch.stack(K.multisection_kernel(delta, lo, hi,
                                                                           target)))
        bracket = torch.stack([lo, hi])
        counts = torch.zeros(4 * 16 + 1, dtype=torch.int32, device="cuda")

        def passes(k=20):
            for _ in range(k):
                multisection_launch(delta, bracket, counts, target)

        out["multisection_pass_ms"] = median_ms(passes) / 20
        out["multisection_plain_pass_ms"] = median_ms(
            lambda: multisection_plain(delta, lo, hi, target, 1), runs=5)
        out["multisection_amax_ms"] = median_ms(lambda: delta.amax(dim=(-2, -1)))
        out["multisection_bound_ms"] = delta.numel() * 4 / 3.35e9
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", action="append", default=[])
    ap.add_argument("--kernels", default=",".join(GROUPS),
                    help="the groups to check and time, of " + ",".join(GROUPS))
    ap.add_argument("--no-check", action="store_true",
                    help="skip the comparisons with the plain versions")
    args = ap.parse_args()
    groups = [g for g in args.kernels.split(",") if g]
    if not groups or any(g not in GROUPS for g in groups):
        ap.error(f"--kernels takes a comma-separated list of {GROUPS}")
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    variants = []
    for spec in args.variant or ["package"]:
        spec, _, csrc = spec.partition("@")
        name, _, flags = spec.partition(":")
        variants.append((name, [x for x in flags.split(",") if x], csrc))
    # built before the inputs, whose detector and develops load the package's
    # library (so that its nvcc output is this build's)
    builds = build_variants(variants)
    state = {}
    if {"ahd", "rl", "postprocess", "remap"} & set(groups):
        f = frame(*FULL, seed=7)
        lin = develop(f, DevelopConfig(gamma_encode=False, use_pallas=False))
        mat = cam_to_lin_srgb_matrix(f.cam_mat, f.cam_white)
        state = {"frame": f,
                 "luma": (0.299 * lin[..., 0] + 0.587 * lin[..., 1]
                          + 0.114 * lin[..., 2]).contiguous(),
                 "srgb": develop(f, DevelopConfig(use_pallas=False)),
                 "planes": K.ahd_plain(f.bayer, mat, f.wb_reciprocal(), f.is_hdr, 0)}
        del lin
    if {"remap", "ca_radial"} & set(groups):
        state["ca"] = ca_stack_state()
    if "ca_radial" in groups:
        state["ca_radial"] = ca_radial_state(state["ca"])
    if "eag_resample" in groups:
        state["eag"] = eag_state()
    if "heal" in groups:
        state["heal"] = heal_state()
        print(f"heal inputs: planes {tuple(state['heal']['planes'].shape)}, "
              f"{int(state['heal']['masks'].sum())} sites from the detector, "
              f"{int(state['heal']['dense'].sum())} at density {HEAL_DENSE:g}", flush=True)
    if "decision" in groups:
        state["decision"] = decision_state()
    if {"median5", "homogeneity"} & set(groups):
        state["staged"] = staged_state()
    if "multisection" in groups:
        state["multisection"] = detector_state()
    ok = True
    tags = {"ahd": ("ahd_kernel",), "rl": ("rl_",), "postprocess": ("postprocess_kernel",),
            "remap": ("remap_kernel", "lanczos4_kernel", "bilinear_kernel"),
            "heal": ("heal",), "decision": ("decision_kernel",),
            "median5": ("median5_kernel",), "homogeneity": ("homogeneity_kernel",),
            "multisection": ("multisection_kernel",), "ca_radial": ("RadialCoords",),
            "eag_resample": ("eag_",)}
    entry_tags = [tag for g in groups for tag in tags[g]]
    order = variants + variants[::-1] if len(variants) > 1 else variants
    seen = set()
    for name, flags, csrc in order:
        load_variant(flags, csrc)
        if name not in seen:
            seen.add(name)
            _, log, seconds = builds[name]
            print(f"{name}: nvcc {seconds:.1f} s (all variants built together); ptxas:",
                  flush=True)
            lines = log.splitlines()
            for i, line in enumerate(lines):
                if "Compiling entry" in line and any(tag in line for tag in entry_tags):
                    print("  " + line.split("for 'sm_90a'")[0].strip(), flush=True)
                    for extra in lines[i + 1:i + 4]:
                        if "registers" in extra or "spill" in extra:
                            print("    " + extra.strip(), flush=True)
            if "decision" in groups:
                print_decision_sass(name)
            checks = {"ahd": check_ahd, "rl": check_rl, "postprocess": check_postprocess,
                      "remap": lambda n: check_remap(n, state), "heal": check_heal,
                      "decision": check_decision, "median5": check_median5,
                      "homogeneity": check_homogeneity,
                      "multisection": lambda n: check_multisection(n, state["multisection"]),
                      "ca_radial": lambda n: check_ca_radial(n, state["ca_radial"]),
                      "eag_resample": lambda n: check_eag(n, state["eag"])}
            if not args.no_check:
                for g in groups:
                    ok &= checks[g](name)
        print(json.dumps(times(name, state, groups)), flush=True)
    print(card)
    print(json.dumps({"ok": bool(ok)}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
