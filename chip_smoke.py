#!/usr/bin/env python3
"""Smoke run of pysp_tpu_torch, the PyTorch + CUDA port, on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0, no result line):

1. Setup: a CUDA device must be present; prints the card's name and power
   limit, builds the CUDA kernels from ``pysp_tpu_torch/csrc`` with nvcc and
   prints the build time and ptxas report.
2. Each kernel against its plain PyTorch version on the card, on structured
   512x768 scenes:
   - AHD kernel (through ``demosaic_ahd_mega``, non-HDR and HDR, 0-2
     chroma-median stages, 512x768 and 510x762, whose tiles overhang on both
     axes) against ``demosaic_ahd_channels`` over the whole frame, border
     included: without stages at most 0.01% of the pixels differ (H/V picks
     that flip at exact homogeneity ties) and every other pixel is bit-equal;
     with S stages every pixel outside the 4 S px dilation of that set is
     bit-equal; >= 50 dB PSNR; the fused colour tail within 2e-6 of the
     external tail.
   - postprocess kernel against ``postprocess_color_channels`` on noisy planes
     with outlier corners of 512x768, 510x762 (rows off the 16-byte
     alignment), 37x50, 3x5 and 1x7: ``torch.equal``.
   - RL kernel against ``rl_plain``: sigma 1, 2 and 10.5 (reach 3, 6 and 31),
     3 and 20 iterations, 1 and 3 channels, 512x768 and a 509x763 frame that
     is not a whole number of tiles: ``torch.equal``.
   - remap kernel against ``remap_plain``: bilinear and Lanczos4, maps shared
     and per channel, with and without displacement bounds, 1 and 3
     channels: bilinear ``torch.equal``; Lanczos4 (whose weights come from one
     ``sinf`` and one ``sincosf`` an axis, not the plain version's sixteen
     sines) within 5e-6 of ``remap_plain`` and no further from the same remap
     computed in float64 on the card than ``remap_plain`` is plus 1e-6.
   - heal kernel against ``heal_plain``: planes 256x384, 253x381 and 3x5,
     masks at densities 1e-4, 3e-3 and 0.6 with every plane corner set, a
     3x3 cluster, a 13x13 blob that the fill cannot reach and blobs across
     tile corners that a halo one site short would get wrong, 4 + 2 and 6 + 2
     sweeps: bit-exact.
   - median5 kernel against ``ops.stencil.median5`` and homogeneity kernel
     (both directions) against ``homogeneity_map_channels``: 512x768, 509x763
     (tiles overhang, rows off the 16-byte alignment), 100x260 (blocks on the
     16-byte path beside edge blocks), 130x190, 3x5, 1x7 and 1x1,
     bit-exact.
   - decision kernel against ``ahd_decision_plain``: 512x768 and 510x762,
     non-HDR and HDR: picks equal except on at most 0.05% of pixels (exact
     ties that ``cbrtf`` flips), the fraction printed.
3. Nine main paths, each driven with every launch count set to 0 just before
   it and read just after it (the ninth, parallel, phase by phase, after
   phase 4's measurements of the ca path, whose burst and 102 MP scene it
   takes):
   - develop: a 4000x6000 RGGB synthetic DNG through ``load_raw`` (default
     device, the card) ``-> develop(Best) -> save_image``, then a 1500x2000
     BGGR DNG the same way. Asserts that each develop was one launch of the
     AHD kernel and none of the homogeneity or postprocess kernels, that the
     images are finite, of the right shape and within [0, 1], and that each,
     border included, is within the flip bound of the same develop through
     the plain version on the card (under 0.01% of pixels off by more than
     1e-4, over the whole frame and over its 13 px border frame; >= 100 dB
     PSNR at 24 MP).
   - finishing: a 4000x6000 RGGB DNG carrying an OpcodeList3 WarpRectilinear
     block through ``load_raw -> develop(gamma off) ->
     gaussian_rt_deconvolution_yuv(1.0, 20) -> unsharp_mask_lab(2.0, 0.5) ->
     lin_srgb_to_srgb(clip) -> apply_opcode_3_warp(lanczos4) -> save_image``,
     what ``python -m pysp_tpu_torch develop --deconv 1.0:20 --unsharp 0.5:2
     --warp`` runs. Asserts the launches (AHD 1, RL 20, remap 1, homogeneity
     and postprocess 0), that the image is
     finite, (H, W, 3) and within [0, 1], that the TIFF is full length, that
     the finishing stages are within 1e-4 of the same stages through the plain
     versions on the card from the same developed image, and that the CLI,
     run once more in a subprocess, writes the same TIFF.
   - corrections (BASELINE configs 3 and 4): a 4000x6000 RGGB DNG with hot
     photosites planted in dark parts of the scene and a 4000x6000 vignetting
     flat DNG through ``load_raw -> develop_pipeline(flat field, hot-pixel
     heal) -> save_image``; then five 4000x6000 brackets of the scene a stop
     apart (exposure 1/400 to 1/25 s, the same hot photosites) through
     ``load_raw -> stack_frames -> develop_pipeline(consensus heal, HDR fuse)
     -> save_image``. Asserts the launches (1 + 5 heals, 2 AHD, 4 multisection
     passes a detected frame, 24, homogeneity and postprocess 0), that every
     planted site was flagged and healed into the range of
     its plane's 4-neighbours, that the images are finite (H, W, 3) within
     [0, 1], that the fused frame is HDR with ``lim_sat > 1``, that each image
     is >= 50 dB PSNR against the same pipeline composed from the plain
     versions on the card (the detector's plain passes, ``heal_plain``, the
     plain develop), and that the CLI (``develop --flat
     --repair-hot-pixels``, ``develop b0..b4 --hdr --repair-hot-pixels``), run
     in subprocesses, writes the same TIFFs.
   - tiers (the demosaic layer outside the AHD kernel's route): the 4000x6000
     RGGB DNG through ``load_raw -> develop -> save_image`` three times: Best
     with three chroma-median stages, which the AHD kernel does not take, so
     the whole frame goes through the staged AHD route (the homogeneity kernel
     twice, the postprocess kernel three times); Fast; Draft; and the
     1500x2000 BGGR DNG at Fast. Then ``develop_to_image`` of the staged
     route, ``median5_kernel`` on its R - G plane, and ``ahd_decision`` on the
     frame's six candidate fields. Asserts those launches, that the staged
     develop equals the plain one (``use_pallas=False``) on the card bit for
     bit, that Fast and Draft are finite, (H, W, 3), within [0, 1] and within
     1e-5 of the port's own develop of the same frame on the CPU, that the
     median equals its plain version and the picks their plain chain except on
     at most 0.05% of pixels, and that the CLI (``develop --quality fast``)
     writes the same TIFF. BASELINE config 2 rides along: the same DNG through
     ``controller_for_source -> update_by_temperature(5000 K, cross blend) ->
     frame_from_parts -> develop(Fast)``, held like Fast and timed, its colour
     fields printed, and ``develop --quality fast --temperature 5000`` through
     the CLI writes the same TIFF.
   - ca (BASELINE config 5): 16 RGGB DNGs of 1000x1504 (``make_scene``, seeds
     0-15) with Poly3(0.01) CA planted into R and B through ``load_raw ->
     stack_frames -> remove_ca_from_raw(Poly3(0.01), Poly3(0.01)) -> develop
     (Best, 1 stage) -> apply_opcode_3_warp`` (Lanczos4) of every frame ->
     ``save_image`` of the first and the last. Asserts the launches (remap
     4 + 16, AHD 16, EAG 3, the others 0), that the CA stage equals the same
     stage through ``remap_plain`` and the plain resamples and the burst's CA
     the frames' one by one bit for bit, that the R and B planes lie closer to the clean scene after the
     correction, that every developed frame is finite, (H, W, 3) and within
     [0, 1] (after the warp within Lanczos4's overshoot), and each >= 50 dB
     against the same composition from the plain versions. Then the blind fits
     on a 1000x1504 ring chart DNG (R displaced by Poly3(0.02), B by
     Poly3(-0.01)): the template fit (R's k1 in (0.002, 0.08)) and the
     gradient fit (R's k1 within 50% of 0.02), timed, and ``develop --ca
     template --save-params`` then ``develop --params`` through the CLI, which
     must fit and write the same TIFF.
   - surface (the rest of the DNG develop surface): a 4000x6000 RGGB DNG of
     ``make_scene`` with one region blown in all three channels and a larger
     one in G only, scaled so that 5% of the photosites reach the white
     level, carrying an OpcodeList1 (a FixBadPixelsConstant on 200 planted
     sentinels, a FixBadPixelsList of 500 dead points and 10 dead rects) and
     an OpcodeList2 (a 17x17 GainMap for each CFA phase, gains 0.8-1.3, and a
     FixVignetteRadial), through ``load_raw -> develop_with_stats(Best,
     highlights="reconstruct") -> save_image``, then
     ``demosaic.ahd.postprocess_color`` of the image (the postprocess
     kernel's (H, W, 3) entry) and a staged reconstruct develop (three
     stages) of a 1500x2000 crop. Asserts the launches (the develop one AHD
     launch in its demosaic-only mode and nothing else; the path AHD 1,
     homogeneity 2, postprocess 4), the load on the card within 1e-6 of the
     load on the CPU, every listed site and no other changed by the heal,
     the develop against the plain one on the card (>= 90 dB, under 0.01% of
     pixels off by more than 1e-4, whole frame and border frame), the blown
     core below white with real variance and every value in [0, 1 + 1e-6],
     the statistics against float64 NumPy (means and std within 1e-5
     relative, fractions exact, p99 as ``numpy.quantile`` within 1e-6), the
     (H, W, 3) entry ``torch.equal`` to the plain stage, the staged develop
     against plain with the same gates, and ``develop --highlights
     reconstruct --stats`` through the CLI: the same TIFF, and on stderr the
     JAX CLI's stats keys with the in-process values.
   - formats (every raw format the loaders read): one mosaic of
     ``make_scene`` written with the port's own writers as an LJ92 DNG
     (compression 7), CR2, MRW, RAF, ORF, RW2 (the small-step content its v4
     coder keeps exact, padded to its 14-photosite packets outside the
     recorded borders) and NEF at 4000x6000, and as ARW, PEF and SRW (whose
     writers are pure Python) at 1000x1504, each through ``load_raw ->
     develop(Best) -> save_image`` (.png) ``and save_png16``. Asserts that the
     native library is the g++ build of ``native/dng_fast.cc`` under
     ``pysp_tpu_torch/_build/``, that each develop was one AHD launch and
     nothing else, that each load on the card is ``torch.equal`` to the load
     on the CPU field by field, that the decoded values are the written ones
     (ARW2: within its block shift), that each develop is within the flip
     bound of the plain one, that both PNGs parsed back with ``zlib`` equal
     ``to_uint8`` / ``to_uint16`` of the image, that ``develop x.cr2
     --bit-depth 16`` through the CLI writes the same 16-bit PNG to its
     default ``x.png``, that ``info`` reads every file and that
     ``verify-decode`` on the directory finds no mismatch and no built-in
     error; prints each format's write time, the load split on the host clock
     (decode on the host, to the card) and the develop's time by CUDA
     events. Before the first load the script points
     ``PYSP_TPU_MATRIX_CACHE`` at a scratch file (the DNG loads harvest their
     calibration rows there, which the path checks) and at the end asserts
     that ``~/.cache/pysp_tpu/harvested_matrices.json`` was neither created
     nor changed.
   - drivers (the several-file drivers): eight 4000x6000 RGGB DNGs of
     ``make_scene`` (seeds 30-37; every other one LJ92) first through the
     sequential loop ``load_raw -> develop(Best) -> save_image`` (.png), then
     through ``develop_files`` (the stream: host decode in a thread pool,
     copies on their own CUDA streams, develop, saves in a writer pool) and
     ``develop_stream``; 16 DNGs of 1000x1504 through ``load_burst ->
     develop_burst``; ``compat.RawBayerDataFromRaw`` of the first 24 MP
     DNG ``-> demosaic(Best) -> to_lin_srgb -> lin_srgb_to_srgb``; and the
     ``main`` of ``examples/differentiable_isp_torch.py`` and of
     ``examples/full_pipeline_torch.py`` on the card. Before it, how far four
     threads overlap a 24 MP uncompressed load, an LJ92 load and an 8-bit
     PNG save (their rate against one thread's). Asserts the launches (8 AHD
     in each of the three develops of the files, 16 in the burst, none in
     the class API and the differentiable fit; in the full pipeline 3 heals,
     the staged Best route's 2 homogeneity and 1 postprocess launches, and
     3 remaps), that the stream yields the files in input order,
     each image equal to the sequential develop (``np.array_equal``), that
     the sequential, streamed and CLI (``develop <8 files> -o DIR``, in a
     subprocess) PNGs are byte-equal, that the streamed run is faster than
     the sequential one on the host clock, that ``load_burst`` is
     ``torch.equal`` to ``stack_frames`` of the frames loaded one by one, that
     the class API's image is within the flip bound of ``develop`` with the
     kernel (>= 100 dB), that the differentiable fit recovers the neutral and
     the gain within ``tests/test_differentiable_isp.py``'s bounds and that
     the full pipeline writes its 256x256 PNG; prints files/s, both runs'
     host clock and the device's busy share under ``torch.profiler``.
   - parallel (``pysp_tpu_torch.parallel``: the mesh, one thread a shard, on
     meshes whose every position is card 0, so the shards share the card,
     each on its own stream): (a) config 5 batch-sharded: the ca path's 16
     frames with 500 hot sites (60 in every frame, 40 in frames 0-7, 25 in
     each frame alone) through ``develop_pipeline_sharded`` on a (4, 1) mesh
     (consensus heal at 0.5, both CA models, Best with one stage, the ca
     path's Lanczos4 warp), each frame against the unsharded composition
     (``develop_pipeline``'s masks and heal, ``remove_ca_from_raw``,
     ``develop``, ``apply_opcode_3_warp``); (b) the 102 MP scene with the
     chain's hot sites through ``develop_frame_spatial`` on a (1, 4) mesh,
     with the chain's CA and warp at half strength (the full ones are
     refused on the host, as in JAX: Poly3(0.01) is 31 px of static
     displacement at 102 MP, beyond the 24 px cap, and the warp beyond
     ``displacement_bounds``' cap), against the unsharded chain, its peak
     device memory printed; a 4000x6000 Best ``develop_spatial`` on (1, 4);
     (c) config 4: ``develop_hdr_sharded`` of the corrections path's five
     brackets on a (5, 2) mesh against ``develop_pipeline(fuse_hdr)``; (d)
     ``develop_burst_sharded`` on (4, 1) and ``develop_burst_spatial`` on
     (2, 2) of the 16 frames at Best against ``develop_burst``; (e) both
     sharded examples' ``main`` on the card. Asserts each phase's launches
     of the AHD, heal, remap, multisection (4 a detected frame or row shard)
     and EAG kernels (3 a CA removal or row shard) and none of the others; (a) and (d)
     every frame (for ``develop_burst_spatial`` every row farther than the
     halo from the frame's top and bottom) within 3e-5 of its counterpart,
     (b) and (c) those rows within 3e-5 and >= 40 dB over the whole frame,
     the maxima printed; times each sharded call beside its counterpart by
     CUDA events (median of 3 after 1) with both device-busy shares.
4. Each kernel's wrapper against its plain version at the shapes the main
   paths give it, and times (CUDA events, median of 10 runs after 2 warm-ups;
   the plain finishing path and the plain corrections pipelines median of 3
   after 1) of the kernels, their plain versions, ``grid_sample`` (the one
   PyTorch call that computes the bilinear remap; the Lanczos4 remap also
   with a map for each channel; the bilinear remap and ``grid_sample`` at
   their three shapes also back to back, ``queued_ms``: ten calls queued
   behind a spin kernel, so that the wrapper's host time before a lone
   launch is left out, kept as the record's ``queued_ms`` and
   ``library_queued_ms`` beside the lone call's ``ms`` and ``library_ms``), the whole develop, the
   whole finishing path, the two corrections pipelines and the three develops
   of the tiers path (the plain staged develop: median of 3 after 1), with
   the device busy share of each path under ``torch.profiler``. For the ca
   path: one bilinear CA launch on the burst's (16, 1000, 1504) greens with
   shared maps against its plain version, its bound and ``grid_sample``; the
   AHD kernel on one 1.5 MP frame; config 5's CA stage, 16 develops, 16 warps
   and the whole composition with the kernels and plain (median of 3 after 1),
   with its idle share, and the bilinear launch at the shard-stack shape of
   the parallel path's (4, 1) mesh (4 x 1000x1504) against plain, its bound
   and ``grid_sample``; then the composed 102 MP chain with the kernels
   (8736x11648: hot-pixel detection and heal -> CA -> Best -> Lanczos4 warp),
   each stage and the whole chain median of 3 after 1, the CA stage equal to
   its plain version, the image finite and in range. The Best
   develop is timed five separate times with the kernels and five times
   plain, and each of the five must beat its plain one. Each kernel's bound is
   the larger of its bytes (each input read once, each output written once)
   over 3.35 TB/s and its float32 operations, counted on its plain version at
   the same inputs, over 67 TFLOP/s. The multisection kernel on config 3's
   delta planes (4 x 2000 x 3000): the wrapper's four passes against
   ``multisection_plain``'s (``torch.equal``), a counting pass (20 launches
   back to back, per launch) against its 96 MB over 3.35 TB/s and a plain
   pass, and the four passes of one wrapper call against the plain four.
   The EAG kernels of CA removal (the green fill and R's and B's upsample) at
   mf102's 8736x11648 frame, at config 5's stack and at small odd bursts
   against their plain versions (``torch.equal``), and at the first two
   timed as lone calls and back to back beside their plain versions and
   their bounds by bytes.
   Beside it: the decision kernel's issue
   floor (its SASS's instructions a pick), the median5 kernel's min/max floor
   (the FMNMX of its SASS a pixel at half the issue rate) and the homogeneity kernel's achieved TB/s beside ``torch``'s own copy
   of its three input planes. For the surface path: the load split on the
   host clock (decode, to the card, opcode heal, gains, the whole
   ``load_raw``), the reconstruct develop with the kernel and plain, its
   AHD kernel in planes mode, reconstruction and tail, the planes mode
   against the tail mode, ``develop_with_stats`` against ``develop``, the
   (H, W, 3) postprocess entry against the channel entry (and against
   channel copies and a stack), each with the card's name and power limit,
   and the develop's idle share.

Before the summary, one line a kernel record (and a line for each of its
measured shapes, such as the bilinear remap at the (H, W, 3) image, the CA
stack and the shard stack) gives its time against its bound and against the
library call where there is one; these are readings, not gates.

The line before the last holds the per-kernel JSON summary, the one before it
the card's name and power limit; the last line is the device JSON. Each
kernel's ``launches`` there is the sum of its counts over the nine main paths
and ``launches_by_path`` gives each path's own.
"""
from __future__ import annotations

import contextlib
import hashlib
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

from pysp_tpu_torch import (
    GainMap,
    PipelineConfig,
    Poly3CorrectionModel,
    QualityDemosaic,
    RawFrame,
    compute_ca_lens_models_for_raw,
    compute_structural_instability,
    VignetteRadial,
    apply_gain_opcodes,
    develop_pipeline,
    develop_to_image,
    develop_with_stats,
    encode_gain_map,
    encode_opcode_list,
    encode_vignette_radial,
    fit_ca_models_gradient,
    frame_from_parts,
    load_raw,
    make_mesh,
    remove_ca_from_raw,
    save_image,
    stack_frames,
)
from pysp_tpu_torch.colorimetry.transforms import (
    cam_to_lin_srgb_matrix,
    color_tail_channels,
    lin_srgb_to_srgb,
    rgb_to_lab_channels,
)
from pysp_tpu_torch.core.bayer import (
    bayer_to_planes,
    bayer_to_rgbg,
    planes_to_bayer,
    reversible_transform_rggb,
)
from pysp_tpu_torch.core.frame import unstack_frames
from pysp_tpu_torch.correct.bad_pixels import (
    find_erroneous_pixels_median,
    multisection_plain,
    repair_bad_pixels,
)
from pysp_tpu_torch.correct.ca import removal as ca_removal
from pysp_tpu_torch.correct.ca import solver as ca_solver
from pysp_tpu_torch.correct.ca.roi import PooledChannel, RoiDetector
from pysp_tpu_torch.correct.flat_field import flat_frame_correction
from pysp_tpu_torch.correct.hdr import fuse_exposures_to_raw
from pysp_tpu_torch.demosaic.ahd import (
    ahd_candidates,
    ahd_decision,
    _homogeneity_kernel_count,
    ahd_decision_plain,
    demosaic_ahd_channels,
    postprocess_color,
    postprocess_color_channels,
)
from pysp_tpu_torch.demosaic.ahd_mega import demosaic_ahd_mega
from pysp_tpu_torch.demosaic.eag import (
    resample_channel_plain,
    resample_g_to_full_resolution,
    resample_g_to_full_resolution_plain,
)
from pysp_tpu_torch.demosaic.homogeneity import homogeneity_map_channels
from pysp_tpu_torch.filters.blur import get_1d_gaussian_filter
from pysp_tpu_torch.filters.sharpen import gaussian_rt_deconvolution_yuv, unsharp_mask_lab
from pysp_tpu_torch.io.metadata import get_opcode_3_block
from pysp_tpu_torch.io import native
from pysp_tpu_torch.io import tiff as T
from pysp_tpu_torch.io.raw_loader import (
    _black_white_levels,
    _normalize_host,
    controller_for_source,
)
from pysp_tpu_torch.io.tiff import write_synthetic_dng
from pysp_tpu_torch.ops import cuda_kernels as K
from pysp_tpu_torch.ops.phase_kernels import BayerPatternPosition as P
from pysp_tpu_torch.ops.resample import remap_bilinear
from pysp_tpu_torch.ops.stencil import median2, median5
from pysp_tpu_torch.pipeline.develop import DevelopConfig, develop
from pysp_tpu_torch.utils.testing import (
    HEAL_TILE_KINDS,
    LOSSY_RAW_FORMATS,
    RAW_FORMATS,
    arw2_error_bound,
    chroma_case,
    heal_case,
    heal_tile_case,
    make_scene,
    mosaic_rggb,
    psnr,
    raw_format_mosaic,
    read_png,
    ring_chart,
    write_raw_format,
)
from pysp_tpu_torch.warp import fix_opcodes as FO
from pysp_tpu_torch.warp import gain_opcodes as GO
from pysp_tpu_torch.warp import rectilinear
from pysp_tpu_torch.warp.opcodes import apply_opcode_3_warp, encode_warp_rectilinear
from pysp_tpu_torch.warp.rectilinear import compute_remapping_table, displacement_bounds

CAM = np.array([[0.9, -0.2, -0.1], [-0.3, 1.1, 0.2], [0.0, -0.4, 1.3]], np.float32)
WB = np.array([0.45, 1.0, 0.62], np.float32)
FULL_H, FULL_W = 4000, 6000
BGGR_H, BGGR_W = 1500, 2000
FLIP_TOL = 1e-4      # a pixel differing by more is counted as a flipped pick
MIN_PSNR = 50.0
MIN_PSNR_FULL = 100.0              # the develop at 24 MP, kernels against plain
MAX_FLIP_FRAC = 1e-4               # pixels that an H/V pick flipped at an exact tie: 0.01%
AHD_BORDER = 4 * K.AHD_MAX_STAGES + 5   # the AHD stage chain's reach: the border frame
TAIL_ATOL = 2e-6
# Bilinear is held bit for bit. Lanczos4's weights are not the plain version's
# operation sequence (one sinf and one sincosf an axis): within this of
# remap_plain, and no further from the float64 remap than remap_plain is plus
# the slack.
REMAP_ATOL = {"bilinear": 0.0, "lanczos4": 5e-6}
LANCZOS4_F64_SLACK = 1e-6
FINISH_ATOL = 1e-4                 # finished sRGB image, kernels against plain
MAX_PICK_FLIPS = 5e-4              # H/V picks that cbrtf may flip at exact ties (0.05%)
TIER_ATOL = 1e-5                   # Fast and Draft, the card against the CPU
# The tiers path: a stage count that leaves the AHD kernel's route, so that the
# whole frame takes the staged route.
STAGED_STAGES = K.AHD_MAX_STAGES + 1
# The finishing path: DNG lens warp (about 11 px at the corners at 24 MP) and
# the filters of `develop --deconv 1.0:20 --unsharp 0.5:2 --warp`.
WARP_COEFFS = (1.0, -0.003, 0.0, 0.0, 0.0, 0.0)
WARP_CENTER = (0.5, 0.5)
DECONV = (1.0, 20)                 # sigma, iterations
UNSHARP = (2.0, 0.5)               # radius, amount
# The corrections path: BASELINE config 3 (flat field + hot-pixel heal + Best)
# and config 4 (five brackets a stop apart, consensus heal, Bayer-domain fuse).
CFG3 = PipelineConfig(flat_field=True, repair_hot_pixels=True)
CFG4 = PipelineConfig(fuse_hdr=True, repair_hot_pixels=True, hot_pixel_shared_ratio=0.5)
BRACKETS = 5
# NVIDIA H100 SXM data sheet: HBM3 bandwidth and float32 rate outside the
# tensor cores (an add, a multiply or a min counts as one operation here).
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# Instructions the card issues a second: 132 SMs x 4 schedulers x 32 lanes x
# 1.98 GHz (the boost clock); min and max issue at half that rate.
INSTRUCTIONS_PER_S = 33.5e12
MINMAX_PER_S = INSTRUCTIONS_PER_S / 2
HEAL_DENSITY = 1e-2                # the heal's dense mask in phase 4
DEVICE = "cuda"
REPO = os.path.dirname(os.path.abspath(__file__))


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, runs: int = 10, warmup: int = 2) -> float:
    """Median over ``runs`` of one call's device time, by CUDA events."""
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


SPIN_CYCLES = 10_000_000   # queued_ms's spin, about 5 ms at the H100's clock


def queued_ms(fn, runs: int = 10, repeats: int = 5) -> float:
    """The card's time of one call of ``fn`` when calls follow each other:
    CUDA events around ``runs`` calls queued behind a spin kernel
    (``torch.cuda._sleep``), so that the card runs them back to back and never
    waits for the host, divided by ``runs``; median of ``repeats``. Unlike
    ``median_ms`` it leaves out the host's work before a lone launch, which
    the card waits for when the kernel takes well under 0.1 ms."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        spin, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        spin.record()
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        t0 = time.perf_counter()
        for _ in range(runs):
            fn()
        queued = (time.perf_counter() - t0) * 1e3
        end.record()
        end.synchronize()
        if queued >= spin.elapsed_time(start):
            raise RuntimeError(f"the spin ({spin.elapsed_time(start):.3f} ms) ended before "
                               f"the calls were queued ({queued:.3f} ms)")
        times.append(start.elapsed_time(end) / runs)
    return statistics.median(times)


# Arithmetic ATen ops whose every output element is one float32 operation.
_ARITH = frozenset((
    "add", "sub", "rsub", "mul", "div", "neg", "abs", "minimum", "maximum", "clamp",
    "clamp_min", "clamp_max", "where", "lt", "le", "gt", "ge", "eq", "ne", "pow",
    "sin", "floor", "copysign", "reciprocal", "sqrt", "exp", "log",
))


class FloatOpCount(TorchDispatchMode):
    """Counts the float32 operations of what runs under it: one per output
    element of each arithmetic op on floating-point operands. Data movement
    (pads, gathers, copies, stacks) and integer index arithmetic count
    nothing, so the count is a floor of the work."""

    def __init__(self):
        super().__init__()
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket.__name__.rstrip("_") in _ARITH:
            operands = [a for a in args if isinstance(a, torch.Tensor)]
            if operands and any(a.is_floating_point() for a in operands):
                outs = out if isinstance(out, (tuple, list)) else (out,)
                self.ops += sum(o.numel() for o in outs if isinstance(o, torch.Tensor))
        return out


def float_ops(fn) -> int:
    with FloatOpCount() as counter:
        fn()
    return counter.ops


def bound(nbytes: float, ops: float):
    """(least ms, "bytes" or "operations") of work moving ``nbytes`` and doing
    ``ops`` float32 operations on an H100."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


COUNTERS = ("ahd", "postprocess", "rl", "remap", "heal", "median5", "homogeneity",
            "decision", "multisection", "eag_resample")
# The multisection kernel's launches a detected frame (or row shard of one).
DETECT_PASSES = 4
# The EAG kernels' launches a CA removal (or row shard of one) with two
# models: the green fill, then R's and B's upsample.
CA_RESAMPLES = 3


def expect_launches(path: str, launches: dict, **expected) -> None:
    """Raises unless ``path`` launched each kernel exactly ``expected`` times
    (a kernel not named: 0 times)."""
    for name in COUNTERS:
        want = expected.get(name, 0)
        if launches[name] != want:
            raise AssertionError(f"the {path} path launched the {name} kernel "
                                 f"{launches[name]} times, expected {want}")


def zero_launch_counts() -> None:
    for name in COUNTERS:
        K.launch_counts[name] = 0


def launch_counts() -> dict:
    return {name: K.launch_counts[name] for name in COUNTERS}


def device_busy(fn, runs: int = 3):
    """(host ms per run, device kernel ms per run, kernel launches per run) of
    ``fn`` under ``torch.profiler``, after one warm-up. The profiler slows the
    host, so the host time here is an upper bound."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3 / runs
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / runs
    return host_ms, device_ms, len(kernels) / runs


def interior_stats(got: torch.Tensor, want: torch.Tensor):
    """(PSNR dB, fraction of pixels off by > FLIP_TOL, max abs error)."""
    g = got.double().cpu().numpy()
    w = want.double().cpu().numpy()
    d = np.abs(g - w)
    return psnr(g, w), float(np.mean(d > FLIP_TOL)), float(d.max())


def border_frame(t: torch.Tensor, width: int) -> torch.Tensor:
    """The values of an (H, W, ...) tensor within ``width`` pixels of its border."""
    return torch.cat([t[:width].flatten(), t[-width:].flatten(),
                      t[width:-width, :width].flatten(), t[width:-width, -width:].flatten()])


def develop_stats(name: str, got: torch.Tensor, want: torch.Tensor, min_psnr: float) -> float:
    """A developed (H, W, 3) image with the kernels against the plain one, the
    whole frame and its border frame apart: logs and returns the PSNR and
    raises beyond ``min_psnr`` or the flip bound."""
    p, flips, err = interior_stats(got, want)
    off = ((got - want).abs() > FLIP_TOL).any(dim=-1)
    ring = border_frame(off, AHD_BORDER)
    ring_flips = float(ring.float().mean())
    log(f"{name}: kernels vs plain on the card, whole frame PSNR {p:.2f} dB, "
        f"{float(off.float().mean()):.6%} of pixels off by > {FLIP_TOL:g} (max abs {err:.3g}); "
        f"in the {AHD_BORDER} px border frame {ring_flips:.6%} ({int(ring.sum())} of "
        f"{ring.numel()} pixels)")
    if p < min_psnr or float(off.float().mean()) >= MAX_FLIP_FRAC or ring_flips >= MAX_FLIP_FRAC:
        raise AssertionError(f"{name}: the develop with the kernels is outside the flip bound")
    return p


def frame_on_card(h: int, w: int, seed: int, is_hdr: bool, noise: float = 0.0) -> RawFrame:
    """A structured scene's mosaic on the card; with ``noise`` its greens,
    counts and chroma differ from row to row up to the frame's edge, so that
    each border rule gives its own values there."""
    bayer = mosaic_rggb(make_scene(h, w, seed=seed))
    if noise:
        rng = np.random.default_rng(seed)
        bayer = np.clip(bayer + rng.normal(0, noise, bayer.shape), 0.02, 0.98)
    return RawFrame.synthetic(bayer.astype(np.float32), cam_mat=CAM, wb_neutral=WB,
                              is_hdr=is_hdr, device=DEVICE)


def check_remap(label: str, img, mx, my, kind: str, bounds, channels_last: bool) -> float:
    """The remap kernel against its plain version; returns the max abs error.
    Bilinear: ``torch.equal``. Lanczos4: within REMAP_ATOL of ``remap_plain``
    and as close to the float64 remap as ``remap_plain`` plus the slack."""
    got = K.remap_kernel(img, mx, my, kind, bounds, channels_last)
    want = K.remap_plain(img, mx, my, kind, bounds, channels_last)
    err = (got - want).abs().max().item()
    if kind == "bilinear":
        same = torch.equal(got, want)
        log(f"remap kernel vs plain {label} bilinear, bounds {bounds}: bit-exact {same}")
        if not same:
            raise AssertionError(f"bilinear remap kernel differs from plain ({label})")
        return err
    exact = K.remap_plain(img.double(), mx.double(), my.double(), kind, bounds, channels_last)
    err64 = (got.double() - exact).abs().max().item()
    plain64 = (want.double() - exact).abs().max().item()
    log(f"remap kernel vs plain {label} lanczos4, bounds {bounds}: max abs err {err:.3g} "
        f"(tolerance {REMAP_ATOL[kind]:g}); against the float64 remap {err64:.3g}, "
        f"remap_plain itself {plain64:.3g}")
    if err > REMAP_ATOL[kind]:
        raise AssertionError(f"Lanczos4 remap kernel outside tolerance ({label})")
    if err64 > plain64 + LANCZOS4_F64_SLACK:
        raise AssertionError(f"Lanczos4 remap kernel further from float64 than plain ({label})")
    return err


def check_kernels_small() -> None:
    """Phase 2: each kernel against its plain version at 512x768 (the heal on
    planes of 256x384, 253x381 and 3x5)."""
    for h, w in ((512, 768), (510, 762)):
        for is_hdr in (False, True):
            frame = frame_on_card(h, w, seed=1 + int(is_hdr), is_hdr=is_hdr, noise=0.03)
            mat = cam_to_lin_srgb_matrix(frame.cam_mat, frame.cam_white)
            wb = frame.wb_reciprocal()
            flipped = None
            for stages in (0, 1, 2):
                want = torch.stack(demosaic_ahd_channels(frame, stages))
                got = planes = demosaic_ahd_mega(frame, mat, wb, stages)
                differs = (got != want).any(dim=0)
                if stages == 0:
                    flipped = differs
                k = 8 * stages + 1
                near = F.max_pool2d(flipped[None, None].float(), k, 1, k // 2)[0, 0] > 0
                stray = int((differs & ~near).sum())
                ring = int(border_frame(differs, AHD_BORDER).sum())
                p, _, err = interior_stats(got, want)
                external = torch.stack(color_tail_channels(*planes, mat, True, True), dim=-1)
                fused = demosaic_ahd_mega(frame, mat, wb, stages, (True, True))
                tail_err = (fused - external).abs().max().item()
                log(f"AHD kernel vs plain {h}x{w} hdr={is_hdr} stages={stages}, whole frame: "
                    f"{float(differs.float().mean()):.6%} of pixels differ ({ring} of them in "
                    f"the {AHD_BORDER} px border frame), {stray} outside the {4 * stages} px "
                    f"dilation of the stage-0 set, PSNR {p:.2f} dB (max abs {err:.3g}), "
                    f"fused tail max abs err {tail_err:.3g}")
                if float(flipped.float().mean()) > MAX_FLIP_FRAC or stray or p < MIN_PSNR:
                    raise AssertionError("AHD kernel differs from plain beyond tie flips")
                if tail_err > TAIL_ATOL:
                    raise AssertionError("fused colour tail outside tolerance")

    for h, w in ((512, 768), (510, 762), (37, 50), (3, 5), (1, 7)):
        chans = list(torch.from_numpy(chroma_case(h, w, seed=5 + h)).to(DEVICE))
        got = K.postprocess_color_kernel(*chans)
        want = postprocess_color_channels(*chans)
        same = all(torch.equal(g, w_) for g, w_ in zip(got, want))
        log(f"postprocess kernel vs plain {h}x{w}: bit-exact {same}")
        if not same:
            raise AssertionError(f"postprocess kernel differs from plain at {h}x{w}")

    for h, w in ((512, 768), (509, 763)):
        for channels in (1, 3):
            img = scene_on_card(h, w, channels, seed=h + channels)
            for sigma in (1.0, 2.0, 10.5):
                taps = get_1d_gaussian_filter(sigma)
                for iters in (3, 20):
                    same = torch.equal(K.rl_kernel(img, taps, iters),
                                       K.rl_plain(img, taps, iters))
                    log(f"RL kernel vs plain {h}x{w}x{channels} sigma {sigma} (reach "
                        f"{len(taps) // 2}) {iters} iterations: bit-exact {same}")
                    if not same:
                        raise AssertionError("RL kernel differs from plain")

    h, w = 512, 768
    for channels, maps in ((1, "shared"), (3, "shared"), (3, "per_channel")):
        img = scene_on_card(h, w, channels, seed=20 + channels)
        mx, my = warp_maps(h, w, channels if maps == "per_channel" else 1)
        if maps == "shared":
            mx, my = mx[0], my[0]
        for bounds in (None, ((-3, 1), (-2, 3))):
            for kind in ("bilinear", "lanczos4"):
                check_remap(f"{h}x{w}x{channels}, {maps} maps,", img, mx, my, kind, bounds,
                            channels_last=channels > 1)

    cases = [(shape, f"density {density:g}", heal_case(*shape, density, seed=shape[1]))
             for shape in ((256, 384), (253, 381), (3, 5), (1, 1))
             for density in (1e-4, 3e-3, 0.6)]
    cases += [(shape, kind, heal_tile_case(*shape, kind, seed=shape[1]))
              for shape in ((64, 128), (61, 133), (3, 5), (1, 1)) for kind in HEAL_TILE_KINDS]
    for shape, label, arrays in cases:
        planes, mask = (torch.from_numpy(a).to(DEVICE) for a in arrays)
        for sweeps in ((4, 2), (6, 2)):
            same = torch.equal(K.heal_kernel(planes, mask, *sweeps),
                               K.heal_plain(planes, mask, *sweeps))
            log(f"heal kernel vs plain 4x{shape[0]}x{shape[1]}, {label} ({int(mask.sum())} "
                f"sites), {sweeps[0]} + {sweeps[1]} sweeps: bit-exact {same}")
            if not same:
                raise AssertionError("heal kernel differs from plain")


def check_staged_kernels_small() -> None:
    """Phase 2 for the staged AHD route's kernels: median5, homogeneity count
    and direction pick against their plain versions."""
    for h, w in ((512, 768), (509, 763), (100, 260), (130, 190), (3, 5), (1, 7), (1, 1)):
        rgb = torch.from_numpy(make_scene(h, w, seed=30 + h % 7)).to(DEVICE)
        x = (rgb[..., 0] - rgb[..., 1]).contiguous()
        same = torch.equal(K.median5_kernel(x), median5(x))
        log(f"median5 kernel vs plain {h}x{w}: bit-exact {same}")
        if not same:
            raise AssertionError("median5 kernel differs from plain")
        lab = [p.contiguous() for p in rgb_to_lab_channels(*rgb.unbind(-1))]
        for vertical in (False, True):
            same = torch.equal(K.homogeneity_kernel(*lab, vertical),
                               homogeneity_map_channels(*lab, vertical))
            log(f"homogeneity kernel vs plain {h}x{w} vertical={vertical}: bit-exact {same}")
            if not same:
                raise AssertionError("homogeneity kernel differs from plain")

    for h, w in ((512, 768), (510, 762), (130, 190), (62, 122)):
        for is_hdr in (False, True):
            frame = frame_on_card(h, w, seed=40 + int(is_hdr), is_hdr=is_hdr)
            flips = pick_flips(frame)
            log(f"decision kernel vs plain {h}x{w} hdr={is_hdr}: {flips:.6%} of picks differ")
            if flips > MAX_PICK_FLIPS:
                raise AssertionError("decision kernel outside the flip bound")
    # Frames of 2 and 3 px a side on random fields: every count across the
    # border is a mirror of an in-frame one.
    for h, w in ((2, 2), (2, 5), (3, 2)):
        for is_hdr in (False, True):
            frame = frame_on_card(8, 8, seed=1, is_hdr=is_hdr)
            mat = cam_to_lin_srgb_matrix(frame.cam_mat, frame.cam_white)
            wb = frame.wb_reciprocal()
            rng = np.random.default_rng(10 * h + w)
            fields = [torch.from_numpy(rng.random((h, w)).astype(np.float32)).to(DEVICE)
                      for _ in range(6)]
            got = K.decision_kernel(*fields, mat, wb, is_hdr)
            flipped = int((got != ahd_decision_plain(*fields, mat, wb, is_hdr)).sum())
            log(f"decision kernel vs plain {h}x{w} hdr={is_hdr} (random fields): {flipped} of "
                f"{h * w} picks differ")
            if flipped > 1:
                raise AssertionError("decision kernel differs from plain on a tiny frame")


def pick_flips(frame: RawFrame) -> float:
    """Share of the decision kernel's picks on the frame's six candidate fields
    that differ from the plain chain's."""
    mat = cam_to_lin_srgb_matrix(frame.cam_mat, frame.cam_white)
    wb = frame.wb_reciprocal()
    fields = [f.contiguous() for f in ahd_candidates(frame.bayer, wb)]
    got = K.decision_kernel(*fields, mat, wb, frame.is_hdr)
    want = ahd_decision_plain(*fields, mat, wb, frame.is_hdr)
    if not bool(((got == 0) | (got == 1)).all()):
        raise AssertionError("the decision kernel's picks are not 0 or 1")
    return float((got != want).float().mean())



def scene_on_card(h: int, w: int, channels: int, seed: int) -> torch.Tensor:
    """A structured scene in [0.05, 0.95]: (H, W) or (H, W, 3) on the card."""
    img = make_scene(h, w, seed=seed) * 0.9 + 0.05
    img = img[..., 1] if channels == 1 else img
    return torch.from_numpy(np.ascontiguousarray(img, np.float32)).to(DEVICE)


def warp_maps(h: int, w: int, n: int):
    """n clipped lens-warp tables (n, H, W) on the card, beyond the bounds used
    above so that the bounded remap clips displacements."""
    xs, ys = [], []
    for k in range(n):
        co = (1.0, -0.02 + 0.006 * k, 0.002, 0.0, 0.001, -0.001)
        mx, my = compute_remapping_table(co, w, h, (0.45, 0.55), device=DEVICE)
        xs.append(mx.clamp(0, w - 1))
        ys.append(my.clamp(0, h - 1))
    return torch.stack(xs), torch.stack(ys)


def synthetic_dng(h: int, w: int, seed: int, bggr: bool, **tags) -> bytes:
    """A structured scene as a u16 DNG in about [200, 4000]. A BGGR file holds
    the 180-degree rotation of an RGGB mosaic of the rotated scene, so that it
    develops to the scene in its own orientation."""
    rgb = make_scene(h, w, seed=seed)
    if bggr:
        mosaic = np.rot90(mosaic_rggb(np.ascontiguousarray(np.rot90(rgb, 2))), 2)
    else:
        mosaic = mosaic_rggb(rgb)
    u16 = np.ascontiguousarray(200 + mosaic * 3800).astype(np.uint16)
    pattern = (2, 1, 1, 0) if bggr else (0, 1, 1, 2)
    return write_synthetic_dng(u16, cfa_pattern=pattern, **tags)


def main_path(tmp: str):
    """Phase 3, develop: file -> develop -> file on the card; returns the
    launch counts and the 24 MP frame."""
    paths = {}
    for name, (h, w, bggr) in {"rggb": (FULL_H, FULL_W, False),
                               "bggr": (BGGR_H, BGGR_W, True)}.items():
        paths[name] = os.path.join(tmp, f"{name}.dng")
        with open(paths[name], "wb") as fh:
            fh.write(synthetic_dng(h, w, seed=7, bggr=bggr))

    cfg = DevelopConfig(quality=QualityDemosaic.Best)
    zero_launch_counts()
    results = {}
    t0 = time.perf_counter()
    for name, path in paths.items():
        frame = load_raw(path)
        out = develop(frame, cfg)
        save_image(os.path.join(tmp, f"{name}.tif"), out)
        results[name] = (frame, out)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = launch_counts()
    log(f"develop path (2 DNGs, load_raw -> develop Best -> save_image): "
        f"{seconds:.3f} s host clock, kernel launches {launches}")
    if results["rggb"][0].bayer.device.type != DEVICE:
        raise AssertionError("load_raw did not put the frame on the card")
    expect_launches("develop", launches, ahd=2)

    plain_cfg = DevelopConfig(quality=QualityDemosaic.Best, use_pallas=False)
    for name, (frame, out) in results.items():
        h, w = frame.height, frame.width
        if tuple(out.shape) != (h, w, 3) or out.dtype != torch.float32:
            raise AssertionError(f"{name}: output {tuple(out.shape)} {out.dtype}")
        if not bool(torch.isfinite(out).all()):
            raise AssertionError(f"{name}: non-finite output")
        lo, hi = out.min().item(), out.max().item()
        if lo < 0.0 or hi > 1.0:
            raise AssertionError(f"{name}: output outside [0, 1]: [{lo}, {hi}]")
        tif = os.path.join(tmp, f"{name}.tif")
        if os.path.getsize(tif) < h * w * 6:
            raise AssertionError(f"{name}: {tif} is too short")
        log(f"{name} {h}x{w}: range [{lo:.4f}, {hi:.4f}]")
        develop_stats(f"{name} {h}x{w} develop", out, develop(frame, plain_cfg),
                      MIN_PSNR_FULL if h == FULL_H else MIN_PSNR)
    return launches, results["rggb"][0]


def sharpen_stages(deconv: torch.Tensor) -> torch.Tensor:
    """After the deconvolution: Oklab unsharp, clip and sRGB gamma."""
    out = unsharp_mask_lab(deconv, UNSHARP[0], UNSHARP[1])
    return lin_srgb_to_srgb(torch.clamp(out, 0.0, 1.0))


def filter_stages(lin: torch.Tensor) -> torch.Tensor:
    """The filters after develop: RL luma deconvolution (the RL kernel), Oklab
    unsharp, clip and sRGB gamma."""
    return sharpen_stages(gaussian_rt_deconvolution_yuv(lin, DECONV[0], DECONV[1]))


def finish_stages(lin: torch.Tensor, block: bytes) -> torch.Tensor:
    """The filters, then the OpcodeList3 lens warp (Lanczos4, the remap kernel)."""
    return apply_opcode_3_warp(filter_stages(lin), block)


def finish_stages_plain(lin: torch.Tensor) -> torch.Tensor:
    """The same stages with the kernels' plain versions in their place: RL on
    the linear luma and its gain on RGB, then the lens warp's shared, clipped
    table and bounds through the remap kernel's plain version."""
    y = 0.299 * lin[..., 0] + 0.587 * lin[..., 1] + 0.114 * lin[..., 2]
    y_mod = K.rl_plain(y, get_1d_gaussian_filter(DECONV[0]), DECONV[1])
    srgb = sharpen_stages(lin * (y_mod / y)[..., None])
    h, w = srgb.shape[0], srgb.shape[1]
    mx, my = compute_remapping_table(WARP_COEFFS, w, h, WARP_CENTER, device=srgb.device)
    bounds = displacement_bounds(WARP_COEFFS, w, h, WARP_CENTER)
    return K.remap_plain(srgb, mx.clamp(0, w - 1), my.clamp(0, h - 1), "lanczos4", bounds,
                         channels_last=True)


def lanczos4_overshoot() -> float:
    """How far a Lanczos4 remap of an image in [0, 1] can leave [0, 1]: with
    separable weights that sum to 1 and absolute sum S per axis, (S^2 - 1) / 2,
    S taken at its largest over the fractional phase."""
    from pysp_tpu_torch.ops.resample import _lanczos4_weights

    frac = torch.linspace(0.0, 1.0, 4097)[:-1]
    s = _lanczos4_weights(frac).abs().sum(dim=-1).max().item()
    return (s * s - 1.0) / 2.0


def finishing_path(tmp: str):
    """Phase 3, finishing: DNG with a lens warp -> develop -> filters -> warp
    -> TIFF on the card, then the same through the CLI. Returns the launch
    counts, the developed linear image and the warp block."""
    path = os.path.join(tmp, "lens.dng")
    block = encode_warp_rectilinear([WARP_COEFFS] * 3, WARP_CENTER)
    with open(path, "wb") as fh:
        fh.write(synthetic_dng(FULL_H, FULL_W, seed=11, bggr=False, opcode_list_3=block))
    bounds = displacement_bounds(WARP_COEFFS, FULL_W, FULL_H, WARP_CENTER)
    if bounds is None:
        raise AssertionError("the lens warp has no displacement bounds")
    log(f"lens warp {WARP_COEFFS} at {FULL_H}x{FULL_W}: displacement bounds {bounds}")

    tif = os.path.join(tmp, "lens.tif")
    zero_launch_counts()
    t0 = time.perf_counter()
    lin = develop(load_raw(path), DevelopConfig(gamma_encode=False))
    srgb = filter_stages(lin)
    out = apply_opcode_3_warp(srgb, get_opcode_3_block(path))
    save_image(tif, out)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = launch_counts()
    log(f"finishing path (load_raw -> develop, gamma off -> deconv {DECONV} -> unsharp "
        f"{UNSHARP} -> gamma -> lens warp -> save_image): {seconds:.3f} s host clock, "
        f"kernel launches {launches}")
    expect_launches("finishing", launches, ahd=1, rl=DECONV[1], remap=1)

    if tuple(out.shape) != (FULL_H, FULL_W, 3) or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"finished image {tuple(out.shape)} is not finite (H, W, 3)")
    # The filters end in [0, 1]; the Lanczos4 warp rings past it by at most its
    # overshoot (as in the JAX package), and the TIFF writer clips.
    if srgb.min().item() < 0.0 or srgb.max().item() > 1.0:
        raise AssertionError("the filtered image before the warp is outside [0, 1]")
    lo, hi = out.min().item(), out.max().item()
    ring = lanczos4_overshoot()
    log(f"finished image range [{lo:.4f}, {hi:.4f}]; before the warp within [0, 1]; "
        f"Lanczos4 overshoot bound {ring:.4f}")
    if lo < -ring or hi > 1.0 + ring:
        raise AssertionError(f"finished image outside [-{ring}, 1 + {ring}]: [{lo}, {hi}]")
    if os.path.getsize(tif) < FULL_H * FULL_W * 6:
        raise AssertionError(f"{tif} is too short")
    want = finish_stages_plain(lin)
    p, flips, err = interior_stats(out, want)
    log(f"finishing stages, kernels vs plain on the card from the same developed image: "
        f"max abs {err:.3g}, PSNR {p:.2f} dB")
    if err > FINISH_ATOL:
        raise AssertionError(f"finishing stages differ from plain by {err} > {FINISH_ATOL}")
    del want, out

    cli_tif = os.path.join(tmp, "lens_cli.tif")
    cmd = [sys.executable, "-m", "pysp_tpu_torch", "develop", path, "-o", cli_tif,
           "--deconv", f"{DECONV[0]}:{DECONV[1]}", "--unsharp", f"{UNSHARP[1]}:{UNSHARP[0]}",
           "--warp"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600, cwd=REPO)
    if proc.returncode != 0:
        raise AssertionError(f"the CLI failed ({proc.returncode}):\n{proc.stderr}")
    with open(tif, "rb") as a, open(cli_tif, "rb") as b:
        same = a.read() == b.read()
    log(f"CLI {' '.join(cmd[3:])}: {time.perf_counter() - t0:.3f} s host clock "
        f"(a new process: start-up, load and develop included); "
        f"{proc.stdout.strip()}; TIFF identical to the in-process one: {same}")
    if not same:
        raise AssertionError("the CLI's TIFF differs from the in-process path's")
    return launches, lin, srgb, block


# --- the corrections path: BASELINE configs 3 and 4 ---------------------------------

# The in-plane index of a mosaic site's CFA phase (row parity, column parity):
# planes are (R, G1, B, G2).
_PLANE_OF = {(0, 0): 0, (0, 1): 1, (1, 1): 2, (1, 0): 3}


def plant_hot_sites(mosaic: np.ndarray):
    """Mosaic sites to set to full scale where the scene is dark (< 0.25):
    100 singles and 100 2x2 mosaic clusters (one site in each plane), on a
    16-px grid so that no two lie within 8 sites of each other in a plane;
    at most 200 sites per plane, under the detector's 1e-4 quantile share of
    each plane's 6 M sites. Returns an (n, 2) array of (y, x)."""
    h, w = mosaic.shape
    rng = np.random.default_rng(21)
    grid = [(y, x) for y in range(16, h - 16, 16) for x in range(16, w - 16, 16)]
    singles, clusters = [], []
    for i in rng.permutation(len(grid)):
        y, x = grid[i]
        quad = mosaic[y:y + 2, x:x + 2]
        if len(clusters) < 400 and quad.max() < 0.25:
            clusters += [(y, x), (y, x + 1), (y + 1, x), (y + 1, x + 1)]
        elif len(singles) < 100 and quad.min() < 0.25:
            dy, dx = np.unravel_index(int(np.argmin(quad)), (2, 2))
            singles.append((y + int(dy), x + int(dx)))
        if len(singles) == 100 and len(clusters) == 400:
            break
    if len(singles) < 100 or len(clusters) < 400:
        raise AssertionError(f"only {len(singles)} singles and {len(clusters) // 4} "
                             f"clusters found dark sites")
    return np.array(singles + clusters)


def flat_u16(h: int, w: int) -> np.ndarray:
    """A smooth vignetting flat: 1.0 in the centre to 0.6 in the corners, as
    u16 in the DNG's [256, 4095] range."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    r2 = ((yy - h / 2) / (h / 2)) ** 2 + ((xx - w / 2) / (w / 2)) ** 2
    flat = 1.0 - 0.4 * r2 / 2.0
    return np.round(256 + flat * 3839).astype(np.uint16)


def heal_frame_plain(frame: RawFrame, masks: torch.Tensor) -> RawFrame:
    healed = K.heal_plain(bayer_to_planes(frame.bayer), masks, CFG3.hot_pixel_iterations)
    return frame.replace(bayer=planes_to_bayer(healed))


@contextlib.contextmanager
def plain_multisection():
    """The detector with the multisection kernel's gate closed: its plain
    passes on the same CUDA planes."""
    saved = K.multisection_kernel_admits
    K.multisection_kernel_admits = lambda *a: False
    try:
        yield
    finally:
        K.multisection_kernel_admits = saved


def detect_plain(frame: RawFrame) -> torch.Tensor:
    with plain_multisection():
        return find_erroneous_pixels_median(frame)


def corrections_plain(frames: RawFrame, flat: RawFrame | None = None):
    """develop_pipeline of config 3 (a frame and its flat) or config 4 (a burst)
    composed from the plain versions on the card: the detector's plain passes
    (``multisection_plain``), ``heal_plain`` for the heal,
    ``DevelopConfig(use_pallas=False)`` for the develop. Returns the image and
    the frame it developed."""
    plain = DevelopConfig(quality=QualityDemosaic.Best, use_pallas=False)
    if flat is not None:
        frame = flat_frame_correction(frames, flat)
        frame = heal_frame_plain(frame, detect_plain(frame))
        return develop(frame, plain), frame
    burst = unstack_frames(frames)
    need = float(np.ceil(np.float32(len(burst) * CFG4.hot_pixel_shared_ratio)))
    shared = sum(detect_plain(f).to(torch.int32) for f in burst) >= need
    healed = stack_frames([heal_frame_plain(f, shared) for f in burst], device=DEVICE)
    fused, _ = fuse_exposures_to_raw(healed)
    return develop(fused, plain), fused


def check_image(name: str, out: torch.Tensor, h: int, w: int) -> None:
    if tuple(out.shape) != (h, w, 3) or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"{name}: output {tuple(out.shape)} is not a finite (H, W, 3)")
    lo, hi = out.min().item(), out.max().item()
    if lo < 0.0 or hi > 1.0:
        raise AssertionError(f"{name}: output outside [0, 1]: [{lo}, {hi}]")


def run_cli(args, tif: str, cli_tif: str) -> None:
    cmd = [sys.executable, "-m", "pysp_tpu_torch", "develop", *args, "-o", cli_tif]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600, cwd=REPO)
    if proc.returncode != 0:
        raise AssertionError(f"the CLI failed ({proc.returncode}):\n{proc.stderr}")
    with open(tif, "rb") as a, open(cli_tif, "rb") as b:
        same = a.read() == b.read()
    log(f"CLI develop {' '.join(os.path.basename(a) for a in args)}: "
        f"{time.perf_counter() - t0:.3f} s host clock (a new process); "
        f"{proc.stdout.strip()}; TIFF identical to the in-process one: {same}")
    if not same:
        raise AssertionError("the CLI's TIFF differs from the in-process path's")


def corrections_path(tmp: str):
    """Phase 3, corrections: configs 3 and 4 file -> develop_pipeline -> file on
    the card, then both through the CLI. Returns the launch counts and what
    phase 4 measures at these shapes."""
    scene = mosaic_rggb(make_scene(FULL_H, FULL_W, seed=13))
    hot = plant_hot_sites(scene)
    ys, xs = hot[:, 0], hot[:, 1]
    paths = {"shot": os.path.join(tmp, "shot.dng"), "flat": os.path.join(tmp, "flat.dng")}
    u16 = (200 + scene * 3800).astype(np.uint16)
    u16[ys, xs] = 4095
    with open(paths["shot"], "wb") as fh:
        fh.write(write_synthetic_dng(u16))
    with open(paths["flat"], "wb") as fh:
        fh.write(write_synthetic_dng(flat_u16(FULL_H, FULL_W)))
    brackets = []
    for k in range(BRACKETS):
        u16 = (200 + np.clip(scene * 2.0 ** (k - 2), 0.0, 1.0) * 3800).astype(np.uint16)
        u16[ys, xs] = 4095
        brackets.append(os.path.join(tmp, f"b{k}.dng"))
        with open(brackets[-1], "wb") as fh:
            fh.write(write_synthetic_dng(u16, exposure_time=(1, 400 // 2 ** k)))
    del u16
    per_plane = np.bincount([_PLANE_OF[(int(y) % 2, int(x) % 2)] for y, x in hot], minlength=4)
    log(f"corrections inputs: {len(hot)} hot photosites planted (R, G1, B, G2 planes: "
        f"{per_plane.tolist()}) in a {FULL_H}x{FULL_W} scene, a flat 1.0 -> 0.6, "
        f"{BRACKETS} brackets 1/400 .. 1/{400 // 2 ** (BRACKETS - 1)} s")

    tifs = {"config3": os.path.join(tmp, "config3.tif"), "config4": os.path.join(tmp, "config4.tif")}
    zero_launch_counts()
    t0 = time.perf_counter()
    frame, flat = load_raw(paths["shot"]), load_raw(paths["flat"])
    out3 = develop_pipeline(frame, CFG3, flat=flat)
    save_image(tifs["config3"], out3)
    torch.cuda.synchronize()
    t3 = time.perf_counter() - t0
    t0 = time.perf_counter()
    burst = stack_frames([load_raw(p) for p in brackets])
    out4 = develop_pipeline(burst, CFG4)
    save_image(tifs["config4"], out4)
    torch.cuda.synchronize()
    t4 = time.perf_counter() - t0
    launches = launch_counts()
    log(f"corrections path: config 3 (load_raw x2 -> develop_pipeline(flat, heal) -> "
        f"save_image) {t3:.3f} s, config 4 (load_raw x{BRACKETS} -> stack_frames -> "
        f"develop_pipeline(consensus heal, fuse) -> save_image) {t4:.3f} s host clock; "
        f"kernel launches {launches}")
    if frame.bayer.device.type != DEVICE or burst.bayer.device.type != DEVICE:
        raise AssertionError("load_raw / stack_frames did not put the frames on the card")
    expect_launches("corrections", launches, heal=1 + BRACKETS, ahd=2,
                    multisection=DETECT_PASSES * (1 + BRACKETS))
    evs = [round(v, 4) for v in burst.ev.tolist()]
    log(f"bracket EVs {evs}")

    # Config 3: every planted site flagged and healed into its neighbours' range.
    corrected = flat_frame_correction(frame, flat)
    masks = find_erroneous_pixels_median(corrected)
    planes = bayer_to_planes(repair_bad_pixels(corrected, masks).bayer)
    pl = torch.tensor([_PLANE_OF[(int(y) % 2, int(x) % 2)] for y, x in hot], device=DEVICE)
    py = torch.from_numpy(ys // 2).to(DEVICE)
    px = torch.from_numpy(xs // 2).to(DEVICE)
    flagged = masks[pl, py, px]
    h2, w2 = planes.shape[-2:]
    nb = torch.stack([planes[pl, (py - 1).clamp(0, h2 - 1), px],
                      planes[pl, (py + 1).clamp(0, h2 - 1), px],
                      planes[pl, py, (px - 1).clamp(0, w2 - 1)],
                      planes[pl, py, (px + 1).clamp(0, w2 - 1)]])
    healed = planes[pl, py, px]
    inside = (healed >= nb.amin(dim=0)) & (healed <= nb.amax(dim=0))
    log(f"config 3: {int(masks.sum())} sites flagged ({int(flagged.sum())} of the "
        f"{len(hot)} planted); healed planted sites within their 4-neighbours' range: "
        f"{int(inside.sum())} of {len(hot)}")
    if not bool(flagged.all()):
        raise AssertionError("a planted hot photosite was not flagged")
    if not bool(inside.all()):
        raise AssertionError("a healed site lies outside its 4-neighbours' range")
    del planes, nb

    check_image("config 3", out3, FULL_H, FULL_W)
    check_image("config 4", out4, FULL_H, FULL_W)
    want3, _ = corrections_plain(frame, flat)
    develop_stats(f"config 3 {FULL_H}x{FULL_W}", out3, want3, MIN_PSNR)
    del want3
    want4, fused = corrections_plain(burst)
    develop_stats(f"config 4 {BRACKETS}x{FULL_H}x{FULL_W}", out4, want4, MIN_PSNR)
    del want4
    log(f"config 4: fused frame is_hdr {fused.is_hdr}, lim_sat {fused.lim_sat.item():.4f}, "
        f"ev {fused.ev.item():.4f}")
    if not fused.is_hdr or fused.lim_sat.item() <= 1.0:
        raise AssertionError("the fused frame is not an HDR frame with lim_sat > 1")
    del out3, out4, fused

    run_cli([paths["shot"], "--flat", paths["flat"], "--repair-hot-pixels"],
            tifs["config3"], os.path.join(tmp, "config3_cli.tif"))
    run_cli([*brackets, "--hdr", "--repair-hot-pixels"],
            tifs["config4"], os.path.join(tmp, "config4_cli.tif"))
    return launches, frame, flat, burst, corrected, masks


def corrections_at_main_shapes(frame, flat, burst, corrected, masks):
    """Phase 4 for the corrections path: the heal kernel against its plain
    version on the config 3 planes and masks, times, the bound and the
    pipelines' device busy share. Returns the heal record."""
    planes = bayer_to_planes(corrected.bayer)
    fill, smooth = CFG3.hot_pixel_iterations, 2
    got = K.heal_kernel(planes, masks, fill, smooth)
    want = K.heal_plain(planes, masks, fill, smooth)
    err = (got - want).abs().max().item()
    log(f"heal kernel vs plain at 4x{planes.shape[1]}x{planes.shape[2]} with the "
        f"detector's {int(masks.sum())} sites: bit-exact {torch.equal(got, want)}, "
        f"max abs err {err:.3g}")
    if not torch.equal(got, want):
        raise AssertionError("heal kernel at 24 MP differs from plain")
    # A dense mask: most of the kernel's 16x16 sub-tiles hold a site.
    g = torch.Generator(device=DEVICE).manual_seed(5)
    dense = torch.rand(planes.shape, generator=g, device=DEVICE) < HEAL_DENSITY
    same = torch.equal(K.heal_kernel(planes, dense, fill, smooth),
                       K.heal_plain(planes, dense, fill, smooth))
    log(f"heal kernel vs plain at 4x{planes.shape[1]}x{planes.shape[2]} with a random mask at "
        f"density {HEAL_DENSITY:g} ({int(dense.sum())} sites): bit-exact {same}")
    if not same:
        raise AssertionError("heal kernel at 24 MP and a dense mask differs from plain")
    del got, want
    means = planes.mean(dim=(-2, -1)).contiguous()
    buf = torch.empty_like(planes)

    t = {
        "heal": median_ms(lambda: K.heal_kernel(planes, masks, fill, smooth)),
        "heal_mean": median_ms(lambda: planes.mean(dim=(-2, -1))),
        "heal_launch": median_ms(lambda: heal_launch(planes, masks, means, buf, fill, smooth)),
        "heal_dense": median_ms(lambda: K.heal_kernel(planes, dense, fill, smooth)),
        "heal_dense_launch": median_ms(
            lambda: heal_launch(planes, dense, means, buf, fill, smooth)),
        "heal_plain": median_ms(lambda: K.heal_plain(planes, masks, fill, smooth)),
        "config3": median_ms(lambda: develop_pipeline(frame, CFG3, flat=flat)),
        "config3_plain": median_ms(lambda: corrections_plain(frame, flat), runs=3, warmup=1),
        "config4": median_ms(lambda: develop_pipeline(burst, CFG4)),
        "config4_plain": median_ms(lambda: corrections_plain(burst), runs=3, warmup=1),
    }
    mp = FULL_H * FULL_W / 1e6
    log(f"corrections times by CUDA events, median of 10 (plain pipelines: median of "
        f"3): " + ", ".join(f"{k} {v:.3f} ms" for k, v in t.items()))
    log(f"heal_kernel at 4x{planes.shape[1]}x{planes.shape[2]}, {fill} + {smooth} sweeps: the "
        f"whole call {t['heal']:.4f} ms with the detector's {int(masks.sum())} sites = "
        f"torch.mean (the seeds) {t['heal_mean']:.4f} ms + the kernel's launch "
        f"{t['heal_launch']:.4f} ms + {t['heal'] - t['heal_mean'] - t['heal_launch']:.4f} ms "
        f"of the wrapper's host time; at density {HEAL_DENSITY:g} the whole call "
        f"{t['heal_dense']:.4f} ms, the launch {t['heal_dense_launch']:.4f} ms")
    del dense, buf
    log(f"config 3 {mp / (t['config3'] / 1e3):.2f} MP/s with the kernels, "
        f"{mp / (t['config3_plain'] / 1e3):.2f} MP/s plain; config 4 "
        f"{BRACKETS * mp / (t['config4'] / 1e3):.2f} input MP/s with the kernels, "
        f"{BRACKETS * mp / (t['config4_plain'] / 1e3):.2f} plain")
    # Where the pipelines' time goes, stage by stage (with the kernels).
    frames = unstack_frames(burst)
    need = float(np.ceil(np.float32(BRACKETS * CFG4.hot_pixel_shared_ratio)))
    shared = sum(find_erroneous_pixels_median(f).to(torch.int32) for f in frames) >= need
    healed = stack_frames([repair_bad_pixels(f, shared) for f in frames], device=DEVICE)
    fused, _ = fuse_exposures_to_raw(healed)
    cfg = CFG3.develop
    stage_ms = {
        "flat_field": median_ms(lambda: flat_frame_correction(frame, flat)),
        "detect": median_ms(lambda: find_erroneous_pixels_median(corrected)),
        "repair": median_ms(lambda: repair_bad_pixels(corrected, masks)),
        "develop": median_ms(lambda: develop(corrected, cfg)),
        "detect_x5": median_ms(lambda: [find_erroneous_pixels_median(f) for f in frames]),
        "repair_x5": median_ms(lambda: [repair_bad_pixels(f, shared) for f in frames]),
        "stack": median_ms(lambda: stack_frames(frames, device=DEVICE)),
        "fuse": median_ms(lambda: fuse_exposures_to_raw(healed)),
        "develop_hdr": median_ms(lambda: develop(fused, cfg)),
    }
    log("corrections stages one by one, median of 10 by CUDA events (config 3: flat_field "
        ".. develop; config 4: detect_x5 .. develop_hdr): "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in stage_ms.items()))
    del frames, healed, fused
    for name, fn in (("config 3 pipeline", lambda: develop_pipeline(frame, CFG3, flat=flat)),
                     ("config 4 pipeline", lambda: develop_pipeline(burst, CFG4))):
        host_ms, device_ms, n = device_busy(fn)
        log(f"{name} under torch.profiler, 3 runs: {host_ms:.3f} ms host clock per run, "
            f"{device_ms:.3f} ms of device kernels ({n:.0f} kernels) per run, device "
            f"idle {max(0.0, 1 - device_ms / host_ms):.1%} of the host time")

    # Bound: the planes (4 B) and mask (1 B) read once, the result (4 B) written
    # once, against the plain fill's float32 operations on these inputs.
    nbytes = planes.numel() * (4 + 1 + 4)
    ops = float_ops(lambda: K.heal_plain(planes, masks, fill, smooth))
    b = bound(nbytes, ops)
    log(f"heal bound (NVIDIA H100 SXM, 3.35 TB/s, 67 TFLOP/s float32): {nbytes / 1e6:.1f} "
        f"MB, {ops / 1e9:.2f} G ops ({ops / planes.numel():.1f} per site) -> "
        f"{b[0]:.4f} ms by {b[1]}; the kernel at {t['heal'] / b[0]:.2f}x its bound")
    return {"name": "heal", "route": "cuda", "source": "pysp_tpu_torch/csrc/heal.cu",
            "replaces": "pysp_tpu/ops/pallas_kernels.py:853", "counter": "heal",
            "max_abs_err": err, "ms": t["heal"], "plain_ms": t["heal_plain"],
            "bound_ms": b[0], "bound_by": b[1], "library_ms": None,
            "mean_ms": t["heal_mean"], "launch_ms": t["heal_launch"],
            "dense_ms": t["heal_dense"], "dense_launch_ms": t["heal_dense_launch"]}


def multisection_at_main_shapes(corrected: RawFrame) -> dict:
    """Phase 4 for the hot-pixel detector's multisection kernel on config 3's
    delta planes: the wrapper's four passes against ``multisection_plain``,
    a counting pass against its bound and a plain pass, and the four passes
    of one wrapper call against the plain four. Returns its record."""
    planes = bayer_to_planes(corrected.bayer)
    delta = torch.abs(planes - median2(planes))
    delta = torch.abs(delta - delta.mean(dim=(-2, -1), keepdim=True))
    del planes
    p, h, w = delta.shape
    lo, hi = delta.amin(dim=(-2, -1)), delta.amax(dim=(-2, -1))
    target = float(np.float32(CFG3.hot_pixel_quantile * (h * w - 1)))
    got = K.multisection_kernel(delta, lo, hi, target)
    want = multisection_plain(delta, lo, hi, target)
    same = all(torch.equal(a, b) for a, b in zip(got, want))
    err = max((a - b).abs().max().item() for a, b in zip(got, want))
    log(f"multisection kernel vs multisection_plain at {p}x{h}x{w}, config 3's delta planes "
        f"(quantile {CFG3.hot_pixel_quantile:g}): the last bracket bit-exact {same}, max abs "
        f"err {err:.3g}")
    if not same:
        raise AssertionError("the multisection kernel at 24 MP differs from plain")
    bracket = torch.stack([lo, hi])
    counts = torch.zeros(p * 16 + 1, dtype=torch.int32, device=DEVICE)

    def passes():
        for _ in range(MULTISECTION_B2B):
            multisection_launch(delta, bracket, counts, target)

    t = {"pass": median_ms(passes) / MULTISECTION_B2B,
         "plain_pass": median_ms(lambda: multisection_plain(delta, lo, hi, target, 1), runs=3,
                                 warmup=1),
         "call": median_ms(lambda: K.multisection_kernel(delta, lo, hi, target)),
         "plain_call": median_ms(lambda: multisection_plain(delta, lo, hi, target), runs=3,
                                 warmup=1)}
    b = bound(delta.numel() * 4, 0.0)
    log(f"multisection kernel at {p}x{h}x{w}: a counting pass {t['pass']:.4f} ms "
        f"({MULTISECTION_B2B} launches back to back, per launch), {t['pass'] / b[0]:.2f}x its "
        f"bound of {b[0]:.4f} ms by bytes ({delta.numel() * 4 / 1e6:.0f} MB); a plain pass "
        f"{t['plain_pass']:.3f} ms; the four passes of one wrapper call {t['call']:.4f} ms, "
        f"plain {t['plain_call']:.3f} ms (CUDA events; plain median of 3 after 1)")
    return {"name": "multisection", "route": "cuda",
            "source": "pysp_tpu_torch/csrc/multisection.cu",
            "replaces": "pysp_tpu_torch/correct/bad_pixels.py::multisection_plain",
            "counter": "multisection", "max_abs_err": err, "ms": t["pass"],
            "plain_ms": t["plain_pass"], "bound_ms": b[0], "bound_by": b[1],
            "library_ms": None, "call_ms": t["call"], "plain_call_ms": t["plain_call"]}


# Counting launches timed back to back for one pass's time.
MULTISECTION_B2B = 20


def multisection_launch(delta, bracket, counts, target: float) -> None:
    """One counting pass of the multisection kernel alone, no narrowing (phase
    4 times it apart; this launch counts nowhere)."""
    p, h, w = delta.shape
    err = K.load_library().pysp_multisection(
        delta.data_ptr(), p, h * w, delta.stride(0), bracket.data_ptr(), counts.data_ptr(),
        counts[p * 16:].data_ptr(), 16, target, 0, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"multisection launch failed: cudaError {err}")


def heal_launch(planes, masks, means, out, fill: int, smooth: int) -> None:
    """The heal kernel's launch alone, on seeds computed beforehand (phase 4
    times the wrapper's parts apart; this launch counts nowhere)."""
    _, h, w = planes.shape
    err = K.load_library().pysp_heal(
        planes.data_ptr(), masks.data_ptr(), means.data_ptr(), out.data_ptr(), h, w, fill,
        smooth, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"heal launch failed: cudaError {err}")


# --- the tiers path: the demosaic layer outside the AHD kernel's route ----------------

STAGED_CFG = DevelopConfig(quality=QualityDemosaic.Best, postprocess_stages=STAGED_STAGES)
STAGED_PLAIN_CFG = DevelopConfig(quality=QualityDemosaic.Best,
                                 postprocess_stages=STAGED_STAGES, use_pallas=False)
FAST_CFG = DevelopConfig(quality=QualityDemosaic.Fast)
DRAFT_CFG = DevelopConfig(quality=QualityDemosaic.Draft)


CONFIG2_KELVIN = 5000.0            # BASELINE config 2: WB from a colour temperature


def frame_at_temperature(path: str, frame: RawFrame, kelvin: float) -> RawFrame:
    """The frame rebuilt with the WB solved for ``kelvin``, as the CLI's
    ``--temperature`` does: the source's controller, updated with the cross
    blend, then ``frame_from_parts`` of the un-canonicalized mosaic."""
    ctrl = controller_for_source(path, frame)
    ctrl.update_by_temperature(kelvin, allow_cross_blend=True)
    sensor = reversible_transform_rggb(frame.bayer, frame.source_pattern).cpu().numpy()
    return frame_from_parts(sensor, frame.source_pattern, ctrl, float(frame.ev))


def tiers_path(tmp: str):
    """Phase 3, tiers: the develop path's two DNGs through ``load_raw ->
    develop -> save_image`` at Best with three stages (the staged AHD route),
    Fast and Draft, the median5 and decision kernels on the staged route's
    demosaic and candidates, and Fast through the CLI. Returns the launch
    counts and what phase 4 measures at these shapes."""
    paths = {name: os.path.join(tmp, f"{name}.dng") for name in ("rggb", "bggr")}
    tifs = {name: os.path.join(tmp, f"tiers_{name}.tif")
            for name in ("staged", "fast", "draft", "bggr_fast", "config2")}
    zero_launch_counts()
    t0 = time.perf_counter()
    frame = load_raw(paths["rggb"])
    outs = {}
    for name, cfg in (("staged", STAGED_CFG), ("fast", FAST_CFG), ("draft", DRAFT_CFG)):
        outs[name] = develop(frame, cfg)
        save_image(tifs[name], outs[name])
    bggr = load_raw(paths["bggr"])
    outs["bggr_fast"] = develop(bggr, FAST_CFG)
    save_image(tifs["bggr_fast"], outs["bggr_fast"])
    # BASELINE config 2: Fast with the WB solved for a colour temperature.
    warm = frame_at_temperature(paths["rggb"], frame, CONFIG2_KELVIN)
    outs["config2"] = develop(warm, FAST_CFG)
    save_image(tifs["config2"], outs["config2"])
    # The two kernels that no develop calls (as in the JAX package), through
    # their entry points at the staged route's own shapes.
    demosaiced = develop_to_image(frame, STAGED_CFG).image
    chroma = (demosaiced[..., 0] - demosaiced[..., 1]).contiguous()
    chroma_median = K.median5_kernel(chroma)
    mat = cam_to_lin_srgb_matrix(frame.cam_mat, frame.cam_white)
    wb = frame.wb_reciprocal()
    fields = [f.contiguous() for f in ahd_candidates(frame.bayer, wb)]
    picks = ahd_decision(*fields, mat, wb, frame.is_hdr)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = launch_counts()
    log(f"tiers path (load_raw -> develop Best {STAGED_STAGES} stages / Fast / Draft -> "
        f"save_image, a BGGR DNG at Fast, develop_to_image -> median5 of R - G, "
        f"ahd_candidates -> ahd_decision): {seconds:.3f} s host clock, kernel launches "
        f"{launches}")
    # Two staged demosaics (develop and develop_to_image), each two counts and
    # STAGED_STAGES chroma stages; no launch of the AHD kernel.
    expect_launches("tiers", launches, homogeneity=4, postprocess=2 * STAGED_STAGES,
                    median5=1, decision=1)

    # (a) The staged route with the kernels is the plain route, bit for bit.
    check_image("staged", outs["staged"], FULL_H, FULL_W)
    same = torch.equal(outs["staged"], develop(frame, STAGED_PLAIN_CFG))
    log(f"staged develop ({STAGED_STAGES} stages) {FULL_H}x{FULL_W}: kernels vs plain on "
        f"the card bit-exact {same}")
    if not same:
        raise AssertionError("the staged develop with the kernels differs from plain")
    # (b) Fast and Draft: plain PyTorch on the card against the same on the CPU.
    for name, f, cfg in (("fast", frame, FAST_CFG), ("draft", frame, DRAFT_CFG),
                         ("bggr_fast", bggr, FAST_CFG), ("config2", warm, FAST_CFG)):
        out = outs[name]
        check_image(name, out, f.height, f.width)
        if os.path.getsize(tifs[name]) < f.height * f.width * 6:
            raise AssertionError(f"{tifs[name]} is too short")
        err = (out.cpu() - develop(f.to("cpu"), cfg)).abs().max().item()
        log(f"{name} {f.height}x{f.width}: develop on the card vs on the CPU max abs "
            f"{err:.3g}; range [{out.min().item():.4f}, {out.max().item():.4f}]")
        if err > TIER_ATOL:
            raise AssertionError(f"{name}: the card differs from the CPU by {err} > {TIER_ATOL}")
    # (c) The median and the picks against their plain versions at 24 MP.
    want = median5(chroma)
    err = {"median5": (chroma_median - want).abs().max().item()}
    same = torch.equal(chroma_median, want)
    log(f"median5 kernel vs plain at {FULL_H}x{FULL_W} (R - G of the staged demosaic): "
        f"bit-exact {same}")
    if not same:
        raise AssertionError("median5 kernel at 24 MP differs from plain")
    want = ahd_decision_plain(*fields, mat, wb, frame.is_hdr)
    err["decision"] = (picks - want).abs().max().item()   # 1.0 where a pick flipped
    err["flipped_picks"] = float((picks != want).float().mean())
    log(f"decision kernel vs plain at {FULL_H}x{FULL_W}: {err['flipped_picks']:.6%} of "
        f"picks differ ({int((picks != want).sum())} pixels); "
        f"{picks.mean().item():.4f} pick horizontal")
    if err["flipped_picks"] > MAX_PICK_FLIPS:
        raise AssertionError("decision kernel at 24 MP outside the flip bound")
    del want, picks, chroma_median, outs
    # (d) Config 2's frame and times, and the CLI.
    rebuild_s = []
    for _ in range(3):
        t0 = time.perf_counter()
        frame_at_temperature(paths["rggb"], frame, CONFIG2_KELVIN)
        torch.cuda.synchronize()
        rebuild_s.append(time.perf_counter() - t0)
    config2_ms = median_ms(lambda: develop(warm, FAST_CFG))
    log(f"config 2 ({CONFIG2_KELVIN:g} K, cross blend): cam_mat "
        f"{np.round(warm.cam_mat.cpu().numpy(), 6).tolist()}, cam_white "
        f"{np.round(warm.cam_white.cpu().numpy(), 6).tolist()}, wb_neutral "
        f"{np.round(warm.wb_neutral.cpu().numpy(), 6).tolist()} (as shot "
        f"{np.round(frame.wb_neutral.cpu().numpy(), 6).tolist()}); controller_for_source -> "
        f"update_by_temperature -> frame_from_parts {statistics.median(rebuild_s):.3f} s "
        f"host clock (median of 3), develop Fast {config2_ms:.3f} ms (CUDA events, median "
        f"of 10)")
    run_cli([paths["rggb"], "--quality", "fast"], tifs["fast"],
            os.path.join(tmp, "tiers_fast_cli.tif"))
    run_cli([paths["rggb"], "--quality", "fast", "--temperature", str(CONFIG2_KELVIN)],
            tifs["config2"], os.path.join(tmp, "tiers_config2_cli.tif"))
    return launches, frame, chroma, fields, err


def tiers_at_main_shapes(frame: RawFrame, chroma: torch.Tensor, fields, err: dict):
    """Phase 4 for the tiers path: the homogeneity kernel against its plain
    version at 24 MP (``err`` holds the path's own comparison of the other
    two), the three kernels' times and bounds, and the three develops with
    their device busy share. Returns the kernels' records."""
    h, w = frame.height, frame.width
    px = h * w
    mat = cam_to_lin_srgb_matrix(frame.cam_mat, frame.cam_white)
    wb = frame.wb_reciprocal()
    hdr = frame.is_hdr
    lab = homogeneity_planes(fields[:3], mat, wb)
    err = dict(err, homogeneity=0.0)
    for vertical in (False, True):
        got = K.homogeneity_kernel(*lab, vertical)
        want = homogeneity_map_channels(*lab, vertical)
        err["homogeneity"] = max(err["homogeneity"], (got - want).abs().max().item())
        log(f"homogeneity kernel vs plain at {h}x{w} vertical={vertical}: bit-exact "
            f"{torch.equal(got, want)}; counts {got.min().item():.0f}..{got.max().item():.0f}")
        if not torch.equal(got, want):
            raise AssertionError("homogeneity kernel at 24 MP differs from plain")
    del got, want

    t = {
        "median5": median_ms(lambda: K.median5_kernel(chroma)),
        "median5_plain": median_ms(lambda: median5(chroma)),
        "homogeneity": median_ms(lambda: K.homogeneity_kernel(*lab, False)),
        "homogeneity_plain": median_ms(lambda: homogeneity_map_channels(*lab, False)),
        "decision": median_ms(lambda: K.decision_kernel(*fields, mat, wb, hdr)),
        "decision_plain": median_ms(lambda: ahd_decision_plain(*fields, mat, wb, hdr)),
        "staged": median_ms(lambda: develop(frame, STAGED_CFG)),
        "staged_plain": median_ms(lambda: develop(frame, STAGED_PLAIN_CFG), runs=3, warmup=1),
        "fast": median_ms(lambda: develop(frame, FAST_CFG)),
        "draft": median_ms(lambda: develop(frame, DRAFT_CFG)),
    }
    mp = px / 1e6
    log(f"tiers times at {h}x{w} by CUDA events, median of 10 (staged_plain: median of "
        f"3): " + ", ".join(f"{k} {v:.3f} ms" for k, v in t.items()))
    log(f"develop Best {STAGED_STAGES} stages (staged route) {mp / (t['staged'] / 1e3):.2f} "
        f"MP/s with the kernels, {mp / (t['staged_plain'] / 1e3):.2f} MP/s plain; Fast "
        f"{mp / (t['fast'] / 1e3):.2f} MP/s; Draft {mp / (t['draft'] / 1e3):.2f} MP/s")
    # Where the staged develop's time goes, stage by stage (with the kernels).
    planes = [p.contiguous() for p in demosaic_ahd_channels(frame, 0)]

    def chroma_stages():
        r, g, b = planes
        for _ in range(STAGED_STAGES):
            r, g, b = K.postprocess_color_kernel(r, g, b)
        return r, g, b

    stage_ms = {
        "candidates": median_ms(lambda: ahd_candidates(frame.bayer, wb)),
        "decision": median_ms(
            lambda: ahd_decision_plain(*fields, mat, wb, hdr, _homogeneity_kernel_count)),
        f"postprocess_x{STAGED_STAGES}": median_ms(chroma_stages),
        "tail": median_ms(lambda: torch.stack(
            color_tail_channels(*planes, mat, True, True), dim=-1)),
    }
    log("staged develop's stages one by one, median of 10 by CUDA events (decision: plain "
        "CIELAB, the homogeneity kernel twice, plain box sums; the pick's blend is not "
        "timed): " + ", ".join(f"{k} {v:.3f} ms" for k, v in stage_ms.items()))
    del planes
    for name, cfg in (("staged develop", STAGED_CFG), ("Fast develop", FAST_CFG),
                      ("Draft develop", DRAFT_CFG)):
        host_ms, device_ms, n = device_busy(lambda: develop(frame, cfg))
        log(f"{name} under torch.profiler, 3 runs: {host_ms:.3f} ms host clock per run, "
            f"{device_ms:.3f} ms of device kernels ({n:.0f} kernels) per run, device "
            f"idle {max(0.0, 1 - device_ms / host_ms):.1%} of the host time")

    # Bounds: every input plane read once (4 B/px each), the result written once.
    nbytes = {"median5": px * (4 + 4), "homogeneity": px * (12 + 4), "decision": px * (24 + 4)}
    ops = {
        "median5": float_ops(lambda: median5(chroma)),
        "homogeneity": float_ops(lambda: homogeneity_map_channels(*lab, False)),
        "decision": float_ops(lambda: ahd_decision_plain(*fields, mat, wb, hdr)),
    }
    b = {k: bound(nbytes[k], ops[k]) for k in ops}
    log("bounds (NVIDIA H100 SXM, 3.35 TB/s, 67 TFLOP/s float32): " + ", ".join(
        f"{k} {nbytes[k] / 1e6:.1f} MB, {ops[k] / 1e9:.2f} G ops ({ops[k] / px:.1f} per px) "
        f"-> {b[k][0]:.4f} ms by {b[k][1]}; the kernel at {t[k] / b[k][0]:.2f}x its bound"
        for k in ops))
    per_pick, parts = decision_pick_instructions(K._library_path())
    floor = per_pick * px / INSTRUCTIONS_PER_S * 1e3
    log(f"decision issue floor (SASS of decision_kernel, tools/sass_count.py): "
        f"{per_pick:.1f} instructions a pick with no halo ({parts}) -> {floor:.4f} ms at "
        f"{INSTRUCTIONS_PER_S / 1e12:g} T instructions/s, beside its byte bound "
        f"{b['decision'][0]:.4f} ms; the kernel at {t['decision'] / floor:.2f}x the floor")
    per_median, loops = median5_sass_minmax(K._library_path())
    med_floor = per_median * px / MINMAX_PER_S * 1e3
    log(f"median5 min/max floor (FMNMX in the SASS of median5_kernel, tools/sass_count.py): "
        f"{per_median:g} min/max a pixel ({loops}; median5_columns.cuh's network at "
        f"the same strip: {median5_minmax_per_pixel():g}) -> {med_floor:.4f} ms at "
        f"{MINMAX_PER_S / 1e12:g} T min/max per s, beside its byte bound "
        f"{b['median5'][0]:.4f} ms; the kernel at {t['median5'] / med_floor:.2f}x the floor")
    # The homogeneity kernel's achieved rate beside torch's own copy of its
    # three input planes (which moves 1.5x the kernel's bytes).
    src = torch.stack(lab)
    dst = torch.empty_like(src)
    copy_ms = median_ms(lambda: dst.copy_(src))
    rate = nbytes["homogeneity"] / (t["homogeneity"] * 1e9)
    copy_rate = 2 * src.numel() * 4 / (copy_ms * 1e9)
    log(f"homogeneity kernel {rate:.3f} TB/s ({nbytes['homogeneity'] / 1e6:.1f} MB in "
        f"{t['homogeneity']:.4f} ms); torch's copy of its three input planes {copy_rate:.3f} "
        f"TB/s ({2 * src.numel() * 4 / 1e6:.1f} MB in {copy_ms:.4f} ms)")
    del src, dst
    records = [
        {"name": name, "route": "cuda", "source": f"pysp_tpu_torch/csrc/{source}",
         "replaces": f"pysp_tpu/ops/pallas_kernels.py:{line}", "counter": key,
         "max_abs_err": err[key], "ms": t[key], "plain_ms": t[f"{key}_plain"],
         "bound_ms": b[key][0], "bound_by": b[key][1], "library_ms": None}
        for name, key, source, line in (
            ("median5", "median5", "median5.cu", 90),
            ("homogeneity_map", "homogeneity", "homogeneity.cu", 193),
            ("ahd_decision", "decision", "decision.cu", 537),
        )
    ]
    # The share of picks behind a max_abs_err of 1.0.
    records[-1]["flipped_picks"] = err["flipped_picks"]
    records[-1]["issue_floor_ms"] = floor
    records[-1]["instructions_per_pick"] = per_pick
    records[0]["issue_floor_ms"] = med_floor
    records[0]["minmax_per_pixel"] = per_median
    records[1]["tb_s"] = rate
    records[1]["torch_copy_tb_s"] = copy_rate
    return records


def _median5_strip() -> int:
    """The strip width of csrc/median5.cu as built without -D (``MED5_STRIP``)."""
    import re

    return int(re.search(r"#define MED5_STRIP (\d+)",
                         (K.CSRC / "median5.cu").read_text()).group(1))


def median5_sass_minmax(library):
    """The min and max a pixel that the built median5 kernel issues, counted
    from its SASS (``tools/sass_count.py``): the FMNMX of each innermost loop
    that holds them (a trip computes one strip), divided by the strip width;
    where the edge blocks' loop and the interior blocks' differ, the smaller.
    Returns (min/max a pixel, a description of the loops)."""
    from tools.sass_count import kernel_loops

    n = _median5_strip()
    counts = [lp["ops"]["FMNMX"] for lp in kernel_loops(library, "median5_kernel")
              if lp["ops"]["FMNMX"]]
    if not counts:
        raise AssertionError("the median5 kernel's SASS has no loop of FMNMX")
    return min(counts) / n, f"FMNMX a strip of {n}: " + ", ".join(map(str, counts))


def median5_minmax_per_pixel() -> float:
    """The min and max a pixel of the median5 kernel's network, counted from
    csrc/median5_columns.cuh at the strip width of csrc/median5.cu: a
    compare-exchange is two, a one-sided step one; a strip of N sorts N + 4
    columns, merges N + 2 pairs and takes N pruned merges and selections."""
    import re

    text = (K.CSRC / "median5_columns.cuh").read_text()
    n = _median5_strip()

    def ops(name):
        body = re.search(r"void " + name + r"\(.*?\n}\n", text, re.S).group(0)
        return sum(2 if kind == "CMP" else 1
                   for kind in re.findall(r"MED5_(CMP|MIN|MAX)\(\d+, \d+\);", body))

    # median_of_20_and_5: a min and a max for each of the five side values
    strip = (n + 4) * ops("sort5") + (n + 2) * ops("merge5x5") + n * (ops("merge10x10_mid") + 10)
    return strip / n


def homogeneity_planes(candidate, mat, wb):
    """The homogeneity kernel's main-path input: the CIELAB planes of one
    candidate (r, g, b), what ``_build_homogeneity_map`` hands it."""
    r, g, b = candidate
    rr, gg, bb = r * wb[0], g * wb[1], b * wb[2]
    return [p.contiguous() for p in rgb_to_lab_channels(
        mat[0, 0] * rr + mat[0, 1] * gg + mat[0, 2] * bb,
        mat[1, 0] * rr + mat[1, 1] * gg + mat[1, 2] * bb,
        mat[2, 0] * rr + mat[2, 1] * gg + mat[2, 2] * bb)]


def decision_pick_instructions(library):
    """Instructions the decision kernel issues for one pick with no halo,
    counted from its SASS: each innermost loop's longest path without the
    IEEE division's slow-path calls (``tools/sass_count.py``: every select's
    transcendental side and the HDR tonemap), divided by the cells a trip
    takes. The loops are told apart by what they hold: CIELAB (MUFU; three
    field loads a cell), counts (shared loads only) and box sums (one store a
    pick), in the order CIELAB, count, CIELAB, count, box; where the kernel
    has such a run for edge blocks and one for interior blocks, the smaller.
    Returns (instructions, a description of the parts)."""
    from tools.sass_count import kernel_loops

    def kind(lp):
        ops = lp["ops"]
        if ops["MUFU"] and ops["LDG"]:
            return "lab"
        if ops["STG"]:
            return "box"
        return "count" if ops["LDS"] else None

    runs, run = [], []
    for lp in kernel_loops(library, "decision_kernel"):
        k = kind(lp)
        if k is None:
            continue
        run.append((k, lp))
        if k == "box":
            runs.append(run)
            run = []
    best = None
    for run in runs:
        if [k for k, _ in run] != ["lab", "count", "lab", "count", "box"]:
            continue
        cells = [lp["longest"] / (lp["ops"]["LDG"] // 3) if k == "lab"
                 else lp["longest"] / lp["ops"]["STG"] if k == "box" else lp["longest"]
                 for k, lp in run]
        if best is None or sum(cells) < sum(best):
            best = cells
    if best is None:
        raise AssertionError("the decision kernel's SASS has no CIELAB, count, box run")
    parts = (f"CIELAB {best[0]:.1f} + {best[2]:.1f}, counts {best[1]:.0f} + {best[3]:.0f}, "
             f"box sums {best[4]:.2f}")
    return sum(best), parts


def kernels_at_main_shapes(frame: RawFrame, lin: torch.Tensor, srgb: torch.Tensor,
                           block: bytes):
    """Phase 4: each wrapper against its plain version at the main paths'
    shapes, the times and the bounds. Returns the per-kernel records."""
    stages = 1
    mat = cam_to_lin_srgb_matrix(frame.cam_mat, frame.cam_white)
    wb = frame.wb_reciprocal()
    tail = (True, True)
    got = K.ahd_kernel(frame.bayer, mat, wb, frame.is_hdr, stages, tail)
    want = K.ahd_plain(frame.bayer, mat, wb, frame.is_hdr, stages, tail)
    ahd_err = (got - want).abs().max().item()
    develop_stats(f"AHD kernel at {FULL_H}x{FULL_W} (tail fused)", got, want, MIN_PSNR_FULL)
    del got, want

    # The postprocess kernel's main-path shape: a whole frame of the staged route.
    h, w = frame.height, frame.width
    rgb = torch.from_numpy(make_scene(h, w, seed=9)).to(DEVICE)
    full = [rgb[..., k].contiguous() for k in range(3)]
    pp_err = 0.0
    for g, w_ in zip(K.postprocess_color_kernel(*full), postprocess_color_channels(*full)):
        pp_err = max(pp_err, (g - w_).abs().max().item())
        if not torch.equal(g, w_):
            raise AssertionError(f"postprocess kernel differs from plain at {tuple(g.shape)}")
    log(f"postprocess kernel vs plain at {h}x{w}: bit-exact")

    # The RL kernel's main-path input: the developed image's linear luma.
    luma = 0.299 * lin[..., 0] + 0.587 * lin[..., 1] + 0.114 * lin[..., 2]
    taps = get_1d_gaussian_filter(DECONV[0])
    iters = DECONV[1]
    got, want = K.rl_kernel(luma, taps, iters), K.rl_plain(luma, taps, iters)
    rl_err = (got - want).abs().max().item()
    log(f"RL kernel vs plain at {h}x{w}, {iters} iterations: max abs err {rl_err:.3g} "
        f"(bit-exact: {torch.equal(got, want)}; luma in [{luma.min().item():.4f}, "
        f"{luma.max().item():.4f}])")
    if not torch.equal(got, want):
        raise AssertionError("RL kernel at 24 MP differs from plain")
    del got, want

    # The remap kernel's main-path input: the filtered (H, W, 3) image and the
    # lens warp's shared, clipped maps with their bounds.
    mx, my = compute_remapping_table(WARP_COEFFS, w, h, WARP_CENTER, device=DEVICE)
    mx, my = mx.clamp(0, w - 1).contiguous(), my.clamp(0, h - 1).contiguous()
    bounds = displacement_bounds(WARP_COEFFS, w, h, WARP_CENTER)
    remap_err = {kind: check_remap(f"at {h}x{w}x3, shared maps,", srgb, mx, my, kind, bounds,
                                   channels_last=True)
                 for kind in ("lanczos4", "bilinear")}
    # A map for each channel (what lateral chromatic aberration needs): the lens
    # warp's maps a little apart.
    mx3 = torch.stack([mx - 0.6, mx, mx + 0.7]).clamp(0, w - 1)
    my3 = torch.stack([my + 0.4, my, my - 0.3]).clamp(0, h - 1)
    bounds3 = tuple((lo - 1, hi + 1) for lo, hi in bounds)
    check_remap(f"at {h}x{w}x3, a map for each channel,", srgb, mx3, my3, "lanczos4", bounds3,
                channels_last=True)
    bilinear = K.remap_kernel(srgb, mx, my, "bilinear", bounds, channels_last=True)
    planes = srgb.permute(2, 0, 1)[None].contiguous()
    grid = torch.stack([mx / (w - 1) * 2 - 1, my / (h - 1) * 2 - 1], dim=-1)[None]

    def grid_sample():
        return F.grid_sample(planes, grid, mode="bilinear", padding_mode="border",
                             align_corners=True)

    gs_diff = (grid_sample()[0].permute(1, 2, 0) - bilinear).abs().max().item()
    log(f"grid_sample(bilinear, border, align_corners) vs the remap kernel at {h}x{w}x3: "
        f"max abs diff {gs_diff:.3g} (it takes normalised coordinates)")
    del bilinear

    cfg = DevelopConfig(quality=QualityDemosaic.Best)
    plain_cfg = DevelopConfig(quality=QualityDemosaic.Best, use_pallas=False)
    t = {
        "ahd": median_ms(lambda: K.ahd_kernel(frame.bayer, mat, wb, frame.is_hdr, stages, tail)),
        "ahd_plain": median_ms(lambda: K.ahd_plain(frame.bayer, mat, wb, frame.is_hdr, stages, tail)),
        "pp_full": median_ms(lambda: K.postprocess_color_kernel(*full)),
        "pp_full_plain": median_ms(lambda: postprocess_color_channels(*full)),
        "rl": median_ms(lambda: K.rl_kernel(luma, taps, iters)),
        "rl_plain": median_ms(lambda: K.rl_plain(luma, taps, iters)),
        "remap_lanczos4": median_ms(
            lambda: K.remap_kernel(srgb, mx, my, "lanczos4", bounds, channels_last=True)),
        "remap_lanczos4_per_channel": median_ms(
            lambda: K.remap_kernel(srgb, mx3, my3, "lanczos4", bounds3, channels_last=True)),
        "remap_lanczos4_plain": median_ms(
            lambda: K.remap_plain(srgb, mx, my, "lanczos4", bounds, channels_last=True)),
        "remap_bilinear": median_ms(
            lambda: K.remap_kernel(srgb, mx, my, "bilinear", bounds, channels_last=True)),
        "remap_bilinear_queued": queued_ms(
            lambda: K.remap_kernel(srgb, mx, my, "bilinear", bounds, channels_last=True)),
        "remap_bilinear_plain": median_ms(
            lambda: K.remap_plain(srgb, mx, my, "bilinear", bounds, channels_last=True)),
        "grid_sample": median_ms(grid_sample),
        "grid_sample_queued": queued_ms(grid_sample),
        "finish": median_ms(lambda: finish_stages(lin, block)),
        "finish_plain": median_ms(lambda: finish_stages_plain(lin), runs=3, warmup=1),
    }
    # The Best develop, five separate timings with the kernels and five plain,
    # in turns: each one with the kernels must beat its plain one.
    develops = [(median_ms(lambda: develop(frame, cfg)),
                 median_ms(lambda: develop(frame, plain_cfg), runs=3, warmup=1))
                for _ in range(5)]
    t["develop"] = statistics.median(d[0] for d in develops)
    t["develop_plain"] = statistics.median(d[1] for d in develops)
    log("develop Best at 24 MP, five timings (CUDA events; with the kernels median of 10, "
        "plain median of 3): " + ", ".join(f"{a:.3f} / {b:.3f} ms" for a, b in develops))
    if any(a >= b for a, b in develops):
        raise AssertionError("a Best develop with the kernels was not faster than the plain one")
    # Where the finishing stages' time goes, stage by stage.
    deconv = gaussian_rt_deconvolution_yuv(lin, DECONV[0], DECONV[1])
    sharp = unsharp_mask_lab(deconv, UNSHARP[0], UNSHARP[1])
    stage_ms = {
        "deconv_yuv": median_ms(lambda: gaussian_rt_deconvolution_yuv(lin, *DECONV)),
        "unsharp_lab": median_ms(lambda: unsharp_mask_lab(deconv, *UNSHARP)),
        "gamma": median_ms(lambda: lin_srgb_to_srgb(torch.clamp(sharp, 0.0, 1.0))),
        "warp": median_ms(lambda: apply_opcode_3_warp(srgb, block)),
    }
    log("finishing stages one by one, median of 10 by CUDA events: "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in stage_ms.items()))
    del deconv, sharp
    for name, fn in (("develop", lambda: develop(frame, cfg)),
                     ("finishing stages", lambda: finish_stages(lin, block))):
        host_ms, device_ms, n = device_busy(fn)
        log(f"{name} under torch.profiler, 3 runs: {host_ms:.3f} ms host clock per run, "
            f"{device_ms:.3f} ms of device kernels ({n:.0f} kernels) per run, device "
            f"idle {max(0.0, 1 - device_ms / host_ms):.1%} of the host time")

    mp = h * w / 1e6
    log(f"times at {h}x{w} ({mp:g} MP) by CUDA events, median of 10 (finish_plain: "
        f"median of 3): " + ", ".join(f"{k} {v:.3f} ms" for k, v in t.items()))
    log(f"develop Best {mp / (t['develop'] / 1e3):.2f} MP/s with the kernels, "
        f"{mp / (t['develop_plain'] / 1e3):.2f} MP/s plain; finishing stages "
        f"{mp / (t['finish'] / 1e3):.2f} MP/s with the kernels, "
        f"{mp / (t['finish_plain'] / 1e3):.2f} MP/s plain")

    # Bounds: bytes (inputs read once, outputs written once) and the plain
    # versions' float32 operations on the same inputs.
    px = h * w
    ops = {
        "ahd": float_ops(lambda: K.ahd_plain(frame.bayer, mat, wb, frame.is_hdr, stages, tail)),
        "postprocess": float_ops(lambda: postprocess_color_channels(*full)),
        "rl": float_ops(lambda: K.rl_plain(luma, taps, iters)),
        "lanczos4": float_ops(
            lambda: K.remap_plain(srgb, mx, my, "lanczos4", bounds, channels_last=True)),
        "bilinear": float_ops(
            lambda: K.remap_plain(srgb, mx, my, "bilinear", bounds, channels_last=True)),
    }
    nbytes = {
        "ahd": px * (4 + 12),                 # mosaic in, (H, W, 3) out
        "postprocess": px * (12 + 12),        # three planes in, three out
        "rl": px * 12 * iters,                # est and image in, est out, per iteration
        "lanczos4": px * (8 + 12 + 12),       # two maps, (H, W, 3) in and out
        "bilinear": px * (8 + 12 + 12),
    }
    b = {k: bound(nbytes[k], ops[k]) for k in ops}
    log("bounds (NVIDIA H100 SXM, 3.35 TB/s, 67 TFLOP/s float32): " + ", ".join(
        f"{k} {nbytes[k] / 1e6:.1f} MB, {ops[k] / 1e9:.2f} G ops "
        f"({ops[k] / px:.1f} per px) -> "
        f"{b[k][0]:.4f} ms by {b[k][1]}" for k in ops))
    # The record keeps RL's per-launch bound (each of the 20 launches reads est
    # and the image and writes est); the 20-iteration function as a whole
    # needs the image read once and the estimate written once.
    rl_whole = bound(px * 8, ops["rl"])
    log(f"RL bound for the whole {iters}-iteration function: {px * 8 / 1e6:.1f} MB, "
        f"{ops['rl'] / 1e9:.2f} G ops -> {rl_whole[0]:.4f} ms by {rl_whole[1]}; the kernel "
        f"at {t['rl'] / b['rl'][0]:.2f}x the per-launch bound and "
        f"{t['rl'] / rl_whole[0]:.2f}x the whole function's")

    def record(name, counter, source, replaces, err, ms, plain_ms, bnd, library_ms):
        return {"name": name, "route": "cuda", "source": f"pysp_tpu_torch/csrc/{source}",
                "replaces": f"pysp_tpu/ops/pallas_kernels.py:{replaces}",
                "counter": counter, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": library_ms}

    return [
        record("ahd", "ahd", "ahd.cu", 672, ahd_err, t["ahd"], t["ahd_plain"],
               b["ahd"], None),
        record("postprocess_color", "postprocess", "postprocess.cu", 337, pp_err,
               t["pp_full"], t["pp_full_plain"], b["postprocess"], None),
        record("rl_deconv", "rl", "rl.cu", 1544, rl_err, t["rl"], t["rl_plain"],
               b["rl"], None),
        dict(record("remap_lanczos4", "remap", "remap.cu", 1325, remap_err["lanczos4"],
                    t["remap_lanczos4"], t["remap_lanczos4_plain"], b["lanczos4"], None),
             per_channel_maps_ms=t["remap_lanczos4_per_channel"],
             bilinear={"max_abs_err": remap_err["bilinear"], "ms": t["remap_bilinear"],
                       "queued_ms": t["remap_bilinear_queued"],
                       "plain_ms": t["remap_bilinear_plain"], "bound_ms": b["bilinear"][0],
                       "bound_by": b["bilinear"][1], "library_ms": t["grid_sample"],
                       "library_queued_ms": t["grid_sample_queued"],
                       "library": "torch.nn.functional.grid_sample",
                       "library_max_abs_diff": gs_diff}),
    ]


# --- the ca path: BASELINE config 5, the blind fits, the composed 102 MP chain -------

CA_H, CA_W = 1000, 1504            # config 5's burst (bench.py)
CA_FRAMES = 16
CA_K1 = 0.01                       # the Poly3 CA planted into R and B and removed
CA_WARP = [(1.005, -0.01, 0.002, 0.0, 0.0003, -0.0002)] * 3
CA_CFG = DevelopConfig(quality=QualityDemosaic.Best, postprocess_stages=1)
CA_PLAIN_CFG = DevelopConfig(quality=QualityDemosaic.Best, postprocess_stages=1,
                             use_pallas=False)
CA_MARGIN = 16                     # plane sites left out at the border of the alignment error
RING_K1 = {"R": 0.02, "B": -0.01}  # the blind fits' ring chart
CHAIN_H, CHAIN_W = 8736, 11648     # the composed 102 MP chain


@contextlib.contextmanager
def plain_remaps():
    """The CA removal and the lens warp with the remap kernel's plain version
    in its place, the CA removal on its plain coordinate maps and with the
    EAG resamples' plain versions; the launch counts do not move."""
    names = ("_kernel_form", "resample_g_to_full_resolution", "resample_r", "resample_b")
    saved = rectilinear.remap_kernel, ca_removal.remap_kernel, *(
        getattr(ca_removal, name) for name in names)
    ca_removal.remap_kernel = rectilinear.remap_kernel = K.remap_plain
    ca_removal._kernel_form = lambda model, stack: None
    ca_removal.resample_g_to_full_resolution = resample_g_to_full_resolution_plain
    ca_removal.resample_r = lambda r, g: resample_channel_plain(r, g, P.TOP_LEFT)
    ca_removal.resample_b = lambda b, g: resample_channel_plain(b, g, P.BOTTOM_RIGHT)
    try:
        yield
    finally:
        rectilinear.remap_kernel, ca_removal.remap_kernel = saved[:2]
        for name, fn in zip(names, saved[2:]):
            setattr(ca_removal, name, fn)


def plant_ca(plane: torch.Tensor, k1: float) -> torch.Tensor:
    """``plane`` sampled through Poly3(k1)'s inverse coordinate field (as
    tests/test_ca.py plants CA): the displacement that Poly3(k1) removes."""
    h, w = plane.shape
    coords = Poly3CorrectionModel(k1).get_undistorted_coordinates(plane)
    return remap_bilinear(plane, *ca_removal._maps_from_offsets(coords, h, w))


def ca_mosaic(rgb: np.ndarray, k_r: float, k_b: float) -> np.ndarray:
    """The RGGB mosaic of ``rgb`` with R displaced by Poly3(k_r) and B by
    Poly3(k_b), planted on the card."""
    planes = torch.from_numpy(np.ascontiguousarray(rgb.transpose(2, 0, 1))).to(DEVICE)
    out = torch.stack([plant_ca(planes[0], k_r), planes[1], plant_ca(planes[2], k_b)], -1)
    return mosaic_rggb(out.cpu().numpy())


def dng_bytes(mosaic: np.ndarray) -> bytes:
    return write_synthetic_dng(np.ascontiguousarray(200 + mosaic * 3800).astype(np.uint16))


def ca_composition(burst: RawFrame, block: bytes):
    """Config 5 after the load: CA removal over the burst, then each frame's
    Best develop (one stage) and lens warp (Lanczos4). Returns the corrected
    burst, the developed images and the warped ones."""
    model = Poly3CorrectionModel(CA_K1)
    corrected = remove_ca_from_raw(burst, model, model)
    devs = [develop(f, CA_CFG) for f in unstack_frames(corrected)]
    return corrected, devs, [apply_opcode_3_warp(img, block) for img in devs]


def ca_composition_plain(burst: RawFrame, block: bytes):
    """The same composition from the plain versions on the card."""
    model = Poly3CorrectionModel(CA_K1)
    with plain_remaps():
        corrected = remove_ca_from_raw(burst, model, model)
        return [apply_opcode_3_warp(develop(f, CA_PLAIN_CFG), block)
                for f in unstack_frames(corrected)]


def check_warped(name: str, dev: torch.Tensor, out: torch.Tensor, h: int, w: int) -> None:
    """The developed image within [0, 1]; the warped one finite, (H, W, 3)
    and within Lanczos4's overshoot of [0, 1] (the TIFF writer clips)."""
    check_image(f"{name} before the warp", dev, h, w)
    if tuple(out.shape) != (h, w, 3) or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"{name}: warped image {tuple(out.shape)} is not finite (H, W, 3)")
    ring = lanczos4_overshoot()
    lo, hi = out.min().item(), out.max().item()
    if lo < -ring or hi > 1.0 + ring:
        raise AssertionError(f"{name}: warped image outside [-{ring}, 1 + {ring}]: [{lo}, {hi}]")


def plane_error(bayer: torch.Tensor, clean: torch.Tensor, plane: int) -> float:
    """Mean absolute error of a CFA plane against the clean scene's, inside a
    margin of CA_MARGIN sites."""
    m = CA_MARGIN
    d = bayer_to_planes(bayer)[..., plane, m:-m, m:-m] - bayer_to_planes(clean)[..., plane, m:-m, m:-m]
    return d.abs().mean().item()


def ca_path(tmp: str):
    """Phase 3, ca: config 5 (16 DNGs with planted CA -> stack -> CA removal ->
    Best develop -> lens warp -> TIFF), the blind template and gradient fits
    on a ring chart with their CLI round trip, and the composed 102 MP chain.
    Returns the launch counts of config 5 and what phase 4 measures."""
    block = encode_warp_rectilinear(CA_WARP, (0.5, 0.5))
    model = Poly3CorrectionModel(CA_K1)
    paths, clean = [], []
    for seed in range(CA_FRAMES):
        rgb = make_scene(CA_H, CA_W, seed=seed)
        clean.append(mosaic_rggb(rgb))
        paths.append(os.path.join(tmp, f"ca{seed}.dng"))
        with open(paths[-1], "wb") as fh:
            fh.write(dng_bytes(ca_mosaic(rgb, CA_K1, CA_K1)))
    tifs = [os.path.join(tmp, f"ca{k}.tif") for k in (0, CA_FRAMES - 1)]

    zero_launch_counts()
    t0 = time.perf_counter()
    burst = stack_frames([load_raw(p) for p in paths])
    corrected, devs, outs = ca_composition(burst, block)
    save_image(tifs[0], outs[0])
    save_image(tifs[1], outs[-1])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = launch_counts()
    log(f"ca path, config 5 ({CA_FRAMES} DNGs {CA_H}x{CA_W} -> load_raw -> stack_frames -> "
        f"remove_ca_from_raw(Poly3({CA_K1}) x2) -> develop Best 1 stage -> lens warp "
        f"{CA_WARP[0]} -> save_image of frames 0 and {CA_FRAMES - 1}): {seconds:.3f} s host "
        f"clock, kernel launches {launches}")
    if burst.bayer.device.type != DEVICE:
        raise AssertionError("load_raw / stack_frames did not put the burst on the card")
    expect_launches("ca", launches, remap=4 + CA_FRAMES, ahd=CA_FRAMES,
                    eag_resample=CA_RESAMPLES)

    # (a) The CA stage with the kernels is its plain version, bit for bit.
    with plain_remaps():
        plain = remove_ca_from_raw(burst, model, model).bayer
    same = torch.equal(corrected.bayer, plain)
    log(f"CA stage ({CA_FRAMES}x{CA_H}x{CA_W}) with the remap and EAG kernels vs remap_plain "
        f"and the plain resamples on the card: bit-exact {same}")
    if not same:
        raise AssertionError("the CA stage with the kernels differs from plain")
    # (b) The burst's CA is the frames' one by one.
    frames = unstack_frames(burst)
    same = all(torch.equal(remove_ca_from_raw(f, model, model).bayer, c)
               for f, c in zip(frames, corrected.bayer))
    log(f"CA over the burst in one launch a remap vs frame by frame: equal {same}")
    if not same:
        raise AssertionError("the burst's CA differs from the frames' one by one")
    # (c) R and B realign with the clean scene.
    clean_t = (200 + torch.from_numpy(np.stack(clean)).to(DEVICE) * 3800 - 256) / 4095
    for name, plane in (("R", 0), ("B", 2)):
        before = plane_error(burst.bayer, clean_t, plane)
        after = plane_error(corrected.bayer, clean_t, plane)
        log(f"{name} planes against the clean scene, mean abs error inside {CA_MARGIN} "
            f"sites: {before:.6f} before, {after:.6f} after CA removal (ratio "
            f"{after / before:.4f})")
        if not after < before:
            raise AssertionError(f"CA removal did not realign the {name} planes")
    del clean_t, plain
    # (d) The images, and (e) each against the plain composition.
    for k, (dev, out) in enumerate(zip(devs, outs)):
        check_warped(f"config 5 frame {k}", dev, out, CA_H, CA_W)
    for tif in tifs:
        if os.path.getsize(tif) < CA_H * CA_W * 6:
            raise AssertionError(f"{tif} is too short")
    want = ca_composition_plain(burst, block)
    worst = min(psnr(o.double().cpu().numpy(), w_.double().cpu().numpy())
                for o, w_ in zip(outs, want))
    log(f"config 5: every frame against the plain composition on the card >= {worst:.2f} dB")
    if worst < MIN_PSNR:
        raise AssertionError(f"a config 5 frame is {worst:.2f} dB from the plain composition")
    del want, devs, outs, corrected

    ca_fits(tmp)
    return launches, burst, block


def ring_frame_mosaic(h: int, w: int) -> np.ndarray:
    """tests/test_ca.py's ring chart scaled to the frame (radii and width),
    R displaced by Poly3(0.02) and B by Poly3(-0.01)."""
    size = min(h, w)
    img = ring_chart(h, w, radii=tuple(size * f for f in (0.23, 0.33, 0.41)), amp=0.6,
                     sigma=size / 128, base=0.1) + 0.1
    return ca_mosaic(np.dstack([img] * 3), RING_K1["R"], RING_K1["B"])


def ca_fits(tmp: str) -> None:
    """The blind fits on a ring chart DNG of config 5's size: the template fit
    (timed whole and split into the instability, the host ROI screening and
    the device batch of template matches) and the gradient fit, each held to
    its JAX test's gate; then ``--ca template --save-params`` and ``--params``
    through the CLI."""
    path = os.path.join(tmp, "rings.dng")
    with open(path, "wb") as fh:
        fh.write(dng_bytes(ring_frame_mosaic(CA_H, CA_W)))
    frame = load_raw(path)

    def host_clock(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    match_s = []
    batch = ca_solver.template_match_batch

    def timed_batch(*args, **kw):
        out, s = host_clock(lambda: batch(*args, **kw))
        match_s.append(s)
        return out

    ca_solver.template_match_batch = timed_batch
    try:
        si, si_s = host_clock(lambda: compute_structural_instability(frame))
        _, roi_s = host_clock(lambda: [
            RoiDetector(PooledChannel(si[..., c].cpu().numpy()), default_threshold=16)
            for c in (0, 2)])
        (r, b), template_s = host_clock(lambda: compute_ca_lens_models_for_raw(
            frame, Poly3CorrectionModel(), Poly3CorrectionModel(),
            max_distortion_additional_scale=0.03))
    finally:
        ca_solver.template_match_batch = batch
    k_r, k_b = float(r.get_coefficients()[0]), float(b.get_coefficients()[0])
    log(f"template fit on a {CA_H}x{CA_W} ring chart (R Poly3({RING_K1['R']}), B "
        f"Poly3({RING_K1['B']})): {template_s:.3f} s host clock, of which the device batch "
        f"of template matches {sum(match_s):.3f} s ({len(match_s)} calls); apart: "
        f"instability {si_s:.4f} s, host ROI screening of R and B {roi_s:.3f} s; k1 R "
        f"{k_r:.6f}, B {k_b:.6f}")
    if not 0.002 < k_r < 0.08:
        raise AssertionError(f"template fit: R's k1 {k_r} outside (0.002, 0.08)")

    (r, b), gradient_s = host_clock(lambda: fit_ca_models_gradient(frame, steps=120))
    k_r, k_b = float(r.get_coefficients()[0]), float(b.get_coefficients()[0])
    log(f"gradient fit (120 Adam steps a channel): {gradient_s:.3f} s host clock; k1 R "
        f"{k_r:.6f}, B {k_b:.6f}")
    if abs(k_r - RING_K1["R"]) > 0.5 * RING_K1["R"]:
        raise AssertionError(f"gradient fit: R's k1 {k_r} not within 50% of {RING_K1['R']}")

    params, fit_tif = os.path.join(tmp, "rings.json"), os.path.join(tmp, "rings_fit.tif")
    cmd = [sys.executable, "-m", "pysp_tpu_torch", "develop", path, "-o", fit_tif, "--ca",
           "template", "--save-params", params]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600, cwd=REPO)
    if proc.returncode != 0 or "CA fit failed" in proc.stderr:
        raise AssertionError(f"the CLI's --ca template failed ({proc.returncode}):\n"
                             f"{proc.stderr}")
    with open(params) as fh:
        saved = json.load(fh)
    log(f"CLI {' '.join(cmd[3:])}: {time.perf_counter() - t0:.3f} s host clock; "
        f"{proc.stdout.strip()}; sidecar CA {saved.get('ca')}")
    run_cli([path, "--params", params], fit_tif, os.path.join(tmp, "rings_replay.tif"))


def ca_at_main_shapes(burst: RawFrame, block: bytes):
    """Phase 4 for the ca path: one bilinear CA launch on the burst's
    upsampled greens against its plain version, its bound and grid_sample;
    the AHD kernel on one 1.5 MP frame; the stages of config 5 and the whole
    composition with and without the kernels, with the device's idle share.
    Returns what the AHD and remap records add."""
    model = Poly3CorrectionModel(CA_K1)
    _, g1, _, g2 = bayer_to_rgbg(burst.bayer)
    g = resample_g_to_full_resolution(g1, g2)
    n, h, w = g.shape
    mx, my = ca_removal._maps_from_offsets(model.get_undistorted_coordinates(g[0]), h, w)
    got, want = K.remap_kernel(g, mx, my, "bilinear"), K.remap_plain(g, mx, my, "bilinear")
    if not torch.equal(got, want):
        raise AssertionError("the bilinear CA remap at config 5's shape differs from plain")
    grid = torch.stack([mx / (w - 1) * 2 - 1, my / (h - 1) * 2 - 1], dim=-1)[None]

    def grid_sample():
        return F.grid_sample(g[None], grid, mode="bilinear", padding_mode="border",
                             align_corners=True)

    gs_diff = (grid_sample()[0] - got).abs().max().item()
    nbytes = n * h * w * 4 * 2 + h * w * 8      # stack in and out, two shared maps
    ops = float_ops(lambda: K.remap_plain(g, mx, my, "bilinear"))
    b = bound(nbytes, ops)
    t = {"ca_bilinear": median_ms(lambda: K.remap_kernel(g, mx, my, "bilinear")),
         "ca_bilinear_queued": queued_ms(lambda: K.remap_kernel(g, mx, my, "bilinear")),
         "ca_bilinear_plain": median_ms(lambda: K.remap_plain(g, mx, my, "bilinear")),
         "ca_grid_sample": median_ms(grid_sample),
         "ca_grid_sample_queued": queued_ms(grid_sample)}
    log(f"bilinear CA remap of {n}x{h}x{w} with shared maps: bit-exact against plain; "
        f"{nbytes / 1e6:.1f} MB, {ops / 1e9:.3f} G ops -> bound {b[0]:.4f} ms by {b[1]}; "
        f"kernel {t['ca_bilinear']:.4f} ms a lone call ({t['ca_bilinear'] / b[0]:.2f}x), "
        f"{t['ca_bilinear_queued']:.4f} ms back to back, plain {t['ca_bilinear_plain']:.4f} "
        f"ms, grid_sample {t['ca_grid_sample']:.4f} ms a lone call (the kernel at "
        f"{t['ca_bilinear'] / t['ca_grid_sample']:.2f}x), {t['ca_grid_sample_queued']:.4f} ms "
        f"back to back (the kernel at {t['ca_bilinear_queued'] / t['ca_grid_sample_queued']:.2f}"
        f"x); max abs diff {gs_diff:.3g}")
    del got, want, grid

    frame = unstack_frames(burst)[0]
    mat = cam_to_lin_srgb_matrix(frame.cam_mat, frame.cam_white)
    wb = frame.wb_reciprocal()
    tail = (True, True)
    t["ahd_frame"] = median_ms(lambda: K.ahd_kernel(frame.bayer, mat, wb, False, 1, tail))
    t["ahd_frame_plain"] = median_ms(lambda: K.ahd_plain(frame.bayer, mat, wb, False, 1, tail))

    corrected, devs, _ = ca_composition(burst, block)
    frames = unstack_frames(corrected)
    t["ca_stage"] = median_ms(lambda: remove_ca_from_raw(burst, model, model))
    t["develop_x16"] = median_ms(lambda: [develop(f, CA_CFG) for f in frames])
    t["warp_x16"] = median_ms(lambda: [apply_opcode_3_warp(img, block) for img in devs])
    t["config5"] = median_ms(lambda: ca_composition(burst, block))
    t["config5_plain"] = median_ms(lambda: ca_composition_plain(burst, block), runs=3, warmup=1)
    del corrected, devs, frames
    mp = CA_FRAMES * CA_H * CA_W / 1e6
    log(f"config 5 at {CA_FRAMES}x{CA_H}x{CA_W} by CUDA events, median of 10 (config5_plain: "
        f"median of 3): " + ", ".join(f"{k} {v:.3f} ms" for k, v in t.items()))
    log(f"config 5 {mp / (t['config5'] / 1e3):.2f} MP/s with the kernels, "
        f"{mp / (t['config5_plain'] / 1e3):.2f} MP/s plain")
    host_ms, device_ms, launches = device_busy(lambda: ca_composition(burst, block))
    idle = max(0.0, 1 - device_ms / host_ms)
    log(f"config 5 under torch.profiler, 3 runs: {host_ms:.3f} ms host clock per run, "
        f"{device_ms:.3f} ms of device kernels ({launches:.0f} kernels) per run, device idle "
        f"{idle:.1%} of the host time")
    return {"ca_bilinear": {"shape": [n, h, w], "max_abs_err": 0.0, "ms": t["ca_bilinear"],
                            "queued_ms": t["ca_bilinear_queued"],
                            "plain_ms": t["ca_bilinear_plain"], "bound_ms": b[0],
                            "bound_by": b[1], "library_ms": t["ca_grid_sample"],
                            "library_queued_ms": t["ca_grid_sample_queued"],
                            "library": "torch.nn.functional.grid_sample",
                            "library_max_abs_diff": gs_diff},
            "ahd_ca_frame": {"shape": [CA_H, CA_W], "ms": t["ahd_frame"],
                             "plain_ms": t["ahd_frame_plain"]}}


def chain_102mp(rgb: np.ndarray):
    """The composed 102 MP chain with the kernels: hot-pixel detection and
    heal -> CA removal -> Best develop (1 stage) -> lens warp (Lanczos4), on an
    8736x11648 RGGB frame on the card (``rgb``, the 102 MP scene) with planted
    hot sites and Poly3(0.01) CA. Each stage timed apart (median of 3 after
    1) and the whole chain. Returns the times and the hot sites."""
    t0 = time.perf_counter()
    mosaic = ca_mosaic(rgb, CA_K1, CA_K1)
    hot = plant_hot_sites(mosaic)
    mosaic[hot[:, 0], hot[:, 1]] = 1.0
    frame = RawFrame.synthetic(mosaic, cam_mat=CAM, wb_neutral=WB, device=DEVICE)
    del mosaic
    log(f"102 MP chain input: {CHAIN_H}x{CHAIN_W} RGGB frame on the card with {len(hot)} hot "
        f"sites and Poly3({CA_K1}) CA planted, built in {time.perf_counter() - t0:.1f} s")
    model = Poly3CorrectionModel(CA_K1)
    block = encode_warp_rectilinear(CA_WARP, (0.5, 0.5))
    torch.cuda.reset_peak_memory_stats()

    def heal(f):
        return repair_bad_pixels(f, find_erroneous_pixels_median(f))

    healed = heal(frame)
    corrected = remove_ca_from_raw(healed, model, model)
    with plain_remaps():
        same = torch.equal(remove_ca_from_raw(healed, model, model).bayer, corrected.bayer)
    log(f"102 MP CA stage with the remap and EAG kernels vs remap_plain and the plain "
        f"resamples: bit-exact {same}")
    if not same:
        raise AssertionError("the 102 MP CA stage differs from plain")
    dev = develop(corrected, CA_CFG)
    out = apply_opcode_3_warp(dev, block)
    check_warped("102 MP chain", dev, out, CHAIN_H, CHAIN_W)
    del out
    t = {"heal": median_ms(lambda: heal(frame), runs=3, warmup=1),
         "ca": median_ms(lambda: remove_ca_from_raw(healed, model, model), runs=3, warmup=1),
         "develop": median_ms(lambda: develop(corrected, CA_CFG), runs=3, warmup=1),
         "warp": median_ms(lambda: apply_opcode_3_warp(dev, block), runs=3, warmup=1)}
    t["sum"] = sum(t.values())
    t["chain"] = median_ms(lambda: apply_opcode_3_warp(develop(remove_ca_from_raw(
        heal(frame), model, model), CA_CFG), block), runs=3, warmup=1)
    t["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log(f"102 MP chain ({CHAIN_H}x{CHAIN_W}) by CUDA events, median of 3: "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in t.items() if k != "peak_gb")
        + f"; {CHAIN_H * CHAIN_W / 1e6 / (t['chain'] / 1e3):.1f} MP/s; peak device memory "
        f"{t['peak_gb']:.2f} GB")
    return t, hot


# Small odd bursts (N, H, W) of mosaics for the EAG kernels beside the main
# paths' shapes: one quad of quads, odd quarter planes off the upsample's 16 x
# 64 quads a block, and one whose aligned rows take its 16-byte path.
EAG_SMALL = ((1, 4, 4), (3, 34, 130), (2, 102, 516), (2, 100, 400))


def eag_at_main_shapes(burst: RawFrame, rgb102: np.ndarray) -> dict:
    """Phase 4 for CA removal's EAG kernels: the fill on a mosaic's green
    phases (strided views, read in place) and the upsample of R and B on the
    filled green, each against its plain version (``torch.equal``) at mf102's
    8736x11648 frame (the 102 MP scene), at config 5's stack of 16 x
    1000x1504 and at ``EAG_SMALL``; at the first two each timed as a lone call
    and back to back beside its plain version and its bound (the fill reads
    the mosaic's rows and writes the green, 8 B a pixel; an upsample reads
    the green and the quarter plane and writes the channel, 9 B). Returns its
    record: the fill at 102 MP, the other kernels and shapes under it."""
    gen = torch.Generator(device=DEVICE).manual_seed(24)
    mosaics = [("small", torch.rand(shape, generator=gen, device=DEVICE))
               for shape in EAG_SMALL]
    mosaics += [("mf102", torch.from_numpy(mosaic_rggb(rgb102)).to(DEVICE)[None]),
                ("config5", burst.bayer)]
    parts = {}
    for key, mosaic in mosaics:
        r, g1, b, g2 = bayer_to_rgbg(mosaic)
        green = K.eag_fill_kernel(g1, g2)
        calls = {"fill": (lambda: K.eag_fill_kernel(g1, g2),
                          lambda: resample_g_to_full_resolution_plain(g1, g2), 8)}
        for label, position, sub in (("upsample_r", P.TOP_LEFT, r.contiguous()),
                                     ("upsample_b", P.BOTTOM_RIGHT, b.contiguous())):
            calls[label] = (lambda sub=sub, position=position:
                            K.eag_upsample_kernel(sub, green, position),
                            lambda sub=sub, position=position:
                            resample_channel_plain(sub, green, position), 9)
        for label, (kernel, plain, bytes_a_px) in calls.items():
            if not torch.equal(kernel(), plain()):
                raise AssertionError(f"the EAG {label} kernel at {tuple(mosaic.shape)} differs "
                                     f"from plain")
            if key == "small":
                continue
            least = bound(bytes_a_px * mosaic.numel(), float_ops(plain))
            parts[f"{label}_{key}"] = {
                "shape": list(mosaic.shape), "max_abs_err": 0.0, "ms": median_ms(kernel),
                "queued_ms": queued_ms(kernel), "plain_ms": median_ms(plain, runs=3, warmup=1),
                "bound_ms": least[0], "bound_by": least[1], "library_ms": None}
        del r, g1, b, g2, green, calls
    del mosaics
    for label, t in parts.items():
        log(f"EAG {label} {tuple(t['shape'])}: bit-exact against plain (and at "
            f"{len(EAG_SMALL)} small bursts); {t['ms']:.4f} ms a lone call, "
            f"{t['queued_ms']:.4f} ms back to back ({t['queued_ms'] / t['bound_ms']:.2f}x its "
            f"bound of {t['bound_ms']:.4f} ms by {t['bound_by']}), plain {t['plain_ms']:.3f} ms "
            f"(CUDA events; plain median of 3 after 1)")
    rec = {"name": "eag_resample", "route": "cuda",
           "source": "pysp_tpu_torch/csrc/eag_resample.cu",
           "replaces": "pysp_tpu_torch/demosaic/eag.py::resample_g_to_full_resolution_plain, "
                       "resample_channel_plain",
           "counter": "eag_resample", **parts.pop("fill_mf102")}
    rec.update(parts)
    return rec


# --- the surface path: OpcodeList1/2 at load, highlight reconstruction, statistics ----

SURFACE_CFG = DevelopConfig(quality=QualityDemosaic.Best, highlights="reconstruct")
SURFACE_PLAIN_CFG = DevelopConfig(quality=QualityDemosaic.Best, highlights="reconstruct",
                                  use_pallas=False)
SURFACE_STAGED_CFG = DevelopConfig(quality=QualityDemosaic.Best, highlights="reconstruct",
                                   postprocess_stages=STAGED_STAGES)
SURFACE_STAGED_PLAIN_CFG = DevelopConfig(quality=QualityDemosaic.Best, highlights="reconstruct",
                                         postprocess_stages=STAGED_STAGES, use_pallas=False)
SURFACE_CLIP_SHARE = 0.05          # photosites of the scene at the white level
SURFACE_MIN_PSNR = 90.0            # the reconstruct develop, kernel against plain, at 24 MP
SURFACE_POINTS, SURFACE_RECTS = 500, 10
SURFACE_CONSTANT = 7               # FixBadPixelsConstant's stored sentinel
SURFACE_CONSTANT_SITES = 200
SURFACE_GAIN_POINTS = 17           # a 17x17 gain grid for each CFA phase
SURFACE_VIGNETTE = (0.25, -0.05, 0.01, 0.0, 0.0)
LOAD_ATOL = 1e-6                   # the load on the card against the load on the CPU
STATS_RTOL = 1e-5                  # means and std on the card against float64 NumPy
P99_ATOL = 1e-6
# The keys of the JAX CLI's --stats JSON (pysp_tpu/utils/tracing.py).
STATS_KEYS = {"sensor": ["clip_high_frac", "clip_low_frac", "mean", "p99"],
              "output": ["mean_rgb", "neg_frac", "sat_frac", "std_rgb"]}
BLACK, WHITE = 256, 4095           # write_synthetic_dng's levels; black + white is 1.0


def surface_scene(h: int, w: int):
    """The surface path's mosaic, before its defects: ``make_scene`` with one
    blown region where all three channels clip and a larger one where only G
    clips, scaled so that about SURFACE_CLIP_SHARE of the photosites reach
    the white level. Returns the stored counts and the two regions' masks."""
    rgb = make_scene(h, w, seed=11)
    yy, xx = np.ogrid[0:h, 0:w]
    core = np.exp(-(((yy - 0.3 * h) / (0.06 * h)) ** 2 + ((xx - 0.3 * w) / (0.06 * w)) ** 2))
    ring = np.exp(-(((yy - 0.65 * h) / (0.11 * h)) ** 2 + ((xx - 0.65 * w) / (0.11 * w)) ** 2))
    rgb *= (1.0 + 5.0 * core)[..., None].astype(np.float32)
    rgb[..., 1] *= (1.0 + 1.2 * ring).astype(np.float32)
    mosaic = mosaic_rggb(rgb)
    k = int(mosaic.size * (1 - SURFACE_CLIP_SHARE))
    scale = 1.0 / float(np.partition(mosaic.reshape(-1), k)[k])
    stored = (BLACK + np.minimum(mosaic * scale, 1.0) * WHITE).astype(np.uint16)
    return stored, core > 0.5, ring > 0.5


def surface_opcodes(stored: np.ndarray, seed: int = 12):
    """Plants the defects into ``stored`` (in place) and returns the two
    opcode blocks: OpcodeList1 holds a FixBadPixelsConstant (SURFACE_CONSTANT
    stored at SURFACE_CONSTANT_SITES sites) and a FixBadPixelsList of
    SURFACE_POINTS dead points and SURFACE_RECTS dead rects; OpcodeList2 a
    GainMap for each CFA phase (pitch 2, a 17x17 grid, gains 0.8-1.3) and a
    FixVignetteRadial."""
    h, w = stored.shape
    rng = np.random.default_rng(seed)
    stored.flat[rng.choice(h * w, SURFACE_CONSTANT_SITES, replace=False)] = SURFACE_CONSTANT
    points = np.stack([rng.integers(0, h, SURFACE_POINTS),
                       rng.integers(0, w, SURFACE_POINTS)], 1).astype(np.int32)
    tops, lefts = rng.integers(0, h - 8, SURFACE_RECTS), rng.integers(0, w - 8, SURFACE_RECTS)
    sizes = rng.integers(2, 7, (SURFACE_RECTS, 2))
    rects = np.stack([tops, lefts, tops + sizes[:, 0], lefts + sizes[:, 1]], 1).astype(np.int32)
    stored[points[:, 0], points[:, 1]] = BLACK            # dead photosites
    for top, left, bottom, right in rects:
        stored[top:bottom, left:right] = BLACK
    block1 = encode_opcode_list([
        (FO.OPCODE_FIX_BAD_PIXELS_CONSTANT,
         FO.encode_fix_bad_pixels_constant(FO.BadPixelsConstant(SURFACE_CONSTANT, 0))),
        (FO.OPCODE_FIX_BAD_PIXELS_LIST,
         FO.encode_fix_bad_pixels_list(FO.BadPixelsList(0, points, rects))),
    ])
    n = SURFACE_GAIN_POINTS
    ops = [(GO.OPCODE_GAIN_MAP, encode_gain_map(GainMap(
        dy, dx, h, w, 0, 1, 2, 2, n, n, 1.0 / (n - 1), 1.0 / (n - 1), 0.0, 0.0, 1,
        rng.uniform(0.8, 1.3, (n, n, 1)).astype(np.float32))))
        for dy in (0, 1) for dx in (0, 1)]
    ops.append((GO.OPCODE_FIX_VIGNETTE_RADIAL,
                encode_vignette_radial(VignetteRadial(SURFACE_VIGNETTE, 0.5, 0.5))))
    return block1, encode_opcode_list(ops)


def stats_against_numpy(name: str, stats: dict, bayer: torch.Tensor, lim_sat: float,
                        out: torch.Tensor) -> None:
    """``develop_with_stats``'s statistics against float64 NumPy over the same
    tensors: means and std within STATS_RTOL relative, the fractions exact
    (the count over n, one float32 division), p99 as ``numpy.quantile``
    (linear) within P99_ATOL."""
    x = bayer.cpu().numpy()
    rgb = out.cpu().numpy().reshape(-1, 3)

    def frac(mask):
        return np.float32(np.count_nonzero(mask)) / np.float32(mask.size)

    want = {"sensor": {"mean": x.mean(dtype=np.float64),
                       "clip_high_frac": frac(x >= np.float32(lim_sat)),
                       "clip_low_frac": frac(x <= 0.0),
                       "p99": np.quantile(x, 0.99)},
            "output": {"mean_rgb": rgb.mean(axis=0, dtype=np.float64),
                       "std_rgb": rgb.astype(np.float64).std(axis=0),
                       "sat_frac": frac(rgb >= 1.0), "neg_frac": frac(rgb <= 0.0)}}
    worst = {}
    for part, entries in want.items():
        for key, w_ in entries.items():
            g = stats[part][key].cpu().numpy()
            if key.endswith("_frac"):
                ok, worst[key] = bool(np.array_equal(g, w_)), float(np.abs(g - w_).max())
            elif key == "p99":
                worst[key] = float(abs(g - w_))
                ok = worst[key] <= P99_ATOL
            else:
                worst[key] = float(np.max(np.abs(g / w_ - 1)))
                ok = worst[key] <= STATS_RTOL
            if not ok:
                raise AssertionError(f"{name}: {part} {key} {g} against NumPy's {w_}")
    log(f"{name} statistics against float64 NumPy over the same tensors (means and std "
        f"within {STATS_RTOL:g} relative, fractions exact, p99 within {P99_ATOL:g}): "
        + ", ".join(f"{k} {v:.3g}" for k, v in worst.items())
        + f"; sensor {json.dumps({k: float(v) for k, v in stats['sensor'].items()})}")


def surface_path(tmp: str, card: str):
    """Phase 3, surface: a 24 MP DNG carrying OpcodeList1 and OpcodeList2
    through ``load_raw -> develop_with_stats(Best, highlights="reconstruct")
    -> save_image``, the postprocess kernel's (H, W, 3) entry on the image,
    a staged reconstruct develop of a 1500x2000 crop, then the CLI's
    ``--highlights reconstruct --stats``. Returns the launch counts and what
    phase 4 measures."""
    stored, core, ring = surface_scene(FULL_H, FULL_W)
    clean = stored.copy()
    block1, block2 = surface_opcodes(stored)
    path = os.path.join(tmp, "surface.dng")
    with open(path, "wb") as fh:
        fh.write(write_synthetic_dng(stored, opcode_list_1=block1, opcode_list_2=block2))
    tif, cli_tif = (os.path.join(tmp, f"{n}.tif") for n in ("surface", "surface_cli"))
    clipped = (clean == BLACK + WHITE)
    log(f"surface DNG {FULL_H}x{FULL_W}: {clipped.mean():.3%} of the photosites at the white "
        f"level; the blown region's R, G, B sites {clipped[0::2, 0::2][core[0::2, 0::2]].mean():.1%}, "
        f"{clipped[0::2, 1::2][core[0::2, 1::2]].mean():.1%}, "
        f"{clipped[1::2, 1::2][core[1::2, 1::2]].mean():.1%} clipped; the G-only region's "
        f"{clipped[0::2, 0::2][ring[0::2, 0::2]].mean():.1%}, "
        f"{clipped[0::2, 1::2][ring[0::2, 1::2]].mean():.1%}, "
        f"{clipped[1::2, 1::2][ring[1::2, 1::2]].mean():.1%}")

    zero_launch_counts()
    t0 = time.perf_counter()
    frame = load_raw(path)
    out, stats = develop_with_stats(frame, SURFACE_CFG)
    save_image(tif, out)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    develop_launches = launch_counts()
    image_stage = postprocess_color(out, use_pallas=True)
    y0, x0 = (FULL_H - BGGR_H) // 4 * 2, (FULL_W - BGGR_W) // 4 * 2   # even: RGGB stays
    crop = frame.replace(bayer=frame.bayer[y0:y0 + BGGR_H, x0:x0 + BGGR_W].contiguous())
    staged = develop(crop, SURFACE_STAGED_CFG)
    torch.cuda.synchronize()
    launches = launch_counts()
    log(f"surface path (load_raw of a {FULL_H}x{FULL_W} DNG with OpcodeList1/2 -> "
        f"develop_with_stats Best reconstruct -> save_image): {seconds:.3f} s host clock, kernel "
        f"launches {develop_launches}; then postprocess_color of the image (the (H, W, 3) entry) "
        f"and a staged reconstruct develop ({STAGED_STAGES} stages) of a {BGGR_H}x{BGGR_W} "
        f"crop: launches {launches}")
    if frame.bayer.device.type != DEVICE:
        raise AssertionError("load_raw did not put the frame on the card")
    expect_launches("surface develop", develop_launches, ahd=1)
    expect_launches("surface", launches, ahd=1, homogeneity=2, postprocess=1 + STAGED_STAGES)

    # (a) The load on the card against the port's own load on the CPU, and the
    # opcode heal: every listed site changed, no other.
    on_cpu = load_raw(path, device="cpu")
    err = (frame.bayer.cpu() - on_cpu.bayer).abs().max().item()
    log(f"load_raw with OpcodeList1/2 on the card vs on the CPU: max abs {err:.3g} "
        f"(tolerance {LOAD_ATOL:g})")
    if err > LOAD_ATOL:
        raise AssertionError("the load on the card differs from the load on the CPU")
    del on_cpu
    mask = FO.bad_pixel_mask_from_opcodes(stored, block1)
    raw_ifd = T.read_tiff(path).find_raw_ifd()
    normalized = torch.from_numpy(_normalize_host(stored, *_black_white_levels(raw_ifd)))
    healed = FO.heal_bad_pixels_from_opcodes(normalized.to(DEVICE), stored, block1).cpu()
    changed = (healed != normalized).numpy()
    log(f"opcode heal: {int(mask.sum())} listed sites ({SURFACE_CONSTANT_SITES} constant, "
        f"{SURFACE_POINTS} points, {SURFACE_RECTS} rects), {int(changed[mask].sum())} of them "
        f"changed, {int(changed[~mask].sum())} unlisted sites changed")
    if not changed[mask].all() or changed[~mask].any():
        raise AssertionError("the opcode heal changed other sites than the listed ones")
    del normalized, healed, changed

    # (b) The reconstruct develop with the kernel against the plain develop.
    if tuple(out.shape) != (FULL_H, FULL_W, 3) or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"surface: output {tuple(out.shape)} is not a finite (H, W, 3)")
    p = develop_stats(f"surface {FULL_H}x{FULL_W} reconstruct develop", out,
                      develop(frame, SURFACE_PLAIN_CFG), SURFACE_MIN_PSNR)
    log(f"surface reconstruct develop: {p:.2f} dB against plain (gate {SURFACE_MIN_PSNR:g} dB)")
    if os.path.getsize(tif) < FULL_H * FULL_W * 6:
        raise AssertionError(f"{tif} is too short")
    # (c) The blown core renders below white with real variance (the JAX test's gate).
    out_clip = develop(frame, DevelopConfig(quality=QualityDemosaic.Best))
    core_px = out_clip[..., 1] > 0.995
    mean, std = out[core_px].mean().item(), out[core_px].std().item()
    log(f"blown core ({int(core_px.sum())} pixels at white in the clip develop): reconstruct "
        f"mean {mean:.4f}, std {std:.4f}; output range [{out.min().item():.4f}, "
        f"{out.max().item():.6f}]")
    if core_px.sum() <= 50 or not mean < 0.995 or not std > 1e-3:
        raise AssertionError("the reconstruct develop renders the blown core flat")
    if out.min().item() < 0.0 or out.max().item() > 1.0 + 1e-6:
        raise AssertionError("the reconstruct develop leaves [0, 1 + 1e-6]")
    del out_clip, core_px
    # (d) The statistics.
    stats_against_numpy("develop_with_stats", stats, frame.bayer, float(frame.lim_sat), out)
    # (e) The (H, W, 3) entry of the postprocess kernel against the plain stage.
    same = torch.equal(image_stage, postprocess_color(out))
    log(f"postprocess kernel's (H, W, 3) entry on the developed {FULL_H}x{FULL_W} image vs "
        f"the plain stage: bit-exact {same}")
    if not same:
        raise AssertionError("the postprocess kernel's (H, W, 3) entry differs from plain")
    del image_stage
    # (f) The staged reconstruct develop against plain, with the same gates.
    develop_stats(f"surface staged reconstruct develop {BGGR_H}x{BGGR_W}", staged,
                  develop(crop, SURFACE_STAGED_PLAIN_CFG), SURFACE_MIN_PSNR)
    del staged, crop
    # (g) The CLI: the TIFF and the stats JSON on stderr.
    cmd = [sys.executable, "-m", "pysp_tpu_torch", "develop", path, "--highlights",
           "reconstruct", "--stats", "-o", cli_tif]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600, cwd=REPO)
    if proc.returncode != 0:
        raise AssertionError(f"the CLI failed ({proc.returncode}):\n{proc.stderr}")
    cli_stats = json.loads(proc.stderr)
    keys = {k: sorted(v) for k, v in cli_stats.items()}
    with open(tif, "rb") as a, open(cli_tif, "rb") as b:
        same = a.read() == b.read()
    host = {k: {kk: vv.cpu().numpy().tolist() for kk, vv in v.items()} for k, v in stats.items()}
    log(f"CLI develop surface.dng --highlights reconstruct --stats: "
        f"{time.perf_counter() - t0:.3f} s host clock (a new process); {proc.stdout.strip()}; "
        f"stats keys {keys}, equal to the in-process stats {cli_stats == host}; TIFF "
        f"identical to the in-process one: {same}")
    if keys != STATS_KEYS or cli_stats != host:
        raise AssertionError("the CLI's --stats JSON is not the in-process statistics")
    if not same:
        raise AssertionError("the CLI's TIFF differs from the in-process path's")
    return launches, path, frame, out


def surface_at_main_shapes(path: str, frame: RawFrame, out: torch.Tensor, card: str) -> dict:
    """Phase 4 for the surface path: the load split on the host clock, the
    reconstruct develop and its stages, the AHD kernel's planes mode against
    its tail mode, ``develop_with_stats`` against ``develop``, the postprocess
    kernel's (H, W, 3) entry against its channel entry, and the device's idle
    share. Returns what the AHD and postprocess records add."""
    from pysp_tpu_torch.correct.highlights import (
        compress_highlights,
        reconstruct_highlights_channels,
    )

    # The load split: decode on the host, the mosaic to the card, the heal, the gains.
    split = {k: [] for k in ("decode", "to_card", "opcode_heal", "gains", "load_raw")}
    for _ in range(3):
        t0 = time.perf_counter()
        tf = T.read_tiff(path)
        raw_ifd = tf.find_raw_ifd()
        data = tf.read_strips(raw_ifd)
        sensor = _normalize_host(data, *_black_white_levels(raw_ifd))
        t1 = time.perf_counter()
        dev = torch.from_numpy(sensor).to(DEVICE)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        dev = FO.heal_bad_pixels_from_opcodes(dev, data, raw_ifd.get(T.TAG_OPCODE_LIST_1).as_bytes())
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        apply_gain_opcodes(dev, raw_ifd.get(T.TAG_OPCODE_LIST_2).as_bytes())
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        load_raw(path)
        torch.cuda.synchronize()
        t5 = time.perf_counter()
        for k, a, b in (("decode", t0, t1), ("to_card", t1, t2), ("opcode_heal", t2, t3),
                        ("gains", t3, t4), ("load_raw", t4, t5)):
            split[k].append((b - a) * 1e3)
    del dev, sensor, data
    log(f"surface load split, host clock, median of 3 ({card}): " + ", ".join(
        f"{k} {statistics.median(v):.3f} ms" for k, v in split.items()))

    mat = cam_to_lin_srgb_matrix(frame.cam_mat, frame.cam_white)
    wb = frame.wb_reciprocal()
    hdr = frame.is_hdr
    planes = K.ahd_kernel(frame.bayer, mat, wb, hdr, 1)
    rec = reconstruct_highlights_channels(*planes, wb, frame.lim_sat)

    def tail():
        srgb = [lin_srgb_to_srgb(compress_highlights(torch.clamp(c, min=0.0)))
                for c in color_tail_channels(*rec, mat, False, False)]
        return torch.stack(srgb, dim=-1)

    px = frame.height * frame.width
    chans = [out[..., k].contiguous() for k in range(3)]
    t = {
        "develop": median_ms(lambda: develop(frame, SURFACE_CFG)),
        "develop_plain": median_ms(lambda: develop(frame, SURFACE_PLAIN_CFG)),
        "ahd_planes": median_ms(lambda: K.ahd_kernel(frame.bayer, mat, wb, hdr, 1)),
        "reconstruct": median_ms(lambda: reconstruct_highlights_channels(*planes, wb,
                                                                         frame.lim_sat)),
        "tail": median_ms(tail),
        "ahd_tail_mode": median_ms(lambda: K.ahd_kernel(frame.bayer, mat, wb, hdr, 1,
                                                        (True, True))),
        "develop_with_stats": median_ms(lambda: develop_with_stats(frame, SURFACE_CFG)),
        "pp_image_entry": median_ms(lambda: K.postprocess_color_image_kernel(out)),
        "pp_channel_entry": median_ms(lambda: K.postprocess_color_kernel(*chans)),
        "pp_copies_channels_stack": median_ms(lambda: torch.stack(K.postprocess_color_kernel(
            *(out[..., k].contiguous() for k in range(3))), dim=-1)),
        "pp_image_plain": median_ms(lambda: postprocess_color(out)),
        "ahd_planes_plain": median_ms(lambda: K.ahd_plain(frame.bayer, mat, wb, hdr, 1),
                                      runs=3, warmup=1),
    }
    mp = px / 1e6
    log(f"surface times at {frame.height}x{frame.width} by CUDA events, median of 10 "
        f"(ahd_planes_plain: median of 3) ({card}): "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in t.items()))
    log(f"surface reconstruct develop {mp / (t['develop'] / 1e3):.2f} MP/s with the kernel, "
        f"{mp / (t['develop_plain'] / 1e3):.2f} MP/s plain; of it the AHD kernel (planes) "
        f"{t['ahd_planes']:.3f}, the reconstruction {t['reconstruct']:.3f}, the tail "
        f"{t['tail']:.3f} ms; AHD planes mode {t['ahd_planes']:.3f} vs tail mode "
        f"{t['ahd_tail_mode']:.3f} ms; develop_with_stats {t['develop_with_stats']:.3f} vs "
        f"develop {t['develop']:.3f} ms; postprocess (H, W, 3) entry {t['pp_image_entry']:.3f} "
        f"vs channel entry {t['pp_channel_entry']:.3f} ms (with the channel copies and the "
        f"stack {t['pp_copies_channels_stack']:.3f} ms) ({card})")
    host_ms, device_ms, n = device_busy(lambda: develop(frame, SURFACE_CFG))
    log(f"surface reconstruct develop under torch.profiler, 3 runs: {host_ms:.3f} ms host "
        f"clock per run, {device_ms:.3f} ms of device kernels ({n:.0f} kernels) per run, "
        f"device idle {max(0.0, 1 - device_ms / host_ms):.1%} of the host time ({card})")

    nbytes = {"ahd_planes": px * (4 + 12), "pp_image": px * (12 + 12)}
    ops = {"ahd_planes": float_ops(lambda: K.ahd_plain(frame.bayer, mat, wb, hdr, 1)),
           "pp_image": float_ops(lambda: postprocess_color(out))}
    b = {k: bound(nbytes[k], ops[k]) for k in ops}
    log("surface bounds (NVIDIA H100 SXM, 3.35 TB/s, 67 TFLOP/s float32): " + ", ".join(
        f"{k} {nbytes[k] / 1e6:.1f} MB, {ops[k] / 1e9:.2f} G ops -> {b[k][0]:.4f} ms by "
        f"{b[k][1]}" for k in ops))
    got, want = K.ahd_kernel(frame.bayer, mat, wb, hdr, 1), K.ahd_plain(frame.bayer, mat, wb, hdr, 1)
    planes_err = (got - want).abs().max().item()
    del got, want, planes, rec, chans
    return {"ahd_planes_mode": {"shape": [frame.height, frame.width], "max_abs_err": planes_err,
                                "ms": t["ahd_planes"], "plain_ms": t["ahd_planes_plain"],
                                "bound_ms": b["ahd_planes"][0], "bound_by": b["ahd_planes"][1],
                                "tail_mode_ms": t["ahd_tail_mode"], "library_ms": None},
            "image_entry": {"shape": [frame.height, frame.width, 3], "max_abs_err": 0.0,
                            "ms": t["pp_image_entry"], "plain_ms": t["pp_image_plain"],
                            "bound_ms": b["pp_image"][0], "bound_by": b["pp_image"][1],
                            "channel_entry_ms": t["pp_channel_entry"],
                            "copies_channels_stack_ms": t["pp_copies_channels_stack"],
                            "library_ms": None}}


# The formats path: every raw format the built-in decoders read, written with
# the port's own writers. The pure-Python writers (ARW, PEF, SRW) take about
# a second a megapixel, so those three files are config 5's frame size.
FORMATS_FULL = ("dng", "cr2", "mrw", "raf", "orf", "rw2", "nef")
FORMATS_SMALL = ("arw", "pef", "srw")
FORMATS_CFG = DevelopConfig(quality=QualityDemosaic.Best)
# The develop against plain on these full-range mosaics: the flip bound
# (MAX_FLIP_FRAC, whole frame and border frame) and a PSNR floor. The tie
# flips are the same class as the develop path's, larger on full-range
# content (98.41 dB measured on the MRW, 0.00077% of pixels off).
FORMATS_MIN_PSNR = 90.0
FORMATS_PLAIN_CFG = DevelopConfig(quality=QualityDemosaic.Best, use_pallas=False)
HOME_MATRIX_CACHE = os.path.join(os.path.expanduser("~"), ".cache", "pysp_tpu",
                                 "harvested_matrices.json")


def file_state(path: str):
    """(size, mtime, SHA-256) of a file, or None where there is none."""
    if not os.path.exists(path):
        return None
    with open(path, "rb") as fh:
        digest = hashlib.sha256(fh.read()).hexdigest()
    st = os.stat(path)
    return st.st_size, st.st_mtime_ns, digest


def check_native_library() -> None:
    """The native decode library must be the one built from this checkout's
    ``native/dng_fast.cc`` under ``pysp_tpu_torch/_build/``."""
    t0 = time.perf_counter()
    ok = native.available()
    seconds = time.perf_counter() - t0
    lib = native.loaded_path
    want_dir = os.path.join(REPO, "pysp_tpu_torch", "_build")
    log(f"native decode library: {lib}, loaded in {seconds:.2f} s (g++ build "
        f"{native.build_seconds:.2f} s of it, from {native.SOURCE})")
    if (not ok or os.path.dirname(lib) != want_dir
            or lib != str(native.library_path())
            or str(native.SOURCE) != os.path.join(REPO, "native", "dng_fast.cc")):
        raise AssertionError(f"the native library {lib} is not the build of "
                             f"native/dng_fast.cc under {want_dir}")


def check_stored_values(fmt: str, frame: RawFrame, stored: np.ndarray) -> str:
    """The decoded mosaic against the stored values written: lossless codecs
    give them back exactly; ARW2 within its block shift, max and min exact."""
    top = (1 << RAW_FORMATS[fmt][2]) - 1
    got = torch.round(frame.bayer.double() * top)
    want = torch.from_numpy(stored.astype(np.float64)).to(DEVICE)
    err = (got - want).abs()
    if fmt in LOSSY_RAW_FORMATS:
        bound_t = torch.from_numpy(arw2_error_bound(stored).astype(np.float64)).to(DEVICE)
        if not bool((err <= bound_t).all()):
            raise AssertionError(f"{fmt}: decoded values outside the ARW2 bound")
        return (f"within the ARW2 block bound (max error {err.max().item():.0f}, "
                f"{float((err > 0).double().mean()):.2%} of the values shifted)")
    if err.max().item() != 0.0:
        raise AssertionError(f"{fmt}: the decoded values are not the written ones")
    return "equal to the written values"


def formats_path(tmp: str, card: str):
    """Phase 3, formats: one structured mosaic in every raw format the loaders
    read -> ``load_raw`` (the card) -> ``develop(Best)`` -> ``save_image``
    (.png) and ``save_png16``; each load against the CPU's and the written
    values, each develop one AHD launch within the flip bound of plain, both
    PNGs parsed back; then the CLI's ``develop x.cr2 --bit-depth 16``,
    ``info`` on every file and ``verify-decode`` on the directory. Returns the
    launch counts."""
    from pysp_tpu_torch.cli import main as cli_main
    from pysp_tpu_torch.io.image_out import save_png16, to_uint16, to_uint8

    check_native_library()
    # The writers' synthetic bodies have no calibration rows: the loaders
    # warn once a file and use the generic Rec.709 matrices, as in JAX.
    warnings.filterwarnings("ignore", message="no color calibration")
    folder = os.path.join(tmp, "formats")
    os.makedirs(folder)
    t0 = time.perf_counter()
    mosaics = {(FULL_H, FULL_W): mosaic_rggb(make_scene(FULL_H, FULL_W, seed=17)),
               (CA_H, CA_W): mosaic_rggb(make_scene(CA_H, CA_W, seed=17))}
    log(f"formats scene mosaics {FULL_H}x{FULL_W} and {CA_H}x{CA_W}: "
        f"{time.perf_counter() - t0:.3f} s host clock")
    files = {}
    for fmt in FORMATS_FULL + FORMATS_SMALL:
        shape = (FULL_H, FULL_W) if fmt in FORMATS_FULL else (CA_H, CA_W)
        stored = raw_format_mosaic(fmt, mosaics[shape])
        t0 = time.perf_counter()
        blob = write_raw_format("pysp_tpu_torch.io", fmt, stored)
        seconds = time.perf_counter() - t0
        path = os.path.join(folder, f"shot.{fmt}")
        with open(path, "wb") as fh:
            fh.write(blob)
        files[fmt] = (path, stored)
        log(f"formats: wrote {fmt.upper()} {shape[0]}x{shape[1]} ({len(blob) / 1e6:.1f} MB) "
            f"with the port's writer in {seconds:.3f} s host clock")
    del mosaics

    zero_launch_counts()
    results = {}
    t_path = time.perf_counter()
    for fmt, (path, _) in files.items():
        before = launch_counts()
        t0 = time.perf_counter()
        frame = load_raw(path)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = develop(frame, FORMATS_CFG)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        png, png16 = (os.path.join(folder, f"shot_{fmt}{d}.png") for d in ("", "_16"))
        save_image(png, out)
        save_png16(png16, out)
        t3 = time.perf_counter()
        after = launch_counts()
        delta = {k: after[k] - before[k] for k in COUNTERS}
        expect_launches(f"formats {fmt} develop", delta, ahd=1)
        results[fmt] = (frame, out, png, png16, (t1 - t0, t2 - t1, t3 - t2))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t_path
    launches = launch_counts()
    log(f"formats path ({len(files)} files, load_raw -> develop Best -> save_image .png + "
        f"save_png16): {seconds:.3f} s host clock, kernel launches {launches}")
    expect_launches("formats", launches, ahd=len(files))

    rows = {}
    for fmt, (frame, out, png, png16, (t_load, t_dev, t_save)) in results.items():
        path, stored = files[fmt]
        h, w = stored.shape
        if frame.bayer.device.type != DEVICE:
            raise AssertionError(f"{fmt}: load_raw did not put the frame on the card")
        # (a) the card's load against the CPU's, field by field
        t0 = time.perf_counter()
        on_cpu = load_raw(path, device="cpu")
        t1 = time.perf_counter()
        moved = on_cpu.to(DEVICE)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        same = all(torch.equal(getattr(frame, k), getattr(moved, k)) for k in
                   ("bayer", "cam_mat", "cam_white", "wb_neutral", "ev", "lim_sat"))
        if not same or frame.source_pattern != on_cpu.source_pattern:
            raise AssertionError(f"{fmt}: the card's load differs from the CPU's")
        # (b) the decoded values against the written ones
        values = check_stored_values(fmt, frame, stored)
        # (c) the develop: one AHD launch (above), within the flip bound of plain
        check_image(f"formats {fmt}", out, h, w)
        p = develop_stats(f"formats {fmt.upper()} {h}x{w} develop", out,
                          develop(frame, FORMATS_PLAIN_CFG), FORMATS_MIN_PSNR)
        # (d) both PNGs parsed back with zlib
        with open(png, "rb") as fh:
            png_ok = np.array_equal(read_png(fh.read()), to_uint8(out))
        with open(png16, "rb") as fh:
            png16_ok = np.array_equal(read_png(fh.read()), to_uint16(out))
        if not (png_ok and png16_ok):
            raise AssertionError(f"{fmt}: a PNG does not read back as the image")
        dev_ms = median_ms(lambda: develop(frame, FORMATS_CFG), runs=5, warmup=1)
        rows[fmt] = {"shape": [h, w], "load_raw_s": t_load, "decode_host_s": t1 - t0,
                     "to_card_s": t2 - t1, "develop_ms": dev_ms, "develop_host_s": t_dev,
                     "png_8_and_16_s": t_save, "psnr_db": p}
        log(f"formats {fmt.upper()} {h}x{w}: load on the card equal to the CPU's; decoded "
            f"values {values}; develop {p:.2f} dB against plain; both PNGs read back equal; "
            f"load_raw {t_load:.3f} s host clock (decode on the host {t1 - t0:.3f} s, to the "
            f"card {t2 - t1:.4f} s); develop {dev_ms:.3f} ms by CUDA events (median of 5); "
            f"PNG 8 + 16 bit {t_save:.3f} s host clock ({card})")
        del on_cpu, moved
    del results

    # The CLI: develop x.cr2 --bit-depth 16 to its default x.png beside it.
    cli_dir = os.path.join(folder, "cli")
    os.makedirs(cli_dir)
    src = os.path.join(cli_dir, "x.cr2")
    with open(files["cr2"][0], "rb") as a, open(src, "wb") as b:
        b.write(a.read())
    cmd = [sys.executable, "-m", "pysp_tpu_torch", "develop", src, "--bit-depth", "16"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600, cwd=REPO)
    if proc.returncode != 0:
        raise AssertionError(f"the CLI failed ({proc.returncode}):\n{proc.stderr}")
    with open(os.path.join(cli_dir, "x.png"), "rb") as a, \
            open(os.path.join(folder, "shot_cr2_16.png"), "rb") as b:
        same = a.read() == b.read()
    log(f"CLI develop x.cr2 --bit-depth 16: {time.perf_counter() - t0:.3f} s host clock "
        f"(a new process); {proc.stdout.strip()}; its default x.png identical to the "
        f"in-process save_png16: {same}")
    if not same:
        raise AssertionError("the CLI's 16-bit PNG differs from the in-process one")

    # info on every file, verify-decode on the directory (in this process).
    for fmt, (path, stored) in files.items():
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli_main(["info", path])
        info = json.loads(buf.getvalue())
        if rc != 0 or "error" in info or info.get("size") not in (None, list(stored.shape)):
            raise AssertionError(f"info {fmt}: {info}")
        log(f"info shot.{fmt}: " + json.dumps(info, separators=(",", ":")))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(["verify-decode", folder])
    lines = buf.getvalue().splitlines()
    reports = [json.loads(line) for line in lines if line.startswith("{")]
    verdicts = {r["file"].rsplit(".", 1)[-1]: r["verdict"] for r in reports}
    table = "\n".join(line for line in lines if not line.startswith("{"))
    log(f"verify-decode {folder}: exit {rc}, verdicts {verdicts}\n{table}")
    if (rc != 0 or sorted(verdicts) != sorted(files)
            or any(v not in ("rawpy-unavailable", "match") for v in verdicts.values())):
        raise AssertionError("verify-decode found a mismatch or a built-in decode error")

    cache = os.environ["PYSP_TPU_MATRIX_CACHE"]
    with open(cache) as fh:
        bodies = sorted(json.load(fh)["bodies"])
    log(f"camera-matrix cache {cache}: bodies {bodies} (harvested by the DNG loads)")
    if "synthetic" not in bodies:
        raise AssertionError("the DNG loads harvested nothing into the matrix cache")
    log("formats summary: " + json.dumps(rows))
    return launches


DRIVERS_FILES = 8                  # 24 MP DNGs through the stream: 4 uncompressed, 4 LJ92
DRIVERS_CFG = DevelopConfig(quality=QualityDemosaic.Best)
DRIVERS_BURST = 16                 # load_burst of config 5's shape
FULL_PIPELINE_LAUNCHES = {"heal": 3, "homogeneity": 2, "postprocess": 1, "remap": 3,
                          "multisection": 3 * DETECT_PASSES}
# The differentiable example's recovery gates (tests/test_differentiable_isp.py).
ISP_LOSS_SHARE, ISP_NEUTRAL_TOL, ISP_EXPOSURE_TOL = 0.05, 0.08, 0.05


def busy_run(fn):
    """(result, host seconds, device busy seconds) of one call of ``fn`` under
    ``torch.profiler``: busy is the union of the intervals in which a kernel
    or a copy ran on the device. The profiler slows the host a little."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        host = time.perf_counter() - t0
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    if not spans:
        raise AssertionError("the profiler saw no device activity")
    busy, end = 0, spans[0][0]
    for start, stop in spans:
        if stop > end:
            busy += stop - max(start, end)
            end = stop
    return result, host, busy / 1e6


def gil_probe(name: str, fn, copies: int = 4) -> dict:
    """How far ``copies`` runs of a host function in as many threads overlap:
    their rate against one run alone (``copies`` x: the work releases the
    interpreter lock; 1 x: it holds it)."""
    from concurrent.futures import ThreadPoolExecutor

    fn()
    t0 = time.perf_counter()
    fn()
    one = time.perf_counter() - t0
    with ThreadPoolExecutor(copies) as pool:
        t0 = time.perf_counter()
        list(pool.map(lambda _: fn(), range(copies)))
        many = time.perf_counter() - t0
    log(f"drivers GIL probe, {name}: one run {one:.3f} s, {copies} runs in {copies} threads "
        f"{many:.3f} s: {copies * one / many:.2f}x one thread's rate (host clock)")
    return {"one_s": one, "threads": copies, "all_s": many, "speedup": copies * one / many}


def drivers_path(tmp: str, card: str):
    """Phase 3, drivers: eight 24 MP DNGs (four uncompressed, four LJ92)
    through ``develop_files`` (the stream: host decode, copies, develop and
    save overlapped), the sequential ``load_raw -> develop -> save_image``
    loop, ``develop_stream`` and the CLI with eight inputs; ``load_burst`` of
    16 DNGs of 1000x1504 and ``develop_burst``; the class API
    (``RawBayerDataFromRaw``) on a 24 MP DNG; both examples' ``main`` on the
    card. Returns the launch counts."""
    from examples import differentiable_isp_torch, full_pipeline_torch
    from pysp_tpu_torch import develop_burst, develop_files, develop_stream, load_burst
    from pysp_tpu_torch.compat import RawBayerDataFromRaw

    folder = os.path.join(tmp, "drivers")
    os.makedirs(folder)
    t0 = time.perf_counter()
    paths = []
    for i in range(DRIVERS_FILES):
        path = os.path.join(folder, f"d{i}.dng")
        with open(path, "wb") as fh:
            fh.write(synthetic_dng(FULL_H, FULL_W, seed=30 + i, bggr=False,
                                   compression=7 if i % 2 else 1))
        paths.append(path)
    burst_paths = []
    for i in range(DRIVERS_BURST):
        path = os.path.join(folder, f"b{i:02d}.dng")
        with open(path, "wb") as fh:
            fh.write(synthetic_dng(CA_H, CA_W, seed=50 + i, bggr=False))
        burst_paths.append(path)
    log(f"drivers: wrote {DRIVERS_FILES} DNGs of {FULL_H}x{FULL_W} (every other one LJ92) "
        f"and {DRIVERS_BURST} of {CA_H}x{CA_W} in {time.perf_counter() - t0:.3f} s host clock")

    # Which host work overlaps in threads: measured, not assumed.
    gil = {"load_raw uncompressed DNG": gil_probe(
               "load_raw of a 24 MP uncompressed DNG to the host",
               lambda: load_raw(paths[0], device="cpu")),
           "load_raw LJ92 DNG": gil_probe(
               "load_raw of a 24 MP LJ92 DNG to the host",
               lambda: load_raw(paths[1], device="cpu"))}
    probe_img = develop(load_raw(paths[0]), DRIVERS_CFG).cpu().numpy()
    probe_png = os.path.join(folder, "probe.png")
    gil["save_image 8-bit PNG"] = gil_probe("save_image of a 24 MP 8-bit PNG",
                                            lambda: save_image(probe_png, probe_img))
    del probe_img

    zero_launch_counts()
    t_path = time.perf_counter()

    def delta_since(before):
        after = launch_counts()
        return {k: after[k] - before[k] for k in COUNTERS}

    # the sequential loop, one file after another on the default stream
    seq_dir = os.path.join(folder, "sequential")
    os.makedirs(seq_dir)
    seq_images = []

    def sequential():
        for path in paths:
            out = develop(load_raw(path), DRIVERS_CFG).cpu().numpy()
            save_image(os.path.join(seq_dir, os.path.basename(path)[:-4] + ".png"), out)
            seq_images.append(out)

    before = launch_counts()
    _, seq_s, seq_busy = busy_run(sequential)
    expect_launches("drivers sequential loop", delta_since(before), ahd=DRIVERS_FILES)

    # the stream: develop_files with the default workers
    stream_dir = os.path.join(folder, "streamed")
    before = launch_counts()
    written, stream_s, stream_busy = busy_run(
        lambda: develop_files(paths, stream_dir, DRIVERS_CFG))
    expect_launches("drivers develop_files", delta_since(before), ahd=DRIVERS_FILES)
    want_written = [os.path.join(stream_dir, f"d{i}.png") for i in range(DRIVERS_FILES)]
    if written != want_written:
        raise AssertionError(f"develop_files wrote {written}, expected {want_written}")

    # develop_stream: the images themselves, in input order
    before = launch_counts()
    t0 = time.perf_counter()
    order = []
    for (src, img), want in zip(develop_stream(paths, DRIVERS_CFG), seq_images):
        order.append(src)
        if not np.array_equal(img, want):
            raise AssertionError(f"develop_stream's image of {src} differs from the "
                                 f"sequential develop")
    stream_only_s = time.perf_counter() - t0
    if order != paths:
        raise AssertionError(f"develop_stream yielded {order}, expected {paths}")
    expect_launches("drivers develop_stream", delta_since(before), ahd=DRIVERS_FILES)
    log(f"drivers develop_stream: {DRIVERS_FILES} images in input order, each equal to the "
        f"sequential develop (np.array_equal); {stream_only_s:.3f} s host clock without saves")
    del seq_images

    # load_burst and develop_burst
    before = launch_counts()
    t0 = time.perf_counter()
    burst = load_burst(burst_paths)
    torch.cuda.synchronize()
    burst_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    developed = develop_burst(burst, DRIVERS_CFG)
    torch.cuda.synchronize()
    burst_dev_s = time.perf_counter() - t0
    expect_launches("drivers load_burst + develop_burst", delta_since(before),
                    ahd=DRIVERS_BURST)
    if tuple(developed.shape) != (DRIVERS_BURST, CA_H, CA_W, 3):
        raise AssertionError(f"develop_burst gave {tuple(developed.shape)}")
    del developed

    # the reference-name class API on the first 24 MP file (its plain AHD)
    before = launch_counts()
    t0 = time.perf_counter()
    classic = lin_srgb_to_srgb(
        RawBayerDataFromRaw(paths[0]).demosaic(QualityDemosaic.Best).to_lin_srgb())
    torch.cuda.synchronize()
    classic_s = time.perf_counter() - t0
    expect_launches("drivers class API", delta_since(before))

    # the examples
    before = launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as isp_out:
        isp = differentiable_isp_torch.main()
    isp_s = time.perf_counter() - t0
    expect_launches("drivers differentiable example", delta_since(before))
    before = launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as full_out:
        full_png = full_pipeline_torch.main(os.path.join(folder, "full_pipeline"))
    full_s = time.perf_counter() - t0
    full_launches = delta_since(before)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t_path
    launches = launch_counts()
    log(f"drivers path (sequential loop, develop_files, develop_stream of {DRIVERS_FILES} "
        f"24 MP DNGs; load_burst + develop_burst of {DRIVERS_BURST}; the class API; both "
        f"examples): {seconds:.3f} s host clock, kernel launches {launches}")
    log(f"drivers full-pipeline example: kernel launches {full_launches}")
    # The example heals each of its three brackets, develops the fused frame
    # through develop_to_image, whose Best demosaic is the staged route as in
    # the JAX package (two homogeneity counts, one chroma-median stage), and
    # resamples R's CA (two remaps) and the lens warp (one).
    expect_launches("drivers full-pipeline example", full_launches, **FULL_PIPELINE_LAUNCHES)
    expect_launches("drivers", launches, ahd=3 * DRIVERS_FILES + DRIVERS_BURST,
                    **FULL_PIPELINE_LAUNCHES)

    # -- checks and comparisons (after the counts) --
    for label, a_dir in (("sequential", seq_dir), ("streamed", stream_dir)):
        for i in range(DRIVERS_FILES):
            with open(os.path.join(a_dir, f"d{i}.png"), "rb") as fh:
                blob = fh.read()
            if i == 0 and read_png(blob).shape != (FULL_H, FULL_W, 3):
                raise AssertionError(f"{label}: d0.png is not {FULL_H}x{FULL_W}x3")
    cli_dir = os.path.join(folder, "cli")
    cmd = [sys.executable, "-m", "pysp_tpu_torch", "develop", *paths, "-o", cli_dir]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600, cwd=REPO)
    cli_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"the CLI failed ({proc.returncode}):\n{proc.stderr}")
    cli_lines = proc.stdout.strip().splitlines()
    if (cli_lines[:DRIVERS_FILES] != [f"{p} -> {os.path.join(cli_dir, os.path.basename(p)[:-4])}.png"
                                      for p in paths]
            or not cli_lines[-1].endswith("(streamed)")):
        raise AssertionError(f"the CLI printed {cli_lines}")
    for i in range(DRIVERS_FILES):
        blobs = []
        for a_dir in (seq_dir, stream_dir, cli_dir):
            with open(os.path.join(a_dir, f"d{i}.png"), "rb") as fh:
                blobs.append(fh.read())
        if not blobs[0] == blobs[1] == blobs[2]:
            raise AssertionError(f"d{i}.png: the sequential, streamed and CLI PNGs differ")
    log(f"drivers: the sequential, streamed and CLI PNGs of all {DRIVERS_FILES} files are "
        f"byte-equal; CLI develop <{DRIVERS_FILES} files> -o DIR {cli_s:.3f} s host clock "
        f"(a new process; its own clock: {cli_lines[-1]})")

    ref = [load_raw(p) for p in burst_paths]
    stacked = stack_frames(ref)
    for k in ("bayer", "cam_mat", "cam_white", "wb_neutral", "ev", "lim_sat"):
        if not torch.equal(getattr(burst, k), getattr(stacked, k)):
            raise AssertionError(f"load_burst's {k} differs from the frames loaded one by one")
    if burst.source_pattern != stacked.source_pattern or burst.is_hdr != stacked.is_hdr:
        raise AssertionError("load_burst's pattern or HDR flag differs")
    t0 = time.perf_counter()
    stack_frames([load_raw(p) for p in burst_paths])
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    log(f"drivers load_burst of {DRIVERS_BURST} DNGs of {CA_H}x{CA_W}: torch.equal to "
        f"stack_frames of the frames loaded one by one on every tensor; {burst_s:.3f} s host "
        f"clock against {loop_s:.3f} s for the loop; develop_burst {burst_dev_s:.3f} s "
        f"({DRIVERS_BURST} AHD launches)")
    del burst, stacked, ref

    want_img = develop(load_raw(paths[0]), DRIVERS_CFG)
    check_image("drivers class API", classic, FULL_H, FULL_W)
    p = develop_stats(f"drivers class API (RawBayerDataFromRaw -> demosaic Best -> "
                      f"to_lin_srgb -> lin_srgb_to_srgb, the plain AHD) {FULL_H}x{FULL_W}, "
                      f"against develop with the kernel", want_img, classic, MIN_PSNR_FULL)
    del classic, want_img

    neutral_r = float(isp["params"]["neutral_rb"][0])
    with torch.no_grad():
        exposure = float(torch.mean(differentiable_isp_torch.develop_with_params(
            isp["params"], isp["frame"])[8:-8, 8:-8]))
    log(f"drivers differentiable example on the card ({isp_s:.3f} s host clock): "
        + " ".join(isp_out.getvalue().split()) + f"; developed mean {exposure:.4f}")
    if not (isp["loss"] < ISP_LOSS_SHARE * isp["loss_initial"]
            and abs(neutral_r - isp["neutral_true"][0]) < ISP_NEUTRAL_TOL
            and abs(exposure - 0.5) < ISP_EXPOSURE_TOL):
        raise AssertionError("the differentiable example did not recover the neutral and gain")
    with open(full_png, "rb") as fh:
        full_img = read_png(fh.read())
    log(f"drivers full-pipeline example on the card ({full_s:.3f} s host clock): "
        + "; ".join(full_out.getvalue().strip().splitlines()))
    if full_img.shape != (256, 256, 3):
        raise AssertionError(f"the full-pipeline example wrote {full_img.shape}")

    rows = {"files": DRIVERS_FILES, "shape": [FULL_H, FULL_W],
            "sequential_s": seq_s, "streamed_s": stream_s,
            "sequential_files_per_s": DRIVERS_FILES / seq_s,
            "streamed_files_per_s": DRIVERS_FILES / stream_s,
            "sequential_device_busy_s": seq_busy, "streamed_device_busy_s": stream_busy,
            "sequential_busy_share": seq_busy / seq_s, "streamed_busy_share": stream_busy / stream_s,
            "develop_stream_s": stream_only_s, "cli_s": cli_s, "load_burst_s": burst_s,
            "load_loop_s": loop_s, "class_api_s": classic_s, "class_api_psnr_db": p,
            "differentiable_s": isp_s, "full_pipeline_s": full_s, "gil": gil,
            "path_s": seconds}
    log(f"drivers: streamed {DRIVERS_FILES / stream_s:.3f} files/s ({stream_s:.3f} s host "
        f"clock, device busy {stream_busy:.3f} s, {stream_busy / stream_s:.2%}) against "
        f"sequential {DRIVERS_FILES / seq_s:.3f} files/s ({seq_s:.3f} s, device busy "
        f"{seq_busy:.3f} s, {seq_busy / seq_s:.2%}), both under torch.profiler ({card})")
    if not stream_s < seq_s:
        raise AssertionError(f"the stream ({stream_s:.3f} s) is not faster than the "
                             f"sequential loop ({seq_s:.3f} s)")
    log("drivers summary: " + json.dumps(rows))
    return launches


# --- the parallel path: the mesh (parallel/) with its shards on one card ---------------

PAR_ATOL = 3e-5                    # the JAX tests' gate for a sharded frame
PAR_MIN_PSNR = 40.0                # a row-sharded frame as a whole, edges included
PAR_HOT = (60, 40, 25)             # hot sites in all 16 frames, in frames 0-7, in one frame each
# (b): the chain's CA and warp at half strength. The sharded path takes a CA
# model only within 24 px of static displacement (Poly3(0.01) is 31 px at
# 102 MP) and a warp only within displacement_bounds' cap, as in JAX.
PAR_CA_K1 = CA_K1 / 2
PAR_WARP = [(1.0025, -0.005, 0.001, 0.0, 0.00015, -0.0001)] * 3
PAR_CFG5 = PipelineConfig(develop=CA_CFG, repair_hot_pixels=True, hot_pixel_shared_ratio=0.5)
PAR_CFG102 = PipelineConfig(develop=CA_CFG, repair_hot_pixels=True)
PAR_TIMING = {"runs": 3, "warmup": 1}


def card_mesh(shape):
    """A mesh whose every position is card 0: the shards share the card, each
    on its own stream."""
    return make_mesh(shape, [torch.device(DEVICE, 0)] * (shape[0] * shape[1]))


def hot_burst(burst: RawFrame):
    """``burst`` with 500 hot sites at full scale on a 16-px grid: 60 in every
    frame, 40 in frames 0-7 only (half the burst: kept by a 0.5 consensus
    only when shards' counts add up) and 25 in each frame alone. At most
    31 a plane in a frame, under the detector's 1e-4 quantile share of a
    1000x1504 frame's 376 k sites a plane (37)."""
    n, h, w = burst.bayer.shape
    persistent, semi, single = PAR_HOT
    grid = [(y, x) for y in range(16, h - 16, 16) for x in range(16, w - 16, 16)]
    rng = np.random.default_rng(23)
    picks = rng.choice(len(grid), persistent + semi + single * n, replace=False)
    frames, ys, xs = [], [], []
    for k, i in enumerate(picks):
        y, x = grid[i][0] + k % 2, grid[i][1] + (k // 2) % 2   # every CFA plane in turn
        if k < persistent:
            which = range(n)
        elif k < persistent + semi:
            which = range(n // 2)
        else:
            which = [(k - persistent - semi) // single]
        for f in which:
            frames.append(f)
            ys.append(y)
            xs.append(x)
    bayer = burst.bayer.clone()
    bayer[torch.tensor(frames, device=DEVICE), torch.tensor(ys, device=DEVICE),
          torch.tensor(xs, device=DEVICE)] = 1.0
    return burst.replace(bayer=bayer), len(picks)


def config5_unsharded(burst: RawFrame, block: bytes):
    """(a)'s counterpart: ``develop_pipeline``'s consensus masks and heal
    frame by frame, ``remove_ca_from_raw`` over the burst, then each frame's
    ``develop`` and ``apply_opcode_3_warp``, unsharded on the card. Returns
    the (N, H, W, 3) images and the consensus masks."""
    from pysp_tpu_torch.pipeline.pipeline import _correct_one

    model = Poly3CorrectionModel(CA_K1)
    frames = unstack_frames(burst)
    need = float(np.ceil(np.float32(len(frames) * PAR_CFG5.hot_pixel_shared_ratio)))
    shared = sum(find_erroneous_pixels_median(f).to(torch.int32) for f in frames) >= need
    healed = [_correct_one(f, PAR_CFG5, None, None, shared) for f in frames]
    corrected = remove_ca_from_raw(stack_frames(healed, device=DEVICE), model, model)
    return torch.stack([apply_opcode_3_warp(develop(f, CA_CFG), block)
                        for f in unstack_frames(corrected)]), shared


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).abs().max())


def sharded_beside(name: str, sharded, unsharded) -> dict:
    """CUDA-event times (median of 3 after 1) of a sharded call and its
    unsharded counterpart, and each one's device-busy share under
    ``torch.profiler`` (one run)."""
    t = {"sharded_ms": median_ms(sharded, **PAR_TIMING),
         "unsharded_ms": median_ms(unsharded, **PAR_TIMING)}
    for key, fn in (("sharded", sharded), ("unsharded", unsharded)):
        _, host, dev = busy_run(fn)
        t[f"{key}_busy"] = dev / host
    log(f"parallel {name}: sharded {t['sharded_ms']:.3f} ms, unsharded "
        f"{t['unsharded_ms']:.3f} ms by CUDA events (median of 3); device busy "
        f"{t['sharded_busy']:.1%} sharded, {t['unsharded_busy']:.1%} unsharded "
        f"(torch.profiler, one run)")
    return t


def parallel_path(card: str, burst5: RawFrame, block5: bytes, burst4: RawFrame,
                  rgb102: np.ndarray, hot102: np.ndarray):
    """The ninth main path, parallel: ``pysp_tpu_torch.parallel`` on meshes
    whose positions all name card 0, each phase's launches counted alone:
    (a) config 5 batch-sharded, (b) the 102 MP chain row-sharded and a 24 MP
    Best develop row-sharded, (c) config 4 as a collective fuse, (d) the burst
    develops, (e) both sharded examples. Returns the path's launch counts
    (the phases' sum) and what the records and PERF.md take."""
    from examples import burst_production_torch, large_frame_sharded_torch
    from pysp_tpu_torch import develop_burst
    from pysp_tpu_torch.parallel.pipeline_sharded import (develop_hdr_sharded,
                                                          develop_pipeline_sharded)
    from pysp_tpu_torch.parallel.spatial import (develop_burst_sharded,
                                                 develop_burst_spatial, develop_spatial)
    from pysp_tpu_torch.parallel.spatial_pipeline import (_ca_setup, _warp_setup,
                                                          develop_frame_spatial,
                                                          required_spatial_halo)

    t_path = time.perf_counter()
    total = dict.fromkeys(COUNTERS, 0)
    out = {"times": {}}

    def counted(phase: str, fn, **expected):
        zero_launch_counts()
        result = fn()
        torch.cuda.synchronize()
        got = launch_counts()
        log(f"parallel ({phase}) kernel launches {got}")
        expect_launches(f"parallel ({phase})", got, **expected)
        for k in COUNTERS:
            total[k] += got[k]
        return result

    # (a) Config 5, batch-sharded over four shards of the card.
    model = Poly3CorrectionModel(CA_K1)
    hot5, n_sites = hot_burst(burst5)
    mesh_a = card_mesh((4, 1))

    def sharded_a():
        return develop_pipeline_sharded(hot5, mesh_a, PAR_CFG5, ca_model_r=model,
                                        ca_model_b=model, warp_block=block5)

    got = counted("a", sharded_a, heal=CA_FRAMES, remap=4 * 4 + CA_FRAMES, ahd=CA_FRAMES,
                  multisection=DETECT_PASSES * CA_FRAMES, eag_resample=4 * CA_RESAMPLES)
    want, shared = config5_unsharded(hot5, block5)
    errs = [max_abs(g, w_) for g, w_ in zip(got, want)]
    log(f"parallel (a): config 5 with {n_sites} hot sites ({int(shared.sum())} sites in the "
        f"consensus masks) through develop_pipeline_sharded on a (4, 1) mesh of one card; "
        f"each frame against the unsharded composition: max abs {max(errs):.3g} "
        f"(gate {PAR_ATOL:g})")
    if max(errs) > PAR_ATOL or not bool(torch.isfinite(got).all()):
        raise AssertionError("a batch-sharded config 5 frame differs from the unsharded one")
    out["a_max_abs"] = max(errs)
    del got, want
    out["times"]["config5"] = sharded_beside(
        f"(a) config 5, {CA_FRAMES} x {CA_H}x{CA_W}, (4, 1) mesh", sharded_a,
        lambda: config5_unsharded(hot5, block5))

    # (b) The 102 MP frame, row-sharded over four shards; the full CA and warp
    # are refused on the host, as in JAX, before any launch.
    mesh_b = card_mesh((1, 4))
    full_block = encode_warp_rectilinear(CA_WARP, (0.5, 0.5))
    pblock = encode_warp_rectilinear(PAR_WARP, (0.5, 0.5))
    mosaic = ca_mosaic(rgb102, PAR_CA_K1, PAR_CA_K1)
    mosaic[hot102[:, 0], hot102[:, 1]] = 1.0
    frame = RawFrame.synthetic(mosaic, cam_mat=CAM, wb_neutral=WB, device=DEVICE)
    del mosaic
    pmodel = Poly3CorrectionModel(PAR_CA_K1)
    for label, kw in (("Poly3(0.01)", dict(ca_model_r=model, ca_model_b=model,
                                            warp_block=pblock)),
                      ("the chain's warp", dict(ca_model_r=pmodel, ca_model_b=pmodel,
                                                 warp_block=full_block))):
        try:
            develop_frame_spatial(frame, mesh_b, PAR_CFG102, **kw)
        except ValueError as err:
            log(f"parallel (b): {label} at 102 MP refused as in JAX: {err}")
        else:
            raise AssertionError(f"the sharded path took {label} at 102 MP")
    halo = required_spatial_halo(
        PAR_CFG102, (_ca_setup(pmodel, CHAIN_H, CHAIN_W),) * 2,
        _warp_setup(pblock, CHAIN_H, CHAIN_W, 1.0, "lanczos4"), "lanczos4")

    def sharded_b():
        return develop_frame_spatial(frame, mesh_b, PAR_CFG102, ca_model_r=pmodel,
                                     ca_model_b=pmodel, warp_block=pblock)

    def unsharded_b():
        healed = repair_bad_pixels(frame, find_erroneous_pixels_median(frame))
        return apply_opcode_3_warp(develop(remove_ca_from_raw(healed, pmodel, pmodel),
                                           CA_CFG), pblock)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    got = counted("b, 102 MP", sharded_b, heal=4, remap=4 * 5, ahd=4,
                  multisection=DETECT_PASSES * 4, eag_resample=4 * CA_RESAMPLES)
    out["peak_gb_102mp"] = torch.cuda.max_memory_allocated() / 1e9
    want = unsharded_b()
    err = max_abs(got[halo:-halo], want[halo:-halo])
    p = psnr(got.double().cpu().numpy(), want.double().cpu().numpy())
    off = ((got - want).abs().amax(dim=-1) > PAR_ATOL)[halo:-halo].nonzero()
    if len(off):
        rows = sorted({int(r) + halo for r in off[:, 0]})
        log(f"parallel (b): {len(off)} pixels beyond the halo off by > {PAR_ATOL:g}, in "
            f"{len(rows)} rows (first {rows[:12]}; shard boundaries every "
            f"{CHAIN_H // 4} rows); the unsharded detector flags "
            f"{int(find_erroneous_pixels_median(frame).sum())} sites")
    log(f"parallel (b): {CHAIN_H}x{CHAIN_W} with {len(hot102)} hot sites, Poly3({PAR_CA_K1}) "
        f"CA and the warp {PAR_WARP[0]} (Lanczos4) through develop_frame_spatial on a (1, 4) "
        f"mesh, halo {halo} rows; against the unsharded chain: rows beyond the halo max abs "
        f"{err:.3g} (gate {PAR_ATOL:g}), whole frame {p:.2f} dB (gate {PAR_MIN_PSNR:g}); "
        f"peak device memory {out['peak_gb_102mp']:.2f} GB")
    if err > PAR_ATOL or p < PAR_MIN_PSNR or not bool(torch.isfinite(got).all()):
        raise AssertionError("the row-sharded 102 MP chain is outside its gates")
    out["b_max_abs"], out["b_psnr"], out["b_halo"] = err, p, halo
    del got, want
    out["times"]["chain_102mp"] = sharded_beside(
        "(b) 102 MP chain, (1, 4) mesh", sharded_b, unsharded_b)
    del frame

    frame24 = frame_on_card(FULL_H, FULL_W, seed=41, is_hdr=False)
    got = counted("b, 24 MP Best", lambda: develop_spatial(frame24, CA_CFG, mesh_b), ahd=4)
    want = develop(frame24, CA_CFG)
    err = max_abs(got[16:-16], want[16:-16])
    p = psnr(got.double().cpu().numpy(), want.double().cpu().numpy())
    log(f"parallel (b): {FULL_H}x{FULL_W} Best through develop_spatial on a (1, 4) mesh "
        f"(halo 16): rows beyond the halo max abs {err:.3g} (gate {PAR_ATOL:g}), whole "
        f"frame {p:.2f} dB")
    if err > PAR_ATOL or p < PAR_MIN_PSNR:
        raise AssertionError("the row-sharded 24 MP develop is outside its gates")
    out["b24_max_abs"] = err
    del got, want
    out["times"]["develop_24mp"] = sharded_beside(
        "(b) 24 MP Best develop, (1, 4) mesh", lambda: develop_spatial(frame24, CA_CFG, mesh_b),
        lambda: develop(frame24, CA_CFG))
    del frame24

    # (c) Config 4: the fuse as a collective over five shards, the develop
    # over two.
    mesh_c = card_mesh((BRACKETS, 2))
    got = counted("c", lambda: develop_hdr_sharded(burst4, mesh_c, CFG4),
                  heal=BRACKETS * 2, ahd=BRACKETS * 2, multisection=DETECT_PASSES * BRACKETS * 2)
    want = develop_pipeline(burst4, CFG4)
    err = max_abs(got[16:-16], want[16:-16])
    p = psnr(got.double().cpu().numpy(), want.double().cpu().numpy())
    log(f"parallel (c): config 4 ({BRACKETS}x{FULL_H}x{FULL_W}) through develop_hdr_sharded "
        f"on a ({BRACKETS}, 2) mesh against develop_pipeline(fuse_hdr): rows beyond the halo "
        f"max abs {err:.3g} (gate {PAR_ATOL:g}), whole frame {p:.2f} dB")
    if err > PAR_ATOL or p < PAR_MIN_PSNR:
        raise AssertionError("the sharded config 4 is outside its gates")
    out["c_max_abs"], out["c_psnr"] = err, p
    del got, want
    out["times"]["config4"] = sharded_beside(
        f"(c) config 4, ({BRACKETS}, 2) mesh", lambda: develop_hdr_sharded(burst4, mesh_c, CFG4),
        lambda: develop_pipeline(burst4, CFG4))

    # (d) The burst develops.
    mesh_d1, mesh_d2 = card_mesh((4, 1)), card_mesh((2, 2))
    got1 = counted("d, batch", lambda: develop_burst_sharded(burst5, CA_CFG, mesh_d1),
                   ahd=CA_FRAMES)
    got2 = counted("d, batch x spatial",
                   lambda: develop_burst_spatial(burst5, CA_CFG, mesh_d2), ahd=2 * CA_FRAMES)
    want = develop_burst(burst5, CA_CFG)
    e1, e2 = max_abs(got1, want), max_abs(got2[:, 16:-16], want[:, 16:-16])
    log(f"parallel (d): develop_burst_sharded on (4, 1), every frame against develop_burst: "
        f"max abs {e1:.3g}; develop_burst_spatial on (2, 2), rows beyond the halo (16): max "
        f"abs {e2:.3g} (gate {PAR_ATOL:g})")
    if max(e1, e2) > PAR_ATOL or got1.device.type != DEVICE:
        raise AssertionError("a sharded burst develop differs from develop_burst")
    out["d_max_abs"] = [e1, e2]
    del got1, got2, want
    out["times"]["burst_sharded"] = sharded_beside(
        "(d) develop_burst_sharded, (4, 1) mesh",
        lambda: develop_burst_sharded(burst5, CA_CFG, mesh_d1),
        lambda: develop_burst(burst5, CA_CFG))
    out["times"]["burst_spatial"] = sharded_beside(
        "(d) develop_burst_spatial, (2, 2) mesh",
        lambda: develop_burst_spatial(burst5, CA_CFG, mesh_d2),
        lambda: develop_burst(burst5, CA_CFG))

    # (e) Both sharded examples' main on the card (one card: (1, 1) meshes).
    with tempfile.TemporaryDirectory() as tmp:
        imgs = counted("e, burst example", lambda: burst_production_torch.main(tmp), remap=4,
                       eag_resample=CA_RESAMPLES)
        pngs = [f for f in os.listdir(tmp) if f.startswith("out_")]
        if imgs.device.type != DEVICE or len(pngs) != 4:
            raise AssertionError("the burst example did not develop on the card and write 4 PNGs")
    img, err = counted("e, large-frame example", large_frame_sharded_torch.main,
                       heal=2, remap=10, ahd=2, multisection=DETECT_PASSES * 2,
                       eag_resample=2 * CA_RESAMPLES)
    log(f"parallel (e): both examples' main on the card: 4 PNGs; the large frame "
        f"{tuple(img.shape)}, interior {err:.3g} from its monolithic pipeline")
    out["seconds"] = time.perf_counter() - t_path
    log(f"parallel path with its checks and times: {out['seconds']:.3f} s host clock; "
        f"kernel launches {total}")
    return total, out


def shard_stack_bilinear(burst: RawFrame) -> dict:
    """B4's bilinear kind at the shape each (4, 1) shard of config 5 gives it:
    the four frames' upsampled greens (4, 1000, 1504) with shared maps,
    against its plain version, its bound and ``grid_sample``."""
    model = Poly3CorrectionModel(CA_K1)
    _, g1, _, g2 = bayer_to_rgbg(burst.bayer[:4])
    g = resample_g_to_full_resolution(g1, g2)
    n, h, w = g.shape
    mx, my = ca_removal._maps_from_offsets(model.get_undistorted_coordinates(g[0]), h, w)
    if not torch.equal(K.remap_kernel(g, mx, my, "bilinear"), K.remap_plain(g, mx, my, "bilinear")):
        raise AssertionError("the bilinear remap at the shard-stack shape differs from plain")
    grid = torch.stack([mx / (w - 1) * 2 - 1, my / (h - 1) * 2 - 1], dim=-1)[None]
    nbytes = n * h * w * 4 * 2 + h * w * 8
    b = bound(nbytes, float_ops(lambda: K.remap_plain(g, mx, my, "bilinear")))

    def kernel():
        return K.remap_kernel(g, mx, my, "bilinear")

    def grid_sample():
        return F.grid_sample(g[None], grid, mode="bilinear", padding_mode="border",
                             align_corners=True)

    rec = {"shape": [n, h, w], "max_abs_err": 0.0, "ms": median_ms(kernel),
           "queued_ms": queued_ms(kernel),
           "plain_ms": median_ms(lambda: K.remap_plain(g, mx, my, "bilinear")),
           "bound_ms": b[0], "bound_by": b[1], "library_ms": median_ms(grid_sample),
           "library_queued_ms": queued_ms(grid_sample),
           "library": "torch.nn.functional.grid_sample"}
    log(f"bilinear CA remap at the shard-stack shape {n}x{h}x{w}, maps shared: bit-exact "
        f"against plain; kernel {rec['ms']:.4f} ms a lone call ({rec['ms'] / b[0]:.2f}x), "
        f"{rec['queued_ms']:.4f} ms back to back, plain {rec['plain_ms']:.4f} ms, bound "
        f"{b[0]:.4f} ms by {b[1]}, grid_sample {rec['library_ms']:.4f} ms a lone call (the "
        f"kernel at {rec['ms'] / rec['library_ms']:.2f}x), {rec['library_queued_ms']:.4f} ms "
        f"back to back (the kernel at {rec['queued_ms'] / rec['library_queued_ms']:.2f}x)")
    return rec


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device: torch.cuda.is_available() is False")
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    # Every DNG load harvests its calibration rows into the persistent camera-
    # matrix cache: keep this run's in a scratch file, never in the user's.
    home_cache = file_state(HOME_MATRIX_CACHE)
    matrix_cache = tempfile.TemporaryDirectory(prefix="pysp_matrix_cache_")
    os.environ["PYSP_TPU_MATRIX_CACHE"] = os.path.join(matrix_cache.name,
                                                       "harvested_matrices.json")

    t0 = time.perf_counter()
    K.load_library()
    log(f"kernels built and loaded in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {K.build_seconds:.2f} s)")
    log("ptxas report:\n" + "\n".join(
        line for line in K.build_log.splitlines() if "ptxas" in line or "spill" in line))

    check_kernels_small()
    check_staged_kernels_small()
    with tempfile.TemporaryDirectory() as tmp:
        develop_launches, frame = main_path(tmp)
        finishing_launches, lin, srgb, block = finishing_path(tmp)
        corrections_launches, *corrections_state = corrections_path(tmp)
        tiers_launches, *tiers_state = tiers_path(tmp)
        ca_launches, burst5, block5 = ca_path(tmp)
        surface_launches, *surface_state = surface_path(tmp, card)
        surface = surface_at_main_shapes(*surface_state, card)
        del surface_state
        formats_launches = formats_path(tmp, card)
        t0 = time.perf_counter()
        drivers_launches = drivers_path(tmp, card)
        log(f"drivers path with its checks: {time.perf_counter() - t0:.3f} s host clock")
    records = kernels_at_main_shapes(frame, lin, srgb, block)
    del frame, lin, srgb
    records.append(corrections_at_main_shapes(*corrections_state))
    records.append(multisection_at_main_shapes(corrections_state[3]))
    burst4 = corrections_state[2]
    del corrections_state
    records.extend(tiers_at_main_shapes(*tiers_state))
    del tiers_state
    ca = ca_at_main_shapes(burst5, block5)
    ca["shard_stack_bilinear"] = shard_stack_bilinear(burst5)
    rgb102 = make_scene(CHAIN_H, CHAIN_W, seed=31)
    _, hot102 = chain_102mp(rgb102)
    records.append(eag_at_main_shapes(burst5, rgb102))
    parallel_launches, parallel = parallel_path(card, burst5, block5, burst4, rgb102, hot102)
    del burst5, burst4, rgb102
    for rec in records:
        if rec["name"] == "ahd":
            rec["ca_frame"] = ca["ahd_ca_frame"]
            rec["planes_mode"] = surface["ahd_planes_mode"]
        elif rec["name"] == "postprocess_color":
            rec["image_entry"] = surface["image_entry"]
        elif rec["name"] == "remap_lanczos4":
            rec["ca_bilinear"] = ca["ca_bilinear"]
            rec["shard_stack_bilinear"] = ca["shard_stack_bilinear"]
    # Each path's counts were set to 0 just before it and read just after it;
    # "launches" is their sum, "launches_by_path" each path's own.
    for rec in records:
        counter = rec.pop("counter")
        by_path = {"develop": develop_launches[counter],
                   "finishing": finishing_launches[counter],
                   "corrections": corrections_launches[counter],
                   "tiers": tiers_launches[counter],
                   "ca": ca_launches[counter],
                   "surface": surface_launches[counter],
                   "formats": formats_launches[counter],
                   "drivers": drivers_launches[counter],
                   "parallel": parallel_launches[counter]}
        rec["launches"] = sum(by_path.values())
        rec["launches_by_path"] = by_path

    if file_state(HOME_MATRIX_CACHE) != home_cache:
        raise AssertionError(f"the run created or changed {HOME_MATRIX_CACHE}")
    log(f"{HOME_MATRIX_CACHE}: neither created nor changed by the run")
    matrix_cache.cleanup()

    log("parallel path results: " + json.dumps(parallel))
    # Each record's kernel time against its bound and against the library call
    # that computes its function, where there is one (a reading, not a gate:
    # sub-millisecond times move 10-60% between calls).
    for rec in records:
        parts = [(rec["name"], rec)] + [(f"{rec['name']} {key}", sub) for key, sub in rec.items()
                                        if isinstance(sub, dict) and "bound_ms" in sub]
        for label, r in parts:
            lib, name = r.get("library_ms"), r.get("library", "the library call")
            line = (f"{label}: {r['ms']:.4f} ms, {r['ms'] / r['bound_ms']:.2f}x its bound by "
                    f"{r['bound_by']}, " + (f"{r['ms'] / lib:.2f}x {name} ({lib:.4f} ms)"
                                            if lib else "no library call"))
            if "queued_ms" in r:
                line += (f"; back to back {r['queued_ms']:.4f} ms, "
                         f"{r['queued_ms'] / r['bound_ms']:.2f}x its bound")
                if r.get("library_queued_ms"):
                    line += (f", {r['queued_ms'] / r['library_queued_ms']:.2f}x {name} "
                             f"({r['library_queued_ms']:.4f} ms)")
            log(line)
    log(json.dumps({"kernels": records}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
