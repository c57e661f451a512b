"""Command-line develop: ``python -m pysp_tpu_torch develop shot.dng -o out.png``.

Counterpart of ``pysp_tpu/cli.py``, in the JAX CLI's order and branches:

- ``--hdr`` with several inputs: load -> stack -> (``--params``: the sidecar's
  WB neutral and CA models applied to every frame before the fuse) ->
  ``develop_pipeline`` (per-frame corrections, then the Bayer-domain fuse,
  then develop) -> the filters -> save as ``<first input>_hdr.png``; with
  ``--repair-hot-pixels`` the masks are the burst's consensus
  (``hot_pixel_shared_ratio=0.5``);
- otherwise: load (``--temperature``: the frame rebuilt with the WB solved for
  that colour temperature) -> the sidecar's WB neutral (``--params``) -> CA
  (the sidecar's models, or a fit: ``--ca template|gradient|refine``) ->
  ``--save-params`` -> then ``--flat`` / ``--dark``: ``develop_pipeline``
  (dark, flat, heal, denoise); else heal (``--repair-hot-pixels``) -> denoise
  (``--denoise``) -> develop (``--stats``: the sensor and output statistics
  printed to stderr as JSON) -> the linear-light filters (``--deconv``,
  ``--unsharp``, ``--blur``) -> clip and sRGB gamma -> the DNG OpcodeList3
  warp (``--warp``) -> save, by default as ``<input stem>.png`` beside the
  input (``--bit-depth 16``: a 16-bit PNG; a ``.tif`` output is always 16-bit).

``--highlights reconstruct`` rebuilds clipped channels before the colour
tail; a DNG's OpcodeList1 / OpcodeList2 apply at load.

A sidecar's temperature replays through the ``--temperature`` branch, as in
the JAX CLI. The image stays on the device from the load to the save.

``info`` prints a raw file's metadata as JSON, ``harvest`` pulls DNGs' real
ColorMatrix1/2 rows into the persistent camera-matrix cache, and
``verify-decode`` cross-decodes files with the built-in codecs and rawpy.

The JAX CLI takes its device from JAX's backend; this one takes ``--device``
(``develop``, ``info`` and ``verify-decode``), ``cuda`` unless asked otherwise,
and raises without a GPU. Several inputs without ``--hdr`` (the streamed
develop) parse as in the JAX CLI and raise ``NotImplementedError`` naming its
ROADMAP.md item.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from .correct.ca.removal import remove_ca_from_raw
from .utils.sidecar import ca_model_from_dict, ca_model_to_dict, load_sidecar, save_sidecar


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="pysp_tpu_torch", description=__doc__)
    sub = p.add_subparsers(dest="command", required=True)

    dev = sub.add_parser("develop", help="develop a raw file to an sRGB image")
    dev.add_argument("inputs", nargs="+",
                     help="raw file path (DNG/CR2/NEF/ARW/RW2/ORF/RAF/PEF/MRW/SRW "
                          "built in; others via rawpy); several with --hdr")
    dev.add_argument("-o", "--output", help="output path (.png, .tif, .jpg) or directory")
    dev.add_argument("--device", default="cuda",
                     help="torch device to develop on (default: cuda)")
    dev.add_argument("--quality", choices=["draft", "fast", "best"], default="best")
    dev.add_argument("--postprocess", type=int, default=1,
                     help="AHD chroma-median stages (best quality only)")
    dev.add_argument("--no-gamma", action="store_true",
                     help="emit linear sRGB instead of gamma-encoded")
    dev.add_argument("--highlights", choices=["clip", "reconstruct"], default="clip")
    dev.add_argument("--temperature", type=float, default=None)
    dev.add_argument("--repair-hot-pixels", action="store_true")
    dev.add_argument("--denoise", type=float, default=0.0, metavar="STRENGTH")
    dev.add_argument("--ca", nargs="?", const="template", default=None,
                     choices=["template", "gradient", "refine"])
    dev.add_argument("--warp", action="store_true",
                     help="apply the file's embedded DNG OpcodeList3 "
                          "rectilinear warp to the output")
    dev.add_argument("--unsharp", metavar="AMOUNT[:RADIUS]",
                     help="Oklab-L unsharp mask on the linear image "
                          "(default radius 2.0)")
    dev.add_argument("--deconv", metavar="SIGMA[:ITERS]",
                     help="Richardson-Lucy luma deconvolution on the linear "
                          "image (default 20 iterations)")
    dev.add_argument("--blur", type=float, metavar="SIGMA",
                     help="Gaussian blur on the linear image")
    dev.add_argument("--hdr", action="store_true")
    dev.add_argument("--flat")
    dev.add_argument("--dark")
    dev.add_argument("--stats", action="store_true")
    dev.add_argument("--bit-depth", type=int, choices=[8, 16], default=8,
                     help="output sample depth: 16 writes 16-bit PNGs via the "
                          "native fast writer (TIFF output is always 16-bit)")
    dev.add_argument("--save-params", metavar="FILE")
    dev.add_argument("--params", metavar="FILE")

    info = sub.add_parser("info", help="print raw metadata")
    info.add_argument("input")
    info.add_argument("--device", default="cuda",
                      help="torch device of the loads some formats need (default: cuda)")

    hv = sub.add_parser(
        "harvest",
        help="pull REAL per-body ColorMatrix1/2 calibration out of DNG file(s) "
             "or directory tree(s) into the persistent registry cache, so "
             "native-format loads (CR2/NEF/ARW/...) of the same bodies stop "
             "using estimated StdA matrices; prints estimate-vs-real deltas",
    )
    hv.add_argument("inputs", nargs="+", help="DNG file(s) and/or directories")

    vd = sub.add_parser(
        "verify-decode",
        help="cross-decode file(s) with the built-in codec AND rawpy/libraw "
             "and report bit/PSNR parity + metadata diffs (first-contact "
             "codec validation; exits 1 on any mismatch)",
    )
    vd.add_argument("inputs", nargs="+",
                    help="raw file path(s) and/or directories (directories are "
                         "swept recursively for known raw extensions; sweep "
                         "mode prints one JSON line per file plus a per-format "
                         "summary table)")
    vd.add_argument("--device", default="cuda",
                    help="torch device to decode onto (default: cuda)")
    return p


def _refuse_unported(args) -> None:
    """Raise ``NotImplementedError`` for a develop flag that is not ported."""
    if len(args.inputs) > 1 and not args.hdr:
        raise NotImplementedError(
            "several inputs (the streamed develop) is not ported to pysp_tpu_torch "
            "yet (ROADMAP.md queue A, item 15: pipeline/stream.py)"
        )


def _split_spec(spec, default_second):
    parts = str(spec).split(":")
    return float(parts[0]), (float(parts[1]) if len(parts) > 1 else default_second)


def _dst_for(args, src: str) -> str:
    if args.output is None:
        return os.path.splitext(src)[0] + ".png"
    if os.path.isdir(args.output):
        return os.path.join(args.output, os.path.splitext(os.path.basename(src))[0] + ".png")
    return args.output


def _save_output(args, dst: str, img) -> None:
    from .io.image_out import save_image, save_png16

    if args.bit_depth == 16 and dst.lower().endswith(".png"):
        save_png16(dst, img)
    else:
        save_image(dst, img)


def _apply_filters(args, out: torch.Tensor) -> torch.Tensor:
    """The linear-light filters, then clip and gamma unless ``--no-gamma``."""
    from .colorimetry.transforms import lin_srgb_to_srgb
    from .filters.blur import blur_gaussian
    from .filters.sharpen import gaussian_rt_deconvolution_yuv, unsharp_mask_lab

    if args.deconv:
        sigma, iters = _split_spec(args.deconv, 20.0)
        out = gaussian_rt_deconvolution_yuv(out, sigma, int(iters))
    if args.unsharp:
        amount, radius = _split_spec(args.unsharp, 2.0)
        out = unsharp_mask_lab(out, radius, amount)
    if args.blur is not None:
        out = blur_gaussian(out, args.blur)
    if not args.no_gamma:
        out = lin_srgb_to_srgb(torch.clamp(out, 0.0, 1.0))
    return out


def _apply_warp(out: torch.Tensor, src: str) -> torch.Tensor:
    from .io.metadata import get_opcode_3_block
    from .warp.opcodes import apply_opcode_3_warp

    block = get_opcode_3_block(src)
    if block is None:
        print(f"{src}: no OpcodeList3 block; --warp skipped", file=sys.stderr)
        return out
    return apply_opcode_3_warp(out, block)


def _finish(args, out: torch.Tensor, filtering: bool, device, t0: float, dst: str,
            label: str, warp_src=None) -> int:
    """The filters, the warp of ``warp_src``'s OpcodeList3 (the HDR path has
    none), save and report."""
    if filtering:
        out = _apply_filters(args, out)
    if warp_src is not None and args.warp:
        out = _apply_warp(out, warp_src)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t0
    _save_output(args, dst, out)
    mp = out.shape[0] * out.shape[1] / 1e6
    print(f"{label} -> {dst}  ({mp:.1f} MP, {dt * 1e3:.0f} ms)")
    return 0


def _develop(args) -> int:
    from . import (
        DevelopConfig,
        PipelineConfig,
        QualityDemosaic,
        develop,
        develop_pipeline,
        develop_with_stats,
        find_erroneous_pixels_median,
        load_raw,
        repair_bad_pixels,
        stack_frames,
    )
    from .core.device import resolve_device

    _refuse_unported(args)
    device = resolve_device(args.device)
    quality = {
        "draft": QualityDemosaic.Draft,
        "fast": QualityDemosaic.Fast,
        "best": QualityDemosaic.Best,
    }[args.quality]
    filtering = bool(args.unsharp or args.deconv or args.blur is not None)
    cfg = DevelopConfig(
        quality=quality,
        postprocess_stages=args.postprocess,
        # The filters work on LINEAR sRGB; gamma is applied after them.
        gamma_encode=not args.no_gamma and not filtering,
        highlights=args.highlights,
    )

    aux = {}
    if args.flat or args.dark or args.hdr:
        if args.flat:
            aux["flat"] = load_raw(args.flat, device=device)
        if args.dark:
            aux["dark"] = load_raw(args.dark, device=device)
        pcfg = PipelineConfig(
            develop=cfg,
            dark_frame=args.dark is not None,
            flat_field=args.flat is not None,
            repair_hot_pixels=args.repair_hot_pixels,
            hot_pixel_shared_ratio=0.5 if (args.hdr and args.repair_hot_pixels) else None,
            denoise_strength=args.denoise,
            fuse_hdr=args.hdr,
        )

    if args.hdr:
        if args.save_params:
            print("--save-params does nothing with --hdr (no fit runs); ignored",
                  file=sys.stderr)
        t0 = time.time()
        batch = stack_frames([load_raw(src, device=device) for src in args.inputs],
                             device=device)
        if args.params:
            # the saved WB and CA apply per frame BEFORE the fuse (canonical
            # sensor-space order: corrections precede HDR stacking)
            sidecar = load_sidecar(args.params)
            if sidecar["wb_neutral"] is not None:
                batch = batch.replace(wb_neutral=_neutral(sidecar, device).expand_as(
                    batch.wb_neutral).contiguous())
            batch = remove_ca_from_raw(batch, sidecar["ca_model_r"], sidecar["ca_model_b"])
        out = develop_pipeline(batch, pcfg, **aux)
        dst = args.output or os.path.splitext(args.inputs[0])[0] + "_hdr.png"
        return _finish(args, out, filtering, device, t0, dst,
                       f"{len(args.inputs)} frames (HDR)")

    src = args.inputs[0]
    t0 = time.time()
    sidecar = load_sidecar(args.params) if args.params else None
    if args.temperature is None and sidecar is not None:
        args.temperature = sidecar["temperature_k"]
    frame = load_raw(src, device=device)
    if args.temperature is not None:
        frame = _frame_at_temperature(src, frame, args.temperature, device)
    elif sidecar is not None and sidecar["wb_neutral"] is not None:
        # restore the saved camera neutral exactly (WB gains = 1/neutral)
        frame = frame.replace(wb_neutral=_neutral(sidecar, device))

    frame, fitted = _remove_ca(args, src, frame, sidecar)
    if args.save_params:
        save_sidecar(args.save_params, ca_model_r=fitted[0], ca_model_b=fitted[1],
                     wb_neutral=frame.wb_neutral.cpu().numpy().astype(np.float64),
                     temperature=args.temperature)
        print(f"develop parameters -> {args.save_params}", file=sys.stderr)

    if args.flat or args.dark:
        out = develop_pipeline(frame, pcfg, **aux)
    else:
        if args.repair_hot_pixels:
            frame = repair_bad_pixels(frame, find_erroneous_pixels_median(frame))
        if args.denoise > 0.0:
            from .correct.denoise import denoise_bayer_wavelet

            frame = denoise_bayer_wavelet(frame, args.denoise)
        if args.stats:
            out, stats = develop_with_stats(frame, cfg)
            host_stats = {k: {kk: vv.cpu().numpy().tolist() for kk, vv in v.items()}
                          for k, v in stats.items()}
            print(json.dumps(host_stats, indent=2), file=sys.stderr)
        else:
            out = develop(frame, cfg)
    return _finish(args, out, filtering, device, t0, _dst_for(args, src), src, warp_src=src)


def _neutral(sidecar, device) -> torch.Tensor:
    return torch.tensor(np.asarray(sidecar["wb_neutral"], np.float32), device=device)


def _frame_at_temperature(src: str, frame, temperature: float, device):
    """The frame rebuilt with the WB solved for ``temperature`` (Kelvin):
    the source's controller, updated, then ``frame_from_parts`` from the
    un-canonicalized mosaic (it canonicalizes again from the source pattern)."""
    from .core.bayer import reversible_transform_rggb
    from .io.raw_loader import controller_for_source, frame_from_parts

    ctrl = controller_for_source(src, frame)
    ctrl.update_by_temperature(temperature, allow_cross_blend=True)
    sensor = reversible_transform_rggb(frame.bayer, frame.source_pattern).cpu().numpy()
    return frame_from_parts(sensor, frame.source_pattern, ctrl, float(frame.ev),
                            device=device)


def _remove_ca(args, src: str, frame, sidecar):
    """CA removal with the sidecar's models, or with the models that ``--ca``
    fits; returns the frame and the models applied (``(None, None)`` if none)."""
    if sidecar is not None and (sidecar["ca_model_r"] is not None
                                or sidecar["ca_model_b"] is not None):
        # saved coefficients: apply without re-fitting (sidecar workflow)
        models = (sidecar["ca_model_r"], sidecar["ca_model_b"])
        return remove_ca_from_raw(frame, *models), models
    if not args.ca:
        return frame, (None, None)

    from .correct.ca.gradfit import fit_ca_models_gradient, refine_ca_models_gradient
    from .correct.ca.removal import compute_ca_lens_models_for_raw

    if args.ca == "gradient":
        models = fit_ca_models_gradient(frame)
    else:
        try:
            models = compute_ca_lens_models_for_raw(frame)
        except ValueError as e:
            # e.g. "Not enough tiles": a featureless scene stays untouched
            print(f"{src}: CA fit failed ({e}); --ca skipped", file=sys.stderr)
            return frame, (None, None)
        if args.ca == "refine":
            models = refine_ca_models_gradient(frame, *models)
    if args.save_params:
        # apply each model exactly as the sidecar will replay it (coefficients
        # through their JSON float form), so that the fit's develop and a
        # --params replay are bit-identical
        models = tuple(ca_model_from_dict(ca_model_to_dict(m)) for m in models)
    return remove_ca_from_raw(frame, *models), models


def _info(args) -> int:
    import struct

    from .io import tiff as T
    from .io.arw import is_arw
    from .io.cr2 import _find_raw_ifd, is_cr2
    from .io.cr3 import cr3_info, is_cr3
    from .io.metadata import (
        compute_ev_from_tiff,
        exif_get_as_shot_neutral,
        exif_get_color_mat_sources,
        get_image_area_from_tiff,
        get_opcode_3_block,
    )
    from .io.mrw import BLOCK_PRD, BLOCK_TTW, _parse_blocks, _Prd, is_mrw, load_raw_mrw
    from .io.mrw import _read_source as _mrw_read
    from .io.nef import is_nef
    from .io.orf import is_orf
    from .io.pef import is_pef
    from .io.raf import _read_source, is_raf, load_raw_raf
    from .io.raw_loader import load_raw
    from .io.rw2 import is_rw2
    from .io.srw import is_srw

    # metadata needs no device: only the formats whose neutral comes from a
    # decode load a frame (onto --device)
    device = args.device

    def neutral(frame):
        return frame.wb_neutral.cpu().numpy().tolist()

    if is_cr3(args.input):
        # metadata-only: the CRX payload needs libraw (see io/cr3.py)
        out = cr3_info(args.input)
        out["raw_decode"] = "rawpy/libraw required (CRX codec)"
        print(json.dumps(out, indent=2))
        return 0

    if is_mrw(args.input):
        # MRW is a block directory, not a TIFF: report from the PRD block
        # + loader-extracted metadata
        data = _mrw_read(args.input)
        out = {"format": "MRW"}
        try:
            blocks, _ = _parse_blocks(data)
            prd = _Prd(blocks[BLOCK_PRD]) if BLOCK_PRD in blocks else None
            if prd is not None:
                out["size"] = [prd.ccd_h, prd.ccd_w]
            ttw = blocks.get(BLOCK_TTW)
            if ttw is not None:
                tf = T.read_tiff(ttw)
                model = tf.ifds[0].get(T.TAG_MODEL) if tf.ifds else None
                if model is not None:
                    out["model"] = (
                        model.as_bytes().split(b"\x00")[0].decode("ascii", "replace")
                    )
            frame = load_raw_mrw(args.input, device=device)
            out["as_shot_neutral"] = neutral(frame)
            out["ev"] = float(frame.ev)
        except ValueError as e:
            out["error"] = str(e)
        print(json.dumps(out, indent=2))
        return 0

    if is_raf(args.input):
        # RAF is a proprietary directory, not a TIFF: report from its
        # embedded TIFF + loader-extracted metadata
        data = _read_source(args.input)
        out = {"format": "RAF"}
        out["model"] = data[0x1C:0x3C].split(b"\x00")[0].decode("ascii", "replace").strip()
        off, ln = struct.unpack_from(">LL", data, 100)
        try:
            frame = load_raw_raf(args.input, device=device)
            out["size"] = list(frame.bayer.shape)
            out["as_shot_neutral"] = neutral(frame)
            out["ev"] = float(frame.ev)
        except ValueError as e:
            out["error"] = str(e)
            out["ev"] = compute_ev_from_tiff(bytes(data[off : off + ln]))
        print(json.dumps(out, indent=2))
        return 0

    tf = T.read_tiff(args.input)
    out = {}
    if is_cr2(args.input):
        out["format"] = "CR2"
        raw = _find_raw_ifd(tf)
    else:
        out["format"] = (
            "NEF" if is_nef(args.input)
            else "ARW" if is_arw(args.input)
            else "RW2" if is_rw2(args.input)
            else "ORF" if is_orf(args.input)
            else "PEF" if is_pef(args.input)
            else "SRW" if is_srw(args.input)
            else "DNG/TIFF"
        )
        raw = tf.find_raw_ifd()
    model = tf.ifds[0].get(T.TAG_MODEL) if tf.ifds else None
    if model is not None:
        out["model"] = model.as_bytes().split(b"\x00")[0].decode("ascii", "replace")
    if raw is not None and raw.get(T.TAG_IMAGE_LENGTH) is not None:
        out["size"] = [
            raw.get(T.TAG_IMAGE_LENGTH).as_ints()[0],
            raw.get(T.TAG_IMAGE_WIDTH).as_ints()[0],
        ]
        cfa = raw.get(T.TAG_CFA_PATTERN)
        if cfa is not None:
            out["cfa"] = list(cfa.as_bytes() if isinstance(cfa.values, bytes)
                              else cfa.as_ints())[:4]
    out["ev"] = compute_ev_from_tiff(args.input)
    active, crop = get_image_area_from_tiff(args.input)
    out["active_area"] = active
    out["crop"] = crop
    try:
        out["as_shot_neutral"] = np.asarray(exif_get_as_shot_neutral(tf)).tolist()
    except KeyError:
        out["as_shot_neutral"] = None
    if out["as_shot_neutral"] is None and out["format"] in (
        "CR2", "NEF", "ARW", "RW2", "ORF", "PEF", "SRW"
    ):
        # MakerNote formats carry WB outside the DNG EXIF tags; the format
        # loaders extract it: decode and report the frame's neutral
        try:
            out["as_shot_neutral"] = neutral(load_raw(args.input, device=device))
        except (ValueError, KeyError):
            pass
    out["n_color_matrices"] = len(exif_get_color_mat_sources(tf))
    out["has_opcode_list_3"] = get_opcode_3_block(args.input) is not None
    print(json.dumps(out, indent=2))
    return 0


def _verify_decode(args) -> int:
    from .core.device import resolve_device
    from .io.verify_decode import (
        BAD_VERDICTS,
        iter_raw_files,
        summary_table,
        sweep_decode,
        verify_decode,
    )

    device = resolve_device(args.device)
    # directories expand recursively (first-contact sweep: point this at a
    # photo tree the day rawpy + real files exist and read the table)
    if any(os.path.isdir(p) for p in args.inputs):
        paths = []
        for p in args.inputs:
            paths.extend(iter_raw_files(p) if os.path.isdir(p) else [p])
        reports, summary = sweep_decode(paths, device=device)
        for report in reports:
            print(json.dumps(report, separators=(",", ":")))
        print()
        print(summary_table(summary))
        # mismatch AND builtin decode failures flip the exit code (intentional
        # rawpy fall-throughs are classified "no-builtin" and stay green)
        return 1 if any(r["verdict"] in BAD_VERDICTS for r in reports) else 0

    reports = [verify_decode(path, name=path, device=device) for path in args.inputs]
    print(json.dumps(reports if len(reports) > 1 else reports[0], indent=2))
    return 1 if any(r["verdict"] in BAD_VERDICTS for r in reports) else 0


def _harvest(args) -> int:
    from .io.camera_matrices import harvest_camera_matrices_from_dng
    from .io.matrix_cache import _read_cache_file, cache_path
    from .io.verify_decode import iter_raw_files

    dng_exts = (".dng", ".tif", ".tiff")
    paths = []
    for p in args.inputs:
        if os.path.isdir(p):
            paths.extend(
                f for f in iter_raw_files(p)
                if os.path.splitext(f)[1].lower() in dng_exts
            )
        else:
            paths.append(p)

    results = []
    harvested_models = set()
    for path in paths:
        row = {"file": path}
        try:
            model, mats = harvest_camera_matrices_from_dng(path, source_name=path)
            row["model"] = model
            row["n_matrices"] = len(mats)
            harvested_models.add(model)
        except (ValueError, KeyError, OSError) as e:
            row["skipped"] = f"{type(e).__name__}: {e}"
        results.append(row)
        print(json.dumps(row, separators=(",", ":")))

    # deltas come back off the persisted cache: the evidence the harvest left
    bodies = _read_cache_file(cache_path())
    for model in sorted(harvested_models):
        deltas = bodies.get(model, {}).get("estimate_vs_real")
        if deltas:
            print(json.dumps({"model": model, "estimate_vs_real": deltas}))
    print(
        f"harvested {len(harvested_models)} bodies from "
        f"{sum('model' in r for r in results)}/{len(results)} files "
        f"-> {cache_path()}"
    )
    return 0 if harvested_models or not paths else 1


def main(argv=None) -> int:
    args = _build_parser().parse_args(argv)
    if args.command == "develop":
        return _develop(args)
    if args.command == "info":
        return _info(args)
    if args.command == "verify-decode":
        return _verify_decode(args)
    if args.command == "harvest":
        return _harvest(args)
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
