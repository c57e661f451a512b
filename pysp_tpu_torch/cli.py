"""Command-line develop: ``python -m pysp_tpu_torch develop shot.dng -o out.tif``.

Counterpart of ``pysp_tpu/cli.py``, in the JAX CLI's order and branches:

- ``--hdr`` with several inputs: load -> stack -> (``--params``: the sidecar's
  WB neutral and CA models applied to every frame before the fuse) ->
  ``develop_pipeline`` (per-frame corrections, then the Bayer-domain fuse,
  then develop) -> the filters -> save as ``<first input>_hdr.tif``; with
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
  warp (``--warp``) -> save.

``--highlights reconstruct`` rebuilds clipped channels before the colour
tail; a DNG's OpcodeList1 / OpcodeList2 apply at load.

A sidecar's temperature replays through the ``--temperature`` branch, as in
the JAX CLI. The image stays on the device from the load to the save.

The JAX CLI takes its device from JAX's backend; this one takes ``--device``,
``cuda`` unless asked otherwise, and raises without a GPU. Every flag and
subcommand that is not ported yet (several inputs without ``--hdr``,
``info``, ``harvest``, ``verify-decode``) parses as in the JAX CLI and raises
``NotImplementedError`` naming its ROADMAP.md item; so does an output format
other than TIFF (through ``save_image``).
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
                     help="raw file path (uncompressed DNG); several with --hdr")
    dev.add_argument("-o", "--output", help="output path (.tif) or directory")
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
                     help="PNG sample depth (TIFF output is always 16-bit)")
    dev.add_argument("--save-params", metavar="FILE")
    dev.add_argument("--params", metavar="FILE")

    info = sub.add_parser("info", help="print raw metadata (not ported yet)")
    info.add_argument("input")
    for name in ("harvest", "verify-decode"):
        sub.add_parser(name, help="not ported yet").add_argument("inputs", nargs="+")
    return p


# Subcommands that are not ported, with the ROADMAP.md item that ports them.
_SUBCOMMAND_ITEMS = {
    "info": "queue A, item 15 (the host-only subcommands)",
    "harvest": "queue A, item A5 (the camera-matrix autoharvest)",
    "verify-decode": "queue A, item A6 (the other-format decoders)",
}


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
    name = os.path.splitext(os.path.basename(src))[0] + ".tif"
    if args.output is None:
        return os.path.join(os.path.dirname(src), name)
    if os.path.isdir(args.output):
        return os.path.join(args.output, name)
    return args.output


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
    from . import save_image

    if filtering:
        out = _apply_filters(args, out)
    if warp_src is not None and args.warp:
        out = _apply_warp(out, warp_src)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t0
    save_image(dst, out)
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
        dst = args.output or os.path.splitext(args.inputs[0])[0] + "_hdr.tif"
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


def main(argv=None) -> int:
    args = _build_parser().parse_args(argv)
    if args.command == "develop":
        return _develop(args)
    raise NotImplementedError(
        f"the {args.command!r} subcommand is not ported to pysp_tpu_torch yet "
        f"(ROADMAP.md {_SUBCOMMAND_ITEMS[args.command]})"
    )


if __name__ == "__main__":
    raise SystemExit(main())
