"""Cross-decode a raw file with the built-in codec AND rawpy/libraw, and diff.

First-contact codec validation (VERDICT r3 item 5): the built-in decoders were
developed offline against hand-built bitstream vectors — round-trip-perfect
codecs can still garble real camera files (the round-2 RW2 ``^ 0x3ff0``
byte-addressing bug is the proof). The moment a real file or a libraw copy is
reachable, this harness turns it into evidence: decode the same bytes through
both stacks and report bit/PSNR parity plus metadata diffs per file.

Reference anchor: libraw is the reference's only decode path
(reference/image.py:224); our built-ins replace it, so libraw is the
natural cross-check oracle wherever rawpy imports.

CLI: ``python -m pysp_tpu_torch verify-decode shot.cr2 [...]`` — one JSON report per
file; exit 1 if any file mismatches, 0 for matches (rawpy unavailable =>
verdict "rawpy-unavailable", still exit 0: absence of the oracle is not a
failure).

Counterpart of ``pysp_tpu/io/verify_decode.py``: both decodes land on
``device`` (the card unless the caller asks for another) and are compared on
the host.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.device import CARD

Source = Any  # str path or bytes

# every container the loaders (or the rawpy gate) know how to open; the sweep
# walks directory trees and picks up exactly these, case-insensitively
RAW_EXTENSIONS = frozenset(
    {
        ".dng",
        ".tif",
        ".tiff",
        ".cr2",
        ".cr3",
        ".nef",
        ".nrw",
        ".arw",
        ".orf",
        ".rw2",
        ".raw",
        ".raf",
        ".pef",
        ".mrw",
        ".srw",
    }
)


# match verdict gate: built-in and libraw may legitimately differ in black-level
# handling conventions (documented per-format in DIVERGENCES.md), so beyond
# bit-equality a high-PSNR match still counts as parity.
PSNR_MATCH_DB = 60.0


def _detect(source: Source):
    """(format name, builtin loader or None) following load_raw's dispatch order."""
    from .arw import is_arw, load_raw_arw
    from .cr2 import is_cr2, load_raw_cr2
    from .cr3 import is_cr3
    from .mrw import is_mrw, load_raw_mrw
    from .nef import is_nef, load_raw_nef
    from .orf import is_orf, load_raw_orf
    from .pef import is_pef, load_raw_pef
    from .raf import is_raf, load_raw_raf
    from .rw2 import is_rw2, load_raw_rw2
    from .srw import is_srw, load_raw_srw

    probes = [
        ("CR2", is_cr2, load_raw_cr2),
        ("MRW", is_mrw, load_raw_mrw),
        ("CR3", is_cr3, None),  # CRX pixels are rawpy-only by design (io/cr3.py)
        ("RAF", is_raf, load_raw_raf),
        ("ARW", is_arw, load_raw_arw),
        ("ORF", is_orf, load_raw_orf),
        ("RW2", is_rw2, load_raw_rw2),
        ("PEF", is_pef, load_raw_pef),
        ("SRW", is_srw, load_raw_srw),
    ]
    for name, probe, loader in probes:
        try:
            hit = probe(source)
        except (ValueError, OSError):
            hit = False
        if hit:
            return name, loader

    try:
        if is_nef(source):
            return "NEF", load_raw_nef
    except (ValueError, OSError):
        pass

    # DNG/TIFF: a cheap header probe (raw IFD present) instead of a full
    # decode — verify_decode itself decodes right after, so probing by
    # load_raw_dng would decode every file twice
    from . import tiff as T
    from .raw_loader import load_raw_dng

    try:
        tf = T.read_tiff(source)
        if tf.find_raw_ifd() is not None:
            return "DNG", load_raw_dng
    except Exception:
        pass
    return "unknown", None


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def _frame_summary(frame) -> Dict[str, Any]:
    return {
        "shape": list(frame.bayer.shape),
        "pattern": getattr(frame.source_pattern, "name", str(frame.source_pattern)),
        "as_shot_neutral": _host(frame.wb_neutral).round(6).tolist(),
        "ev": round(float(frame.ev), 4),
    }


def verify_decode(
    source: Source, name: Optional[str] = None, device=CARD
) -> Dict[str, Any]:
    """Decode ``source`` with the built-in codec and with rawpy onto ``device``;
    diff the results.

    Returns a JSON-ready report. ``verdict`` is one of:
    - ``"match"``: pixel grids agree bit-exactly or above PSNR_MATCH_DB;
    - ``"mismatch"``: shapes/patterns/pixels disagree — a codec bug on one side;
    - ``"rawpy-unavailable"``: no oracle importable (report carries builtin side);
    - ``"no-builtin"``: rawpy-only format (CR3/X-Trans/...), nothing to diff;
    - ``"builtin-error"`` / ``"rawpy-error"``: one side failed to decode.
    """
    fmt, loader = _detect(source)
    report: Dict[str, Any] = {"file": name or "<bytes>", "format": fmt}

    # ValueErrors load_raw deliberately routes to rawpy (raw_loader.py
    # fall-throughs): a working, INTENTIONAL gate, not a codec failure
    _FALLTHROUGH_MARKERS = (
        "not supported",          # RAF X-Trans / Super-CCD layouts
        "unsupported compression",  # ARW lossless (7), SRW samsung2/3
        "unsupported RawFormat",  # RW2 v5+ payloads
    )

    builtin = rawpy_frame = None
    fallthrough = False
    if loader is None:
        report["builtin"] = {
            "ok": False,
            "reason": "no built-in decoder for this format",
        }
        fallthrough = True
    else:
        try:
            builtin = loader(source, device=device)
            report["builtin"] = {"ok": True, **_frame_summary(builtin)}
        except ValueError as e:
            fallthrough = any(m in str(e) for m in _FALLTHROUGH_MARKERS)
            report["builtin"] = {
                "ok": False,
                "reason": f"{type(e).__name__}: {e}",
                "rawpy_fallthrough_by_design": fallthrough,
            }
        except Exception as e:  # report, don't crash the harness
            report["builtin"] = {"ok": False, "reason": f"{type(e).__name__}: {e}"}

    try:
        import rawpy  # type: ignore  # noqa: F401

        have_rawpy = True
    except ImportError:
        have_rawpy = False

    if not have_rawpy:
        report["rawpy"] = {"ok": False, "reason": "rawpy not importable"}
        report["verdict"] = (
            "rawpy-unavailable"
            if builtin is not None
            else ("no-builtin" if fallthrough else "builtin-error")
        )
        return report

    from .raw_loader import load_raw_rawpy

    try:
        rawpy_frame = load_raw_rawpy(source, strict=False, device=device)
        report["rawpy"] = {"ok": True, **_frame_summary(rawpy_frame)}
    except Exception as e:
        report["rawpy"] = {"ok": False, "reason": f"{type(e).__name__}: {e}"}

    if builtin is None or rawpy_frame is None:
        report["verdict"] = (
            "no-builtin"
            if fallthrough and rawpy_frame is not None
            else ("builtin-error" if builtin is None else "rawpy-error")
        )
        return report

    a = _host(builtin.bayer).astype(np.float64)
    b = _host(rawpy_frame.bayer).astype(np.float64)
    parity: Dict[str, Any] = {}
    if a.shape != b.shape:
        parity["shape_mismatch"] = [list(a.shape), list(b.shape)]
        report["parity"] = parity
        report["verdict"] = "mismatch"
        return report
    if builtin.source_pattern != rawpy_frame.source_pattern:
        parity["pattern_mismatch"] = [
            report["builtin"]["pattern"],
            report["rawpy"]["pattern"],
        ]

    diff = np.abs(a - b)
    n_diff = int(np.count_nonzero(diff))
    parity["pixels_differ"] = n_diff
    parity["pixels_total"] = int(a.size)
    parity["max_abs_diff"] = float(diff.max()) if a.size else 0.0
    if n_diff == 0:
        parity["psnr_db"] = None  # bit-exact
        parity["bit_equal"] = True
    else:
        mse = float(np.mean(diff**2))
        parity["psnr_db"] = round(10.0 * np.log10(1.0 / mse), 2) if mse else None
        parity["bit_equal"] = False
    parity["neutral_max_diff"] = float(
        np.abs(
            _host(builtin.wb_neutral).astype(np.float64)
            - _host(rawpy_frame.wb_neutral).astype(np.float64)
        ).max()
    )
    parity["ev_diff"] = float(abs(float(builtin.ev) - float(rawpy_frame.ev)))
    report["parity"] = parity

    pixels_ok = parity["bit_equal"] or (
        parity["psnr_db"] is not None and parity["psnr_db"] >= PSNR_MATCH_DB
    )
    report["verdict"] = (
        "match" if pixels_ok and "pattern_mismatch" not in parity else "mismatch"
    )
    return report


def iter_raw_files(root: str) -> Iterator[str]:
    """Yield raw-container files under ``root`` (recursive, sorted, by extension)."""
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames.sort()
        for fn in sorted(filenames):
            if os.path.splitext(fn)[1].lower() in RAW_EXTENSIONS:
                yield os.path.join(dirpath, fn)


# exit-code-flipping verdicts: a decode disagreement or a built-in codec crash
# on a file the oracle reads (intentional rawpy fall-throughs stay green)
BAD_VERDICTS = ("mismatch", "builtin-error")


def sweep_decode(
    paths: Sequence[str], device=CARD
) -> Tuple[List[Dict[str, Any]], Dict[str, Dict[str, int]]]:
    """verify_decode every path; return (reports, per-format verdict counts).

    The directory-sweep workhorse behind ``python -m pysp_tpu_torch verify-decode
    <dir>`` — the one-command first-contact harness (VERDICT r4 item 7): the
    first environment with rawpy + real camera files runs this over a tree and
    gets codec evidence per format with zero thought.
    """
    reports: List[Dict[str, Any]] = []
    summary: Dict[str, Dict[str, int]] = {}
    for path in paths:
        try:
            report = verify_decode(path, name=path, device=device)
        except Exception as e:  # harness must never die mid-tree
            report = {
                "file": path,
                "format": "unknown",
                "verdict": "builtin-error",
                "builtin": {"ok": False, "reason": f"{type(e).__name__}: {e}"},
            }
        reports.append(report)
        fmt = report.get("format", "unknown")
        summary.setdefault(fmt, {})
        verdict = report.get("verdict", "builtin-error")
        summary[fmt][verdict] = summary[fmt].get(verdict, 0) + 1
    return reports, summary


def summary_table(summary: Dict[str, Dict[str, int]]) -> str:
    """Human-readable per-format verdict table for the sweep report."""
    verdicts = sorted({v for row in summary.values() for v in row})
    if not verdicts:
        return "no raw files found"
    wfmt = max([len("format")] + [len(f) for f in summary])
    header = "format".ljust(wfmt) + "  " + "  ".join(
        v.rjust(max(len(v), 5)) for v in verdicts
    ) + "  total"
    lines = [header, "-" * len(header)]
    totals = {v: 0 for v in verdicts}
    for fmt in sorted(summary):
        row = summary[fmt]
        cells = []
        for v in verdicts:
            n = row.get(v, 0)
            totals[v] += n
            cells.append(str(n).rjust(max(len(v), 5)))
        lines.append(
            fmt.ljust(wfmt) + "  " + "  ".join(cells) + f"  {sum(row.values()):5d}"
        )
    lines.append(
        "TOTAL".ljust(wfmt)
        + "  "
        + "  ".join(str(totals[v]).rjust(max(len(v), 5)) for v in verdicts)
        + f"  {sum(totals.values()):5d}"
    )
    return "\n".join(lines)
