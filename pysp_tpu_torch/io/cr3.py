"""Canon CR3 container support — metadata layer only.

The reference opens CR3 through libraw (reference/image.py:224). CR3
is an ISO base media (MP4-family) container; the raw payload is CRX-coded —
a Canon-proprietary subband codec whose published documentation is a single
reverse-engineered implementation. This module deliberately implements ONLY
what can be built faithfully from the container spec:

- ISO-BMFF box walking (u32 sizes, ``size == 1`` u64 largesize,
  ``size == 0`` to-end), the Canon metadata ``uuid`` box
  (85c0b687-820f-11e0-8111-f4ce462b6a48) inside ``moov``, and its CNCV
  version string + CMT1-4 payloads. Each CMTn is a complete little-endian
  TIFF in its own address space: CMT1 = IFD0 (Make/Model), CMT2 = the Exif
  IFD (exposure triplet -> EV), CMT3 = the MakerNote IFD (ColorData 0x4001
  -> as-shot WB_RGGB levels, same blob the CR2 decoder parses), CMT4 = GPS.
- ``cr3_info`` surfaces model/EV/WB for the CLI; ``load_raw_cr3`` raises a
  clear "CRX decode not supported" error and load_raw routes CR3 files to
  the rawpy gate.

Implementing CRX itself from memory would be guesswork validated only by a
mirror encoder — worse than an honest gate (DIVERGENCES.md). If rawpy is
present, CR3s decode through libraw exactly as the reference does.
"""
from __future__ import annotations

import struct
from typing import Dict, Iterator, Optional, Tuple, Union

import numpy as np

from ..core.device import CARD
from . import tiff as T

Source = Union[str, bytes]

CANON_META_UUID = bytes.fromhex("85c0b687820f11e08111f4ce462b6a48")


def _read_source(source: Source) -> bytes:
    if isinstance(source, str):
        with open(source, "rb") as f:
            return f.read()
    return bytes(source)


def is_cr3(source: Source) -> bool:
    """CR3: an ISO-BMFF whose ftyp major brand is 'crx '."""
    if isinstance(source, str):
        with open(source, "rb") as f:
            head = f.read(16)
    else:
        head = bytes(source[:16])
    return len(head) >= 12 and head[4:8] == b"ftyp" and head[8:12] == b"crx "


def _walk_boxes(data: bytes, start: int, end: int) -> Iterator[Tuple[bytes, int, int]]:
    """Yield (type, payload_start, payload_end) for each box in [start, end)."""
    pos = start
    while pos + 8 <= end:
        (size,) = struct.unpack_from(">L", data, pos)
        btype = data[pos + 4 : pos + 8]
        payload = pos + 8
        if size == 1:
            if payload + 8 > end:
                return
            (size,) = struct.unpack_from(">Q", data, payload)
            payload += 8
            if size < 16:
                return
            box_end = pos + size
        elif size == 0:
            box_end = end
        else:
            if size < 8:
                return
            box_end = pos + size
        if box_end > end or payload > box_end:
            return
        yield btype, payload, box_end
        pos = box_end


def parse_cr3_meta(data: bytes) -> Dict[str, bytes]:
    """{'CNCV': version bytes, 'CMT1'..'CMT4': TIFF payloads} from the Canon
    uuid box inside moov."""
    out: Dict[str, bytes] = {}
    for btype, p, e in _walk_boxes(data, 0, len(data)):
        if btype != b"moov":
            continue
        for ityp, ip, ie in _walk_boxes(data, p, e):
            if ityp != b"uuid" or ie - ip < 16:
                continue
            if data[ip : ip + 16] != CANON_META_UUID:
                continue
            for mtyp, mp, me in _walk_boxes(data, ip + 16, ie):
                key = mtyp.decode("ascii", "replace")
                if key in ("CNCV", "CMT1", "CMT2", "CMT3", "CMT4", "THMB"):
                    out[key] = data[mp:me]
    return out


def cr3_info(source: Source) -> Dict[str, object]:
    """Model / EV / as-shot WB from the CMT metadata blocks."""
    from .cr2 import MN_COLOR_DATA, _wb_neutral_from_colordata
    from .metadata import compute_ev_from_tiff

    data = _read_source(source)
    if not is_cr3(data):
        raise ValueError("not a CR3 (ftyp/crx brand missing)")
    meta = parse_cr3_meta(data)
    out: Dict[str, object] = {"format": "CR3"}
    if "CNCV" in meta:
        out["codec_version"] = meta["CNCV"].decode("ascii", "replace")
    cmt1 = meta.get("CMT1")
    if cmt1:
        try:
            tf = T.read_tiff(cmt1)
            model = tf.ifds[0].get(T.TAG_MODEL) if tf.ifds else None
            if model is not None:
                out["model"] = (
                    model.as_bytes().split(b"\x00")[0].decode("ascii", "replace")
                )
        except (ValueError, struct.error):
            pass
    cmt2 = meta.get("CMT2")
    if cmt2:
        ev = compute_ev_from_tiff(cmt2)
        if np.isfinite(ev):
            out["ev"] = float(ev)
    cmt3 = meta.get("CMT3")
    if cmt3:
        try:
            tf3 = T.read_tiff(cmt3)
            cd = tf3.ifds[0].get(MN_COLOR_DATA) if tf3.ifds else None
            if cd is not None:
                neutral = _wb_neutral_from_colordata([int(v) for v in cd.as_ints()])
                if neutral is not None:
                    out["as_shot_neutral"] = neutral.tolist()
        except (ValueError, struct.error):
            pass
    return out


def load_raw_cr3(source: Source):
    """CR3 raw decode is NOT built in: the CRX codec has no published spec.

    Raises with a clear message; load_raw routes CR3 to the rawpy/libraw
    gate, which is exactly the reference's own path for this format."""
    info = cr3_info(source)  # validates the container first
    model = info.get("model", "unknown model")
    raise ValueError(
        f"CR3 ({model}): CRX-compressed raw decode is not supported by the "
        "built-in decoders; install rawpy to open CR3 files (the metadata "
        "layer is available via pysp_tpu_torch.io.cr3.cr3_info)"
    )


def load_raw_cr3_rawpy(source: Source, device=CARD):
    """CR3 via libraw for the pixels + the CMT blocks for metadata.

    Mirrors the reference exactly: pixels through libraw
    (image.py:199-307's rawpy path), WB/EV from the container (the CMT
    blocks are what libraw itself reads). Raises the clear unsupported
    error when rawpy is absent."""
    try:
        import rawpy  # type: ignore
    except ImportError:
        load_raw_cr3(source)  # raises with the install hint
        raise AssertionError("unreachable")

    from io import BytesIO

    from ..colorimetry.wb import CameraWhiteBalanceController
    from .camera_matrices import resolve_camera_matrices
    from .raw_loader import (
        _PATTERN_FROM_STRING,
        _normalize_host,
        frame_from_parts,
    )

    info = cr3_info(source)
    reader = source if isinstance(source, str) else BytesIO(bytes(source))
    with rawpy.imread(reader) as raw:
        chan_sat = np.asarray(raw.camera_white_level_per_channel, np.float64)
        chan_black = np.asarray(raw.black_level_per_channel, np.float64)
        sensor = _normalize_host(raw.raw_image, chan_black, chan_sat)
        if raw.raw_pattern.shape != (2, 2):
            raise ValueError("Raw has unsupported Bayer pattern, cannot continue!")
        desc = raw.color_desc.decode("ascii")
        pattern_str = "".join(desc[i] for i in raw.raw_pattern.flatten())
        pattern = _PATTERN_FROM_STRING[pattern_str.upper()]

    neutral = np.asarray(
        info.get("as_shot_neutral", [0.5, 1.0, 0.5]), np.float64
    )
    mats = resolve_camera_matrices(info.get("model"))
    cam_wb = CameraWhiteBalanceController(mats, neutral)
    ev = info.get("ev")
    if ev is None or not np.isfinite(ev):
        raise ValueError("Error reading exposure value from raw!")
    return frame_from_parts(sensor, pattern, cam_wb, float(ev), device=device)


# --- synthetic fixture writer ------------------------------------------------------------
def write_synthetic_cr3(
    model: bytes = b"Canon EOS R5",
    wb_rggb: Tuple[int, int, int, int] = (2100, 1024, 1024, 1700),
    codec: bytes = b"CanonCR3_001/01.09.00/00.00.00",
) -> bytes:
    """Assemble a structurally faithful CR3 metadata skeleton (ftyp + moov
    with the Canon uuid carrying CNCV/CMT1/CMT2/CMT3 + a stub mdat)."""
    E = "<"

    def entry(tag, dtype, count, value4):
        return struct.pack(E + "HHL4s", tag, dtype, count, value4)

    def inline(fmt, *vals):
        raw = struct.pack(E + fmt, *vals)
        return raw + b"\x00" * (4 - len(raw))

    sz = lambda n: 2 + 12 * n + 4  # noqa: E731

    def tiff_of(tags):
        """Single-IFD little-endian TIFF; tags = [(tag, dtype, count, payload|inline4)]."""
        n = len(tags)
        off_heap = 8 + sz(n)
        heap = b""
        body = struct.pack(E + "H", n)
        for tag, dtype, count, val in tags:
            if isinstance(val, bytes) and len(val) > 4:
                body += entry(tag, dtype, count, struct.pack(E + "L", off_heap + len(heap)))
                heap += val + (b"\x00" if len(val) % 2 else b"")
            else:
                body += entry(tag, dtype, count, val)
        body += struct.pack(E + "L", 0)
        return struct.pack(E + "2sHL", b"II", 42, 8) + body + heap

    make_b = b"Canon\x00"
    model_b = model + b"\x00"
    cmt1 = tiff_of([
        (T.TAG_MAKE, T.TYPE_ASCII, len(make_b), make_b),
        (T.TAG_MODEL, T.TYPE_ASCII, len(model_b), model_b),
    ])
    cmt2 = tiff_of([
        (T.TAG_EXPOSURE_TIME, T.TYPE_RATIONAL, 1, struct.pack(E + "LL", 1, 250)),
        (T.TAG_F_NUMBER, T.TYPE_RATIONAL, 1, struct.pack(E + "LL", 40, 10)),
        (T.TAG_ISO_SPEED, T.TYPE_SHORT, 1, inline("H", 400)),
    ])
    # ColorData blob: 582 SHORT words -> WB_RGGBLevelsAsShot at word offset 2
    words = [0] * 582
    words[2:6] = list(wb_rggb)
    from .cr2 import MN_COLOR_DATA

    cmt3 = tiff_of([
        (MN_COLOR_DATA, T.TYPE_SHORT, 582, struct.pack(E + "582H", *words)),
    ])

    def box(btype: bytes, payload: bytes) -> bytes:
        return struct.pack(">L", 8 + len(payload)) + btype + payload

    uuid_payload = CANON_META_UUID
    for key, blob in ((b"CNCV", codec), (b"CMT1", cmt1), (b"CMT2", cmt2), (b"CMT3", cmt3)):
        uuid_payload += box(key, blob)
    moov = box(b"moov", box(b"uuid", uuid_payload))
    ftyp = box(b"ftyp", b"crx " + struct.pack(">L", 1) + b"crx isom")
    mdat = box(b"mdat", b"\x00" * 32)
    return ftyp + moov + mdat
