"""Inputs of the benchmark, made from ``--seed``: scenes, mosaics, hot
photosites, brackets and DNG files.

A frozen copy of the port's synthetic-camera formulas (``make_scene``,
``mosaic_rggb``, the corrections path's hot sites and brackets, the DNG
writer and its lossless-JPEG coder), so that nothing here comes from the
program under test. Scenes are made on the device in a few large calls.
Every function takes the stream of random numbers it uses from
``(seed, stream)`` alone, so the same seed gives the same inputs.
"""
from __future__ import annotations

import math
import struct

import numpy as np
import torch

Tensor = torch.Tensor


def sub_seed(seed: int, *stream: int) -> int:
    """A 63-bit seed for one stream of ``seed``'s inputs."""
    words = np.random.SeedSequence([int(seed) % 2**63, *stream]).generate_state(2, np.uint32)
    return (int(words[0]) << 31) ^ int(words[1])


def generator(seed: int, device, *stream: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, *stream))
    return g


def scene_mosaic(h: int, w: int, seed: int, index: int, device) -> Tensor:
    """The RGGB mosaic (h, w) float32 of ``make_scene``'s structured scene
    (gradients, edges, texture, noise of sigma 0.01, clipped to [0.02, 0.98]),
    moved by an offset of up to 1024 px drawn from ``(seed, index)``, so that
    each input is its own scene with the same statistics."""
    g = generator(seed, device, 1, index)
    oy, ox = (int(v) for v in torch.randint(0, 1024, (2,), generator=g, device=device))
    yy = (torch.arange(h, device=device, dtype=torch.float32) + oy)[:, None]
    xx = (torch.arange(w, device=device, dtype=torch.float32) + ox)[None, :]
    r = 0.3 + 0.4 * torch.sin(xx / 9) * torch.cos(yy / 13) + 0.2 * (xx > (w + 2 * ox) / 2)
    gr = 0.4 + 0.3 * torch.cos(xx / 7) + 0.15 * (yy > (h + 3 * oy) / 3)
    b = 0.5 - 0.3 * torch.sin(yy / 11) + 0.1 * (torch.remainder(xx + yy, 17) > 8)
    gr = gr.expand(h, w)
    # the channel each CFA site samples: R at (even, even), B at (odd, odd)
    row_odd = (torch.arange(h, device=device) % 2 == 1)[:, None]
    col_odd = (torch.arange(w, device=device) % 2 == 1)[None, :]
    mosaic = torch.where(row_odd & col_odd, b.expand(h, w), gr)
    mosaic = torch.where(~row_odd & ~col_odd, r.expand(h, w), mosaic)
    noise = torch.randn((h, w), generator=g, device=device)
    return torch.clamp(mosaic + 0.01 * noise, 0.02, 0.98)


def to_counts(mosaic: Tensor, scale: float = 1.0) -> Tensor:
    """Stored 16-bit counts of a [0, 1] mosaic at ``scale`` times its
    exposure: ``200 + clip(mosaic * scale, 0, 1) * 3800``, truncated, as the
    corrections path writes them (black 256 and white 4095 in the file)."""
    x = torch.clamp(mosaic * scale, 0.0, 1.0) if scale != 1.0 else mosaic
    return (200.0 + x * 3800.0).to(torch.int32)


def hot_sites(mosaic: Tensor, seed: int, singles: int, clusters: int) -> np.ndarray:
    """Mosaic sites (n, 2) of (y, x) to set to full scale where the scene is
    dark (< 0.25): ``singles`` single sites and ``clusters`` 2x2 clusters (one
    site in each CFA plane), on a 16-px grid visited in an order drawn from
    the seed, so that no two lie within 8 sites of each other in a plane."""
    h, w = mosaic.shape
    ys = torch.arange(16, h - 16, 16, device=mosaic.device)
    xs = torch.arange(16, w - 16, 16, device=mosaic.device)
    quad = torch.stack([mosaic[ys[:, None] + dy, xs[None, :] + dx]
                        for dy in (0, 1) for dx in (0, 1)])            # (4, ny, nx)
    qmax = quad.amax(dim=0).flatten().cpu().numpy()
    qmin, qarg = (t.flatten().cpu().numpy() for t in quad.min(dim=0))
    ys, xs = ys.cpu().numpy(), xs.cpu().numpy()
    rng = np.random.default_rng(sub_seed(seed, 2))
    one, four = [], []
    for i in rng.permutation(len(qmax)):
        y, x = int(ys[i // len(xs)]), int(xs[i % len(xs)])
        if len(four) < 4 * clusters and qmax[i] < 0.25:
            four += [(y, x), (y, x + 1), (y + 1, x), (y + 1, x + 1)]
        elif len(one) < singles and qmin[i] < 0.25:
            one.append((y + int(qarg[i]) // 2, x + int(qarg[i]) % 2))
        if len(one) == singles and len(four) == 4 * clusters:
            return np.array(one + four, np.int64)
    raise ValueError(f"only {len(one)} singles and {len(four) // 4} clusters found dark sites")


def bracket_counts(mosaic: Tensor, sites: np.ndarray, scales) -> Tensor:
    """(N, h, w) int32 counts of the brackets: the scene at each scale,
    clipped, with the hot sites at full scale (4095) in every frame."""
    out = torch.stack([to_counts(mosaic, float(s)) for s in scales])
    idx = torch.as_tensor(sites, device=mosaic.device)
    out[:, idx[:, 0], idx[:, 1]] = 4095
    return out


def exposure_value(iso: float, exposure_time: float, f_number: float) -> float:
    """EV = log2(100 N^2 / (ISO t)), as the loaders read it from EXIF."""
    return math.log2((100.0 * f_number * f_number) / (iso * exposure_time))


# --- lossless JPEG (SOF3, predictor 1), as the port's native coder writes it ----

# Huffman code lengths of the difference categories 0..16 (a fixed canonical
# table: 0-2 get 2 bits, category k >= 3 gets k bits).
_LJ92_LENS = [2, 2, 2] + list(range(3, 17))


def _lj92_table():
    bits = [0] * 17
    for n in _LJ92_LENS:
        bits[n] += 1
    values = [c for n in range(1, 17) for c in range(17) if _LJ92_LENS[c] == n]
    codes, code, k = [0] * 17, 0, 0
    for n in range(1, 17):
        for _ in range(bits[n]):
            codes[values[k]] = code
            code += 1
            k += 1
        code <<= 1
    return bits, values, codes


def lj92_encode(img: Tensor, precision: int = 16) -> bytes:
    """Lossless JPEG (SOF3, one component, predictor 1) of (h, w) counts,
    entropy-coded with tensor operations on ``img``'s device: each sample's
    code and extra bits are placed at their bit offset with one
    ``index_add_`` (the bit ranges are disjoint, so the sums are the ORs)."""
    h, w = img.shape
    dev = img.device
    v = img.to(torch.int64)
    pred = torch.empty_like(v)
    pred[:, 1:] = v[:, :-1]
    pred[1:, 0] = v[:-1, 0]
    pred[0, 0] = 1 << (precision - 1)
    diff = v - pred
    diff = torch.remainder(diff + 32768, 65536) - 32768                # as int16
    bounds = torch.tensor([1 << k for k in range(16)], device=dev, dtype=torch.int64)
    ssss = torch.bucketize(diff.abs(), bounds, right=True)             # bit length of |diff|
    bits, values, codes = _lj92_table()
    code = torch.tensor(codes, device=dev, dtype=torch.int64)[ssss]
    clen = torch.tensor(_LJ92_LENS, device=dev, dtype=torch.int64)[ssss]
    extra = torch.where(ssss < 16, ssss, 0)
    val = torch.where(diff < 0, diff + (1 << extra) - 1, diff) & ((1 << extra) - 1)
    word = ((code << extra) | val).flatten()
    length = (clen + extra).flatten()
    end = torch.cumsum(length, 0)
    total = int(end[-1])
    start = end - length
    nbytes = (total + 7) // 8
    # the word in a 40-bit window that starts at its first byte
    win = word << (40 - length - start % 8)
    first = start // 8
    out = torch.zeros(nbytes + 5, dtype=torch.int64, device=dev)
    for k in range(5):
        out.index_add_(0, first + k, (win >> (32 - 8 * k)) & 0xFF)
    out = out[:nbytes]
    if total % 8:
        out[-1] |= (1 << (8 - total % 8)) - 1                           # pad with 1s
    ff = out == 0xFF
    stuffed = torch.repeat_interleave(out, 1 + ff.to(torch.int64))
    pos = torch.arange(nbytes, device=dev) + torch.cumsum(ff.to(torch.int64), 0) - ff.to(torch.int64)
    stuffed[pos[ff] + 1] = 0                                            # 0xFF -> 0xFF 0x00
    data = stuffed.to(torch.uint8).cpu().numpy().tobytes()

    head = bytearray(b"\xff\xd8")
    head += b"\xff\xc4" + struct.pack(">H", 2 + 1 + 16 + 17) + b"\x00"
    head += bytes(bits[1:]) + bytes(values)
    head += b"\xff\xc3" + struct.pack(">HBHHB", 11, precision, h, w, 1) + b"\x00\x11\x00"
    head += b"\xff\xda" + struct.pack(">HB", 8, 1) + b"\x00\x00" + b"\x01\x00\x00"
    return bytes(head) + data + b"\xff\xd9"


# --- the DNG container --------------------------------------------------------

_BYTE, _ASCII, _SHORT, _LONG, _RATIONAL, _UNDEFINED, _SRATIONAL = 1, 2, 3, 4, 5, 7, 10
_FMT = {_BYTE: "B", _ASCII: "B", _SHORT: "H", _LONG: "L", _RATIONAL: "L",
        _UNDEFINED: "B", _SRATIONAL: "l"}


def _srat(values):
    return [(int(round(v * 10000)), 10000) for v in np.asarray(values, np.float64).ravel()]


def _payload(kind: int, values) -> tuple:
    if kind in (_ASCII, _UNDEFINED):
        return bytes(values), len(values)
    if kind in (_RATIONAL, _SRATIONAL):
        flat = [int(x) for pair in values for x in pair]
        return struct.pack("<" + _FMT[kind] * len(flat), *flat), len(values)
    return struct.pack("<" + _FMT[kind] * len(values), *values), len(values)


def _tiff(ifds: list, strip: bytes) -> bytes:
    """A little-endian TIFF of the IFDs ``ifds`` (lists of (tag, type,
    values)) laid out one after another from offset 8, then their
    out-of-line values, then ``strip``."""
    heap_at = 8 + sum(2 + 12 * len(tags) + 4 for tags in ifds)
    blobs, heap = [], bytearray()
    for tags in ifds:
        entries = []
        for tag, kind, values in sorted(tags, key=lambda t: t[0]):
            data, count = _payload(kind, values)
            if len(data) <= 4:
                entries.append(struct.pack("<HHL4s", tag, kind, count, data.ljust(4, b"\0")))
            else:
                entries.append(struct.pack("<HHLL", tag, kind, count, heap_at + len(heap)))
                heap += data + b"\0" * (len(data) % 2)
        blobs.append(struct.pack("<H", len(entries)) + b"".join(entries) + b"\0\0\0\0")
    return b"II" + struct.pack("<HL", 42, 8) + b"".join(blobs) + bytes(heap) + strip


def dng_bytes(counts: Tensor, camera: dict, compression: int, exposure_time=None) -> bytes:
    """A DNG of (h, w) RGGB 16-bit counts with ``camera``'s levels, colour
    matrices, illuminants, as-shot neutral, exposure (or ``exposure_time``),
    f-number and ISO, as the port's
    ``write_synthetic_dng`` lays it out: IFD0 with the colour tags, a raw
    SubIFD with one strip (uncompressed little-endian 16-bit for
    ``compression`` 1, lossless JPEG for 7) and an Exif IFD."""
    h, w = counts.shape
    if compression == 7:
        strip = lj92_encode(counts)
    elif compression == 1:
        strip = counts.to(torch.int32).cpu().numpy().astype("<u2").tobytes()
    else:
        raise ValueError(f"compression {compression} is not written here")
    sub = [
        (256, _LONG, [w]), (257, _LONG, [h]), (258, _SHORT, [16]),
        (259, _SHORT, [compression]), (262, _SHORT, [32803]), (277, _SHORT, [1]),
        (278, _LONG, [h]), (33421, _SHORT, [2, 2]), (33422, _BYTE, [0, 1, 1, 2]),
        (50714, _SHORT, [int(camera["black_level"])] * 4), (50713, _SHORT, [2, 2]),
        (50717, _LONG, [int(camera["white_level"])]),
        (273, _LONG, [0]), (279, _LONG, [len(strip)]),
    ]
    exif = [
        (33434, _RATIONAL, [tuple(exposure_time or camera["exposure_time"])]),
        (33437, _RATIONAL, [tuple(camera["f_number"])]),
        (34855, _SHORT, [int(camera["iso"])]),
    ]
    ifd0 = [
        (271, _ASCII, b"isp_bench\0"), (272, _ASCII, b"synthetic\0"),
        (50706, _BYTE, [1, 4, 0, 0]),
        (50721, _SRATIONAL, _srat(camera["color_matrix_1"])),
        (50722, _SRATIONAL, _srat(camera["color_matrix_2"])),
        (50778, _SHORT, [int(camera["illuminant_1"])]),
        (50779, _SHORT, [int(camera["illuminant_2"])]),
        (50728, _RATIONAL, [(int(round(v * 10000)), 10000) for v in camera["as_shot_neutral"]]),
        (34855, _SHORT, [int(camera["iso"])]),
        (330, _LONG, [0]), (34665, _LONG, [0]),
    ]
    # two passes: the offsets of the SubIFD, the Exif IFD and the strip are
    # known once the sizes are
    sizes = [2 + 12 * len(t) + 4 for t in (ifd0, sub, exif)]
    ifd0[-2] = (330, _LONG, [8 + sizes[0]])
    ifd0[-1] = (34665, _LONG, [8 + sizes[0] + sizes[1]])
    blob = _tiff([ifd0, sub, exif], b"")
    sub[-2] = (273, _LONG, [len(blob)])
    return _tiff([ifd0, sub, exif], strip)
