"""The faults that ``correct`` has to catch, each planted under the rest of a
run: ``make(ctx)`` returns a program for the cell's driver in the place of
the real entry. ``calibrate.py --faults`` reads them on the card at the
cells' own sizes; ``tests/test_isp_bench_faults.py`` at sizes a CPU test
holds. The benchmark's own runs never plant one.

- ``altered``: an answer altered where it is produced (a twentieth of its
  rows raised by 0.05);
- ``stale``: every item answered with the image of the program's first call
  (the warm-up's first input), as a step that hands back what it held: right
  for that input alone, so the window has to visit another;
- ``half_burst``: half of a burst's brackets left out, the fuse's mean taken
  over the rest;
- ``no_heal``: the corrections layer's hot-pixel heal skipped;
- ``half_files``: half of the files left out;
- ``altered_png``: one byte of a written PNG's pixel data flipped.
"""
from __future__ import annotations

import os

from isp_bench.drivers import files, resident


def _entry(ctx):
    return (files._entry if ctx.traffic["driver"] == "files" else resident._entry)(ctx)


def altered(ctx):
    entry = _entry(ctx)

    def call(x, q):
        out = entry(x, q).clone()
        out[: max(1, out.shape[0] // 20)] += 0.05
        return out
    return call


def stale(ctx):
    entry = _entry(ctx)
    held = []

    def call(x, q):
        out = entry(x, q)
        if not held:
            held.append(out)
        return held[0]
    return call


def half_burst(ctx):
    entry = _entry(ctx)

    def call(burst, q):
        n = burst.bayer.shape[0] // 2 or 1
        return entry(burst.replace(**{k: getattr(burst, k)[:n] for k in
                                      ("bayer", "cam_mat", "cam_white", "wb_neutral", "ev",
                                       "lim_sat")}), q)
    return call


def no_heal(ctx):
    return resident._entry(ctx, repair_hot_pixels=False)


def half_files(ctx):
    entry = _entry(ctx)
    return lambda paths, out_dir: entry(paths[: len(paths) // 2], out_dir)


def altered_png(ctx):
    entry = _entry(ctx)

    def call(paths, out_dir):
        written = entry(paths, out_dir)
        with open(written[0], "r+b") as f:          # one pixel row's bytes in the stored deflate
            f.seek(os.path.getsize(written[0]) // 2)
            b = f.read(1)
            f.seek(-1, 1)
            f.write(bytes([b[0] ^ 0x40]))
        return written
    return call


# the faults each cell can have
BY_CELL = {
    "cam24.best": (altered, stale),
    "cam24.preview": (altered, stale),
    "hdr5.bracket": (altered, stale, half_burst, no_heal),
    "cam24.files": (half_files, altered_png),
}
