#!/usr/bin/env python3
"""Develops the same frames through every develop route of this tree and of
another tree of the repo on one NVIDIA GPU, and holds each output against the
other tree's with ``torch.equal``.

    python3 tools/develop_parity.py --other DIR [--shape 4000x6000]

DIR is the root of the other tree (for instance the parent commit unpacked
with ``git archive``). Both packages are named ``pysp_tpu_torch``, so the
other tree's is imported first, its outputs kept on the card, and its modules
dropped from ``sys.modules`` before this tree's is imported; each builds its
own kernel library. The cases, at ``--shape``:

- ``develop`` at Best (the AHD kernel with its fused tail), on a plain frame,
  an HDR frame and a BGGR source frame;
- ``develop_to_image`` at Best (the staged route) and ``demosaic`` at Best
  (the plain route);
- ``develop_with_stats`` at Best: the image and every statistic;
- ``develop`` with ``highlights="reconstruct"`` on a frame with blown
  highlights, at Best (the AHD kernel's planes) and at Draft (the channels);
- ``develop`` at Draft and at Fast (the fused develops);
- ``develop`` at Best with three chroma-median stages (the staged route: a
  frame outside the AHD kernel's gate) and with ``use_pallas=False``.

Prints a line a case, the card's name and power limit, and one JSON line
``{"equal": {case: bool}, "ok": bool}``; exits 1 unless every case is equal.
"""
from __future__ import annotations

import argparse
import importlib
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
CAM = np.array([[0.9, -0.2, -0.1], [-0.3, 1.1, 0.2], [0.0, -0.4, 1.3]], np.float32)
WB = np.array([0.45, 1.0, 0.62], np.float32)


def cases(P):
    """{case: (frame name, function of (package, frame) -> tensors)}."""
    Q = P.QualityDemosaic

    def dev(**kw):
        return lambda f: [P.develop(f, P.DevelopConfig(**kw))]

    def with_stats(f):
        out, stats = P.develop_with_stats(f, P.DevelopConfig())
        return [out] + [stats[k][s] for k in sorted(stats) for s in sorted(stats[k])]

    return {
        "develop_best": ("plain", dev()),
        "develop_best_hdr": ("hdr", dev()),
        "develop_best_bggr": ("bggr", dev()),
        "develop_to_image_best": ("plain", lambda f: [
            P.develop_to_image(f, P.DevelopConfig()).image]),
        "demosaic_best": ("plain", lambda f: [P.demosaic(f).image]),
        "develop_with_stats_best": ("plain", with_stats),
        "develop_reconstruct_best": ("blown", dev(highlights="reconstruct")),
        "develop_reconstruct_draft": ("blown", dev(quality=Q.Draft, highlights="reconstruct")),
        "develop_draft": ("plain", dev(quality=Q.Draft)),
        "develop_fast": ("plain", dev(quality=Q.Fast)),
        "develop_best_3_stages": ("plain", dev(postprocess_stages=3)),
        "develop_best_plain": ("plain", dev(use_pallas=False)),
    }


def frames(P, mosaics):
    def frame(mosaic, **kw):
        return P.RawFrame.synthetic(mosaic, cam_mat=CAM, wb_neutral=WB, device="cuda", **kw)

    return {"plain": frame(mosaics["plain"]),
            "hdr": frame(mosaics["plain"], is_hdr=True),
            "bggr": frame(mosaics["plain"]).replace(source_pattern=P.BayerPattern.Bggr),
            "blown": frame(mosaics["blown"])}


def import_tree(root: Path):
    """The package of the tree at ``root``, after dropping any other."""
    for name in [m for m in sys.modules if m.split(".")[0] == "pysp_tpu_torch"]:
        del sys.modules[name]
    sys.path.insert(0, str(root))
    try:
        return importlib.import_module("pysp_tpu_torch")
    finally:
        sys.path.remove(str(root))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True, type=Path, help="the other tree's root")
    ap.add_argument("--shape", default="4000x6000", help="HxW of the frames")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    h, w = (int(n) for n in args.shape.split("x"))

    other = import_tree(args.other.resolve())
    from pysp_tpu_torch.utils.testing import make_scene, mosaic_rggb

    plain = mosaic_rggb(make_scene(h, w, seed=23)).astype(np.float32)
    mosaics = {"plain": plain, "blown": np.minimum(plain * np.float32(1.6), np.float32(1.0))}
    with torch.no_grad():
        fs = frames(other, mosaics)
        want = {name: [t.clone() for t in fn(fs[f])] for name, (f, fn) in cases(other).items()}
        del fs
        torch.cuda.synchronize()

        this = import_tree(ROOT)
        fs = frames(this, mosaics)
        equal = {}
        for name, (f, fn) in cases(this).items():
            got = fn(fs[f])
            equal[name] = len(got) == len(want[name]) and all(
                g.shape == x.shape and torch.equal(g, x) for g, x in zip(got, want[name]))
            print(f"{name}: {len(got)} tensor(s), equal to the other tree's: {equal[name]}",
                  flush=True)
            del got, want[name]
    ok = all(equal.values())
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
          f"frames {h}x{w}; this tree {this.__file__}, the other {other.__file__}")
    print(json.dumps({"equal": equal, "ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
