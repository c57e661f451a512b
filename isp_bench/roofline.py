"""The yardstick of the kernel layer: the peaks of one NVIDIA H100 (SXM data
sheet, dense float32 outside the tensor cores, HBM3) and the work of a Best
develop, fixed here so that the count reads the same work whatever
implements it.

The Best develop's work is counted on its plain version (AHD with one
chroma-median stage, the colour tail) by :class:`FloatOpCount`: one
operation per output element of each arithmetic op on floating-point
operands; copies, pads and gathers count nothing, so it is a floor of the
work. Its bytes: the float32 mosaic read once (4 B a pixel) and the
(H, W, 3) float32 image written once (12 B a pixel).
"""
from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# float32 operations a pixel of the plain Best develop (one stage), as
# FloatOpCount counts the frozen reference (isp_bench/tests recounts it)
BEST_OPS_PER_PX = 879
BEST_BYTES_PER_PX = 4 + 12

_ARITH = frozenset((
    "add", "sub", "rsub", "mul", "div", "neg", "abs", "minimum", "maximum", "clamp",
    "clamp_min", "clamp_max", "where", "lt", "le", "gt", "ge", "eq", "ne", "pow",
    "sin", "floor", "copysign", "reciprocal", "sqrt", "exp", "log",
))


class FloatOpCount(TorchDispatchMode):
    """Counts the float operations of what runs under it: one per output
    element of each arithmetic op with a floating-point operand."""

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


def least_s(ops: float, nbytes: float) -> float:
    """The least time of work of ``ops`` float32 operations and ``nbytes``
    bytes: the larger of the two bounds."""
    return max(ops / FP32_OPS_PER_S, nbytes / HBM_BYTES_PER_S)


def best_develop_least_s(pixels: int) -> float:
    return least_s(BEST_OPS_PER_PX * pixels, BEST_BYTES_PER_PX * pixels)
