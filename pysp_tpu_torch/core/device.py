"""Where the port's entry points put their tensors.

Entry points that create tensors from nothing (a file, a size) run on the
card unless the caller asks for another device; the tests ask for the CPU with
``device="cpu"``. Without a GPU, asking for the card raises at once rather
than carrying on on the CPU.
"""
from __future__ import annotations

import torch

CARD = "cuda"


def resolve_device(device=CARD) -> torch.device:
    """``device`` as a ``torch.device``; raises ``RuntimeError`` when it names
    CUDA and no CUDA device is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"pysp_tpu_torch runs on the GPU by default, but no CUDA device is "
            f"present (torch.cuda.is_available() is False; torch "
            f"{torch.__version__}). Pass device='cpu' (CLI: --device cpu) to "
            f"run on the CPU."
        )
    return dev
