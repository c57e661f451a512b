"""pysp_tpu_torch imports neither JAX, flax nor the JAX package."""
import subprocess
import sys
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
MODULES = [
    "pysp_tpu_torch",
    "pysp_tpu_torch.demosaic.ahd_mega",
    "pysp_tpu_torch.ops.cuda_kernels",
    "pysp_tpu_torch.colorimetry.wb",
    "pysp_tpu_torch.utils.testing",
    "pysp_tpu_torch.core.device",
    "pysp_tpu_torch.filters.blur",
    "pysp_tpu_torch.filters.sharpen",
    "pysp_tpu_torch.ops.resample",
    "pysp_tpu_torch.warp.rectilinear",
    "pysp_tpu_torch.warp.opcodes",
    "pysp_tpu_torch.cli",
    "pysp_tpu_torch.correct.bad_pixels",
    "pysp_tpu_torch.correct.flat_field",
    "pysp_tpu_torch.correct.hdr",
    "pysp_tpu_torch.correct.denoise",
    "pysp_tpu_torch.pipeline.pipeline",
]


@pytest.mark.parametrize("module", MODULES)
def test_import_leaves_jax_out(module):
    # Only what the import itself loads counts: the modules present before it
    # (an interpreter start-up hook may load its own) are subtracted.
    code = (
        "import importlib, sys\n"
        "before = set(sys.modules)\n"
        f"importlib.import_module({module!r})\n"
        "bad = sorted(m for m in set(sys.modules) - before if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'pysp_tpu'))\n"
        "print(','.join(bad))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
        cwd=REPO,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "", f"{module} imported {out.stdout.strip()}"
