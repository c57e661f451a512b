"""pysp_tpu_torch imports neither JAX, flax nor the JAX package, and exports
what the JAX package exports from the modules the port has."""
import ast
import importlib
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
    "pysp_tpu_torch.correct.ca.models",
    "pysp_tpu_torch.correct.ca.instability",
    "pysp_tpu_torch.correct.ca.roi",
    "pysp_tpu_torch.correct.ca.matcher",
    "pysp_tpu_torch.correct.ca.solver",
    "pysp_tpu_torch.correct.ca.removal",
    "pysp_tpu_torch.correct.ca.gradfit",
    "pysp_tpu_torch.utils.sidecar",
    "pysp_tpu_torch.io.raw_loader",
    "pysp_tpu_torch.warp.fix_opcodes",
    "pysp_tpu_torch.warp.gain_opcodes",
    "pysp_tpu_torch.core.normalization",
    "pysp_tpu_torch.utils.tracing",
    "pysp_tpu_torch.correct.highlights",
    "pysp_tpu_torch.io.native",
    "pysp_tpu_torch.io.tiff",
    "pysp_tpu_torch.io.image_out",
    "pysp_tpu_torch.io.camera_matrices",
    "pysp_tpu_torch.io.matrix_cache",
    "pysp_tpu_torch.io.verify_decode",
    "pysp_tpu_torch.io.cr2",
    "pysp_tpu_torch.io.cr3",
    "pysp_tpu_torch.io.mrw",
    "pysp_tpu_torch.io.raf",
    "pysp_tpu_torch.io.arw",
    "pysp_tpu_torch.io.orf",
    "pysp_tpu_torch.io.rw2",
    "pysp_tpu_torch.io.pef",
    "pysp_tpu_torch.io.srw",
    "pysp_tpu_torch.io.nef",
    "pysp_tpu_torch.pipeline.stream",
    "pysp_tpu_torch.compat",
    "examples.differentiable_isp_torch",
    "examples.full_pipeline_torch",
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
        "('jax', 'jaxlib', 'flax', 'optax', 'pysp_tpu'))\n"
        "print(','.join(bad))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
        cwd=REPO,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "", f"{module} imported {out.stdout.strip()}"


# --- the package's exported names against the JAX package's ---------------------------

# Names that pysp_tpu exports from a module the port has, where the port's
# module does not define them yet (ROADMAP.md queue A): none since the drivers.
NOT_PORTED_YET = set()


def _jax_package_exports():
    """{name: defining module} of ``pysp_tpu/__init__.py``'s ``__all__``, read
    as text: the JAX package is not imported."""
    tree = ast.parse((REPO / "pysp_tpu" / "__init__.py").read_text())
    origin, exported = {}, []
    for node in tree.body:
        if isinstance(node, ast.ImportFrom) and node.level == 1:
            origin.update({a.asname or a.name: node.module for a in node.names})
        elif isinstance(node, ast.Assign) and node.targets[0].id == "__all__":
            exported = [elt.value for elt in node.value.elts]
    return {name: origin[name] for name in exported}


def _port_has_module(module: str) -> bool:
    path = REPO / "pysp_tpu_torch" / module.replace(".", "/")
    return path.with_suffix(".py").exists() or (path / "__init__.py").exists()


PORTED_EXPORTS = sorted(
    (name, module) for name, module in _jax_package_exports().items()
    if _port_has_module(module) and name not in NOT_PORTED_YET
)


@pytest.mark.parametrize("name,module", PORTED_EXPORTS)
def test_package_exports_what_the_jax_package_exports(name, module):
    import pysp_tpu_torch

    assert name in pysp_tpu_torch.__all__
    defined = getattr(importlib.import_module(f"pysp_tpu_torch.{module}"), name)
    assert getattr(pysp_tpu_torch, name) is defined


def test_export_list_is_complete():
    """At least the 90 names of today, the version, and every name of
    ``__all__`` is an attribute; the names left out are really not defined."""
    import pysp_tpu_torch

    assert len(PORTED_EXPORTS) >= 90
    assert pysp_tpu_torch.__version__ == "0.1.0"
    assert all(hasattr(pysp_tpu_torch, name) for name in pysp_tpu_torch.__all__)
    exports = _jax_package_exports()
    for name in NOT_PORTED_YET:
        module = importlib.import_module(f"pysp_tpu_torch.{exports[name]}")
        assert not hasattr(module, name), f"{name} is ported: export it"
