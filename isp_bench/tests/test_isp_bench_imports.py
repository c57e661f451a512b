"""What the harness loads: no module of JAX or of the JAX package (compared
by whole top-level name: ``pysp_tpu_torch`` begins with ``pysp_tpu``), and
a reference that loads nothing of the program."""
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "pysp_tpu"}


def loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print(' '.join(sorted({m.split('.', 1)[0] for m in sys.modules})))"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300, check=True)
    return set(out.stdout.split())


def test_the_run_loads_no_jax_nor_the_jax_package():
    names = loaded("import runpy, sys\nsys.argv = ['run.py']\n"
                   "runpy.run_path('isp_bench/run.py', run_name='not_main')\n"
                   "from isp_bench.tests import helpers\n"
                   "for cell in ('cam24.best', 'cam24.files'):\n"
                   "    assert helpers.run_cell(cell)[0]['correct']\n"
                   "import isp_bench.devtrace, isp_bench.control, pysp_tpu_torch.cli")
    assert "pysp_tpu_torch" in names and "torch" in names
    assert not names & FORBIDDEN, names & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    names = loaded("import isp_bench.reference.develop, isp_bench.reference.colour, "
                   "isp_bench.reference.demosaic, isp_bench.gen, isp_bench.png, isp_bench.roofline")
    assert not names & (FORBIDDEN | {"pysp_tpu_torch"}), names & (FORBIDDEN | {"pysp_tpu_torch"})


def test_the_harness_refuses_to_run_without_a_card():
    out = subprocess.run([sys.executable, "isp_bench/run.py", "--workload", "cam24.best",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300,
                         env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0
    assert out.stdout.strip() == "" or not out.stdout.strip().splitlines()[-1].startswith("{")
