"""One run of one cell of the benchmark of ``pysp_tpu_torch``.

    python3 isp_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell's entry in ``BENCHMARK.json`` names its configuration and its
traffic; everything else is found by name under ``isp_bench/``:

- ``configs/<config>.json``: the camera and its develop settings;
- ``traffic/<traffic>.json``: the driver (``drivers/<driver>.py``) and its
  parameters;
- ``checks/<cell>.json``: the limit of each number that ``correct`` compares;
- ``metrics/<metric>.py``: a reader, ``read(run)``, for each metric the cell
  reports (``None`` where it finds nothing to read).

The run makes its inputs from the seed, warms up every shape it uses (all of
that is ``setup_s``), drives the program in a closed loop for ``--seconds``
(with ``--trace 1`` under one profiler session), reads the peak device
memory, frees the program's state, and checks a sample of what the window
produced against the plain reference. The last line of standard output is
one JSON object; the numbers compared, each beside its limit, are also the
last lines of standard error.
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib
import importlib.util
import json
import os
import resource
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "pysp_tpu")


@dataclasses.dataclass
class Item:
    """One request of the window: submitted and complete on the card (host
    clock, ns), its input megapixels and its kind."""

    submit_ns: int
    done_ns: int
    mp: float
    kind: str


@dataclasses.dataclass
class Run:
    """What a metric reader reads."""

    cell: dict
    config: dict
    traffic: dict
    items: list = dataclasses.field(default_factory=list)
    window_s: float = 0.0         # host clock of the window
    busy_window_s: float = 0.0    # host clock of the calls into the program
    files: int = 0                # files written in the window
    cpu_s: float = 0.0            # process CPU seconds (user + system) in the window
    setup_s: float = 0.0
    trace: Optional[object] = None   # devtrace.Trace of a --trace 1 run


@dataclasses.dataclass
class Comparison:
    """A number compared with its limit; ``ok`` when it is at most the limit."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


class Context:
    """A cell as the drivers see it: its files, the seed and the device."""

    def __init__(self, cell: str, seed: int, device: str = "cuda", scale: Optional[dict] = None,
                 root: Path = ROOT):
        bench = json.loads((root / "BENCHMARK.json").read_text())
        self.bench = bench
        self.here = root / "isp_bench"
        self.cell = next((w for w in bench["workloads"] if w["name"] == cell), None)
        if self.cell is None:
            raise KeyError(f"no workload {cell!r} in BENCHMARK.json")
        conf = next(c for c in bench["configs"] if c["name"] == self.cell["config"])
        self.config = json.loads((root / conf["file"]).read_text())
        self.traffic = json.loads((self.here / "traffic" / f"{self.cell['traffic']}.json")
                                  .read_text())
        self.limits = json.loads((self.here / "checks" / f"{cell}.json").read_text())["limits"]
        if scale:                       # smaller sizes, for the CPU tests only
            self.config = {**self.config, **scale}
        self.seed = int(seed)
        self.device = device
        self.run = Run(cell=self.cell, config=self.config, traffic=self.traffic)
        self.setup_phases = {}   # seconds of each part of set-up, printed

    def driver(self):
        return importlib.import_module(f"isp_bench.drivers.{self.traffic['driver']}")

    def metrics(self, trace: bool) -> list:
        """The cell's metrics of the kind the run reports, from BENCHMARK.json."""
        kind = "per_layer" if trace else "end_to_end"
        return [m for m in self.bench[kind]
                if self.cell["name"] in m.get("workloads", [self.cell["name"]])]


def read_metric(name: str, run: Run, here: Path = HERE):
    """``metrics/<name>.py``'s ``read(run)``."""
    path = here / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"isp_bench_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read(run)


def card_lines() -> list:
    """The card's name, power limit and clocks, and the host's CPU."""
    lines = []
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm,"
             "temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=False)
        lines.append(f"card: {out.stdout.strip()}")
    except (OSError, subprocess.TimeoutExpired) as e:
        lines.append(f"card: nvidia-smi unavailable ({e})")
    try:
        cpu = next(l.split(":", 1)[1].strip() for l in open("/proc/cpuinfo")
                   if l.startswith("model name"))
        lines.append(f"host: {cpu}, {os.cpu_count()} cores")
    except (OSError, StopIteration):
        pass
    return lines


def forbidden_modules() -> list:
    return sorted({m.split(".", 1)[0] for m in sys.modules} & set(FORBIDDEN))


def execute(ctx: Context, seconds: float, trace: bool, t_start: float,
            program: Optional[Callable] = None) -> dict:
    """Set-up, window, peak memory, check. Returns the result line's object.
    ``program`` replaces the driver's entry (the control and the faults of the
    tests)."""
    import torch

    from isp_bench import devtrace

    driver = ctx.driver()
    t0 = time.perf_counter()
    import pysp_tpu_torch  # noqa: F401
    t1 = time.perf_counter()
    ctx.setup_phases["the port's import"] = t1 - t0
    if ctx.device == "cuda":
        torch.zeros(1, device="cuda")
    ctx.setup_phases["CUDA's start"] = time.perf_counter() - t1
    state = driver.prepare(ctx, program)
    if ctx.device == "cuda":
        torch.cuda.synchronize()
    run = ctx.run
    run.setup_s = time.perf_counter() - t_start

    session = devtrace.Session(ctx.device) if trace else None
    cpu0 = resource.getrusage(resource.RUSAGE_SELF)
    if session:
        session.start()
    driver.window(state, ctx, seconds, session)
    if session:
        run.trace = session.stop()
    cpu1 = resource.getrusage(resource.RUSAGE_SELF)
    run.cpu_s = (cpu1.ru_utime - cpu0.ru_utime) + (cpu1.ru_stime - cpu0.ru_stime)

    device = {"platform": "gpu" if ctx.device == "cuda" else ctx.device,
              "kind": torch.cuda.get_device_name(0) if ctx.device == "cuda" else "cpu",
              "count": 1,
              "memory_peak_bytes": int(torch.cuda.max_memory_allocated(0))
              if ctx.device == "cuda" else 0}
    if run.trace is not None:
        device["busy_s"] = run.trace.busy_s
        device["window_s"] = run.trace.window_s

    metrics = {}
    for m in ctx.metrics(trace):
        value = read_metric(m["name"], run, ctx.here)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    driver.release(state)
    if ctx.device == "cuda":
        torch.cuda.empty_cache()
    comparisons = driver.check(state, ctx)
    correct = bool(comparisons) and all(c.ok for c in comparisons)
    attempted, failed = driver.attempts(state, ctx)
    result = {"correct": correct and failed == 0, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": device}
    if run.trace is not None:
        result["breakdown"] = run.trace.breakdown()
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in comparisons}
    return result


def main(argv, t_start: float) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    ctx = Context(args.workload, args.seed)
    chips = int(ctx.cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {chips} CUDA device(s); this machine has {n}",
              file=sys.stderr)
        return 2
    ctx.setup_phases["start, imports"] = time.perf_counter() - t_start
    result = execute(ctx, args.seconds, bool(args.trace), t_start)
    # read after the window, so that the clocks are the loaded card's and the
    # query is not part of set-up
    for line in card_lines():
        print(line, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}",
          flush=True)
    found = forbidden_modules()
    if found:
        print(f"modules of JAX or the JAX package are loaded: {found}", file=sys.stderr)
        return 3
    kinds = {}
    for item in ctx.run.items:
        kinds[item.kind] = kinds.get(item.kind, 0) + 1
    print(f"{args.workload} seed {args.seed}: items {kinds}, files {ctx.run.files}, "
          f"setup {ctx.run.setup_s:.3f} s, window {ctx.run.window_s:.3f} s", flush=True)
    print("setup: " + ", ".join(f"{k} {v:.3f} s" for k, v in ctx.setup_phases.items()), flush=True)
    # the numbers compared, each beside its limit, are the last lines here
    print(f"correct: {result['correct']}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0
