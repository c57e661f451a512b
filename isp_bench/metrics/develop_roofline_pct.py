"""The Best develop's share of its roofline: the least time of a 24 MP Best
develop's work on the card (``roofline.best_develop_least_s``: the larger of
its counted float32 operations over the peak rate and its bytes over the
memory bandwidth), over the device kernel time per item. Read only where
every item of the window is one Best develop of one frame."""
import importlib


def read(run):
    if run.trace is None or not run.items or run.files:
        return None
    if {it.kind for it in run.items} != {"best"} or run.traffic.get("entry") != "develop":
        return None
    roofline = importlib.import_module("isp_bench.roofline")
    least = roofline.best_develop_least_s(run.config["height"] * run.config["width"])
    return 100.0 * least / (run.trace.kernel_s / len(run.items))
