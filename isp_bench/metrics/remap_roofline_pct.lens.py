"""mf102.lens: the remap kernel's share of its roofline: the least time of an
item's remap work (``roofline_remap.item_least_s``: four bilinear CA
launches and one Lanczos4 warp launch, each the larger of its counted
float32 operations over the peak rate and its bytes over the memory
bandwidth) over the remap kernel's device seconds an item, summed from the
device trace by the kernel's names. Read only where every item is one frame
through the lens-corrected chain and the trace holds the kernel."""
import importlib


def read(run):
    if run.trace is None or not run.items or run.traffic.get("driver") != "lens":
        return None
    roofline = importlib.import_module("isp_bench.roofline_remap")
    kernel_s = sum(s for name, s in run.trace.by_kernel if roofline.is_remap_kernel(name))
    if kernel_s <= 0:
        return None
    least = roofline.item_least_s(run.config["height"] * run.config["width"])
    return 100.0 * least / (kernel_s / len(run.items))
