"""mf102.lens: device ms of the OpcodeList3 warp per item: the port's
``warp.opcode3`` spans (device time between each span's two CUDA events)
over the window's items; None where the run holds no such span (an untraced
run, or a port without the span)."""
from isp_bench import spans


def read(run):
    found = [s for s in spans.named(getattr(run, "spans", None) or [], "warp.opcode3")
             if s.device_ms is not None]
    if not found or not run.items:
        return None
    return spans.device_ms(found) / len(run.items)
