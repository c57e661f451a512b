"""Device kernel time per item in the traced window (`readers.device_ms_per_item`)."""
from isp_bench.readers import device_ms_per_item as read  # noqa: F401
