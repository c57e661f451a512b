"""Device kernels per item in the traced window (`readers.launches_per_item`)."""
from isp_bench.readers import launches_per_item as read  # noqa: F401
