"""Idle share of the card over the traced window (`readers.device_idle_pct`)."""
from isp_bench.readers import device_idle_pct as read  # noqa: F401
