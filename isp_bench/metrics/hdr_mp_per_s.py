"""hdr5.bracket: raw megapixels taken in per second over the window, 120 MP a burst (`readers.mp_per_s`)."""
from isp_bench.readers import mp_per_s as read  # noqa: F401
