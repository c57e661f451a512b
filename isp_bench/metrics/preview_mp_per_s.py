"""cam24.preview: raw megapixels taken in per second over the window (`readers.mp_per_s`)."""
from isp_bench.readers import mp_per_s as read  # noqa: F401
