"""cam24.preview: 95th percentile of an item's submission to completion on the card (`readers.latency_p95_ms`)."""
from isp_bench.readers import latency_p95_ms as read  # noqa: F401
