"""itl_p95_ms: the 95th percentile of every gap between consecutive output
tokens of one request, over all requests' gaps in the window (host clock):
one percentile over all gaps."""
from bench.stats import percentile


def read(record):
    gaps = record.get("itl_gaps_s")
    if not gaps:
        return None
    return 1e3 * percentile(gaps, 95)
