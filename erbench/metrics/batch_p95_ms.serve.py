"""95th percentile of the window's request latencies, ms, timed at the
client from submit to result."""
import statistics


def read(reading):
    lat = [c["t1"] - c["t0"] for c in reading.outcome.calls]
    if len(lat) < 2:
        return None
    return 1e3 * statistics.quantiles(lat, n=20)[18]
