"""dump.durable_p75_ms: the 75th percentile, over every checkpoint of the window
whose dump committed, of the time from the call until the image committed;
dumps in flight at the window's close are waited for and count with their
whole latency.
The 75th is the highest percentile with ten samples beyond it in a
window of 45 to 60 nodes."""
from bench.harness.probes import percentile


def read(rec):
    return percentile(rec["durable_ms"], 75)
