"""The 95th percentile of the latency of every pair of the window, ms
(host clock, nearest rank)."""

from portbench.lib.stats import percentile


def read(r):
    return 1e3 * percentile(r.record.latencies_s, 95)
