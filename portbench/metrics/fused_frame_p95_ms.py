"""The 95th percentile over every frame of the window of the time from a
frame's hand-over to ``fuse_sequence`` to its report, ms (host clock,
nearest rank)."""

from portbench.lib.stats import percentile


def read(r):
    return 1e3 * percentile(r.record.latencies_s, 95)
