"""Pair solves completed per second: every pair the window finished over
the window's whole time (host clock)."""


def read(r):
    return len(r.record.latencies_s) / r.record.window_s
