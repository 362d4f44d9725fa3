"""Frames fused per second: every frame the window reported over the
window's whole time (host clock)."""


def read(r):
    return len(r.record.latencies_s) / r.record.window_s
