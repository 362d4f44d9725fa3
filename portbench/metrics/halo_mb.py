"""Halo bytes rank 0 handed to ``isend`` a solve, MB (10^6 bytes), over the
traced stretch: the program's ``halo.bytes_sent`` counter."""

from portbench.lib import program


def read(r):
    t, sent = r.trace, program.counters().get("halo.bytes_sent")
    if t is None or t.stop <= t.first or sent is None:
        return None
    return sent / 1e6 / (t.stop - t.first)
