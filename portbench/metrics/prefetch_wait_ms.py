"""Time the program blocked on the native depth decoder's queue a frame,
ms, over the traced stretch: its ``lsf.io.prefetch_wait`` spans."""

from portbench.lib import program


def read(r):
    seconds = program.per_request(r, ("lsf.io.prefetch_wait",), "host_s")
    return None if seconds is None else 1e3 * seconds
