"""Host time a pair spent building its pyramids, ms, over the traced
stretch: the program's ``lsf.pyramid`` spans (each pyramid's TSDFs, on the
host's clock; ``models/hierarchical.py::build_pyramid_from_depth``). None
untraced or from a program that records no such span."""

from portbench.lib import program


def read(r):
    seconds = program.per_request(r, ("lsf.pyramid",), "host_s")
    return None if seconds is None else 1e3 * seconds
