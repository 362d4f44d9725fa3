"""Host time a solve spent building, capturing and releasing its solve loop,
ms, over the traced stretch: the program's ``lsf.solve.build``,
``lsf.solve.capture`` and ``lsf.solve.release`` spans."""

from portbench.lib import program

SETUP = ("lsf.solve.build", "lsf.solve.capture", "lsf.solve.release")


def read(r):
    seconds = program.per_request(r, SETUP, "host_s")
    return None if seconds is None else 1e3 * seconds
