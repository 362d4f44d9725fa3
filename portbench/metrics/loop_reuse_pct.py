"""The share of the traced stretch's ``solve_single_level`` calls that reused
the kept solve loop, %: 100 × kept / (kept + built) from the program's
``solve.loop_kept`` and ``solve.loop_built`` counters (a missing one is 0)."""

from portbench.lib import program


def read(r):
    got = program.counters()
    kept, built = got.get("solve.loop_kept", 0), got.get("solve.loop_built", 0)
    if r.trace is None or kept + built == 0:
        return None
    return 100.0 * kept / (kept + built)
