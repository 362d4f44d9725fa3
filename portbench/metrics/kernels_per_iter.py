"""Device kernels a solver iteration launches, over the traced stretch: the
kernel nodes of the captured chunks replayed there over their iterations,
the program's ``solve.graph_kernels`` and ``solve.graph_iterations``
counters (a chunk's frozen iterations after the gate count too: their
kernels still launch). None untraced or without both counters."""

from portbench.lib import program


def read(r):
    got = program.counters()
    kernels, iterations = got.get("solve.graph_kernels"), got.get("solve.graph_iterations")
    if r.trace is None or not kernels or not iterations:
        return None
    return kernels / iterations
