"""The share of the traced stretch's solver iterations that ran the fused 2D
step kernel, %: 100 × the program's ``solve.step2d_iterations`` (the kernel's
launches that the replayed chunks recorded) over ``solve.graph_iterations``
(the replayed chunks' iterations). None untraced or without both counters: a
program without the kernel records none."""

from portbench.lib import program


def read(r):
    got = program.counters()
    fused, iterations = got.get("solve.step2d_iterations"), got.get("solve.graph_iterations")
    if r.trace is None or not fused or not iterations:
        return None
    return 100.0 * fused / iterations
