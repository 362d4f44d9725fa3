"""Solver iterations per fused frame over the window (the program's
``FrameReport.solver_iterations``)."""


def read(r):
    its = r.record.iterations
    return sum(its) / len(its) if its else None
