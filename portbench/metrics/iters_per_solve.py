"""Solver iterations per pair solve over the window (the program's
``SolveResult.iterations``)."""


def read(r):
    its = r.record.iterations
    return sum(its) / len(its) if its else None
