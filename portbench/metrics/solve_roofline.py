"""The share of the memory roofline of the window's solver iterations, %:
every iteration's bytes over the whole volume (a B1 and a B2 call,
``lib/peaks.py::iteration_bytes``, whatever kernels implement them) over the
chips' HBM rate, over the wall time they took. The work counted is the same
whatever the program does to do it. In a traced run the requests of the
traced stretch and its time are left out, since the profiler slows them."""

from portbench.lib import peaks


def read(r):
    rec, t = r.record, r.trace
    its, seconds = list(rec.iterations), rec.window_s
    if t is not None:
        its = its[:t.first] + its[t.stop:]
        seconds -= t.wall_s
    if not its or seconds <= 0:
        return None
    bound = sum(its) * peaks.iteration_bytes(rec.voxels, rec.dim)
    return 100.0 * bound / (r.chips * peaks.HBM_BYTES_PER_S) / seconds
