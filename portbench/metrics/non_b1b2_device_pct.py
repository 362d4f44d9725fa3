"""Share of rank 0's device-busy time in the traced stretch spent outside
B1 and B2, %: the halo copies, the collectives, padding, reductions and the
TSDFs."""

from portbench.lib import peaks


def read(r):
    t = r.trace
    if t is None or t.busy_s <= 0:
        return None
    kernels = t.kernel_time(peaks.B1_KERNELS) + t.kernel_time(peaks.B2_KERNELS)
    return 100.0 * max(0.0, t.busy_s - kernels) / t.busy_s
