"""The 2D step's share of its memory roofline in the traced stretch, %: the
bound of its calls there (``lib/peaks.py::b2_bytes`` at D = 2, the byte
model's B2 in whose place the 2D step stands: the warped field, the
canonical and the warp read once, the new warp written once; one a solver
iteration) over the device time of every kernel in the stretch but B1's.
That time also holds each pair's two TSDFs (28 small kernels and ~42 µs a
TSDF at 96 x 48 on an H100: ~0.1% of a pair's kernels, ~0.3% of its kernel
time), the final resample's warp copy and the result read's copies."""

from portbench.lib import peaks


def read(r):
    t = r.trace
    if t is None:
        return None
    seconds = sum(t.kernel_s.values()) - t.kernel_time(peaks.B1_KERNELS)
    if seconds <= 0:
        return None
    bound = r.traced_calls()["b2"] * r.record.b2_call_bytes / peaks.HBM_BYTES_PER_S
    return 100.0 * bound / seconds
