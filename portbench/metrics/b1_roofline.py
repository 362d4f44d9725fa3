"""B1's (``csrc/resample.cu``) share of its memory roofline in the traced
stretch, %: the bound of its calls there (``lib/peaks.py``; one call a
solver iteration and one for the final or the blend's resample) over the
device time of its kernel by name."""

from portbench.lib import peaks


def read(r):
    if r.trace is None:
        return None
    seconds = r.trace.kernel_time(peaks.B1_KERNELS)
    if seconds <= 0:
        return None
    bound = r.traced_calls()["b1"] * r.record.b1_call_bytes / peaks.HBM_BYTES_PER_S
    return 100.0 * bound / seconds
