"""B2's (``csrc/fused_gradient.cu``) share of its memory roofline in the
traced stretch, %: the bound of its calls there (``lib/peaks.py``: each
input read once, each output written once, over the HBM rate; one call a
solver iteration) over the device time of its two kernels by name. A
frozen iteration's call, which returns at once, is not counted."""

from portbench.lib import peaks


def read(r):
    if r.trace is None:
        return None
    seconds = r.trace.kernel_time(peaks.B2_KERNELS)
    if seconds <= 0:
        return None
    bound = r.traced_calls()["b2"] * r.record.b2_call_bytes / peaks.HBM_BYTES_PER_S
    return 100.0 * bound / seconds
