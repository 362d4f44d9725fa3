"""The 2D step's share of its memory roofline across a hierarchical solve's
levels in the traced stretch, %: the bound of its calls there, each level's
iterations of each traced pair at that level's size (``lib/peaks.py::b2_bytes``
at D = 2: the warped field, the canonical and the warp read once, the new
warp written once; one call a solver iteration), over the device time of
every kernel in the stretch but B1's. That time also holds each pair's
pyramids (their EWA TSDFs' small kernels), the prolongations, the finest
live TSDF and the result reads' copies. One size for every call, as
``step2d_roofline`` takes, would count the coarse levels' calls up to 16
times too large. None untraced or without the record's
``level_iterations`` and ``level_voxels``."""

from portbench.lib import peaks


def read(r):
    t = r.trace
    levels = getattr(r.record, "level_iterations", None)
    voxels = getattr(r.record, "level_voxels", None)
    if t is None or not levels or not voxels:
        return None
    seconds = sum(t.kernel_s.values()) - t.kernel_time(peaks.B1_KERNELS)
    if seconds <= 0:
        return None
    moved = sum(its * peaks.b2_bytes(v, 2)
                for pair in levels[t.first:t.stop] for its, v in zip(pair, voxels))
    return 100.0 * moved / peaks.HBM_BYTES_PER_S / seconds
