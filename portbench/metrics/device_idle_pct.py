"""Share of the traced stretch in which no operation ran on the device
(rank 0's on several chips), %: one minus the union of the device events
over the stretch."""


def read(r):
    t = r.trace
    if t is None or t.span_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.span_s)
