"""Mean time the fusion waited on its frame source for a frame, ms: the
benchmark's span around each ``next()`` on the iterator that
``fuse_sequence`` consumes."""


def read(r):
    waits = r.record.io_wait_s
    return 1e3 * sum(waits) / len(waits) if waits else None
