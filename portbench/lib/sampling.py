"""Which answers of a window are compared with the reference: a uniform
sample of the requests it finished, drawn from the seed while the window
runs (reservoir sampling, so nothing but the sample is kept), and the
request the driver names besides (the longest solve, the last frame)."""

from __future__ import annotations

from portbench.lib.traffic import rng

SAMPLE_STREAM = 7  # the seed's generator stream for sampling


class Reservoir:
    """A uniform sample of ``k`` of the offered ``(key, value)`` items."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self._rng = rng(seed, SAMPLE_STREAM)
        self._items = []
        self.offered = 0

    def offer(self, key, value) -> None:
        if len(self._items) < self.k:
            self._items.append((key, value))
        else:
            j = int(self._rng.integers(0, self.offered + 1))
            if j < self.k:
                self._items[j] = (key, value)
        self.offered += 1

    def items(self):
        return sorted(self._items, key=lambda kv: kv[0])
