"""The benchmark's yardstick: cells, traffic generation, timing, trace
reduction, peaks and bytes, rank launch and the result line."""
