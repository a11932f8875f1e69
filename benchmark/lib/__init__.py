"""The benchmark's yardstick: cells and files by name, seeded inputs, the
work arithmetic, spans, the profiler slice and the comparisons."""
