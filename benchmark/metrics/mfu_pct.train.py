"""The whole step's share of the card's peak in the profiler slice: the
model FLOP of the windows the slice's batches completed (benchmark/lib/work.py)
over the slice's length times the peak, 165 TFLOP/s (3xTF32)."""
from benchmark.lib import work


def read(run):
    if run.trace is None or run.traffic["task"] != "train":
        return None
    windows = run.slice_batches * run.traffic["batch"] * run.windows
    return 100.0 * windows * work.window_flop(run.cfg, training=True) / (
        run.trace["window_s"] * work.PEAK_FLOPS)
