"""The kernels' share of their roofline in the profiler slice: the sum of
each layer-window's least time (max of FLOP over 165 TFLOP/s and bytes over
3.35 TB/s, each input read once, each output written once; the heads and,
in training, Adam too; benchmark/lib/work.py) for the windows the slice's
batches completed, over the sum of every kernel's time in the slice."""
from benchmark.lib import work


def read(run):
    if run.trace is None or run.traffic["task"] != "train" or run.trace["kernel_s"] <= 0:
        return None
    least = run.slice_batches * run.windows * work.window_least_seconds(
        run.cfg, run.traffic["batch"], training=True)
    return 100.0 * least / run.trace["kernel_s"]
