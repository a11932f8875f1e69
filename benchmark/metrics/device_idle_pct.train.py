"""The share of the profiler slice in which no kernel, copy or memset ran on
the card: 100 (1 - union of their intervals / the slice's length)."""


def read(run):
    if run.trace is None or run.traffic["task"] != "train":
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])
