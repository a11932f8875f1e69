"""Mean host time per TBPTT batch of the 19 windows' ``train.forward`` and
``train.loss`` spans inside ``tbptt_step``, over the profiler slice."""
from benchmark.lib import program_spans


def read(run):
    return program_spans.per_batch_ms(run, "train.step", ["train.forward", "train.loss"])
