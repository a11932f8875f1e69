"""Mean host time per batch of ``consensus.transfer.pin``, the batch's
``pin_memory()`` copy inside ``ConsensusStep.transfer`` on the prefetch
thread, over the profiler slice."""
from benchmark.lib import program_spans


def read(run):
    return program_spans.per_batch_ms(run, "consensus.transfer", ["consensus.transfer.pin"])
