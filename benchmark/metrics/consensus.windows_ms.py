"""Mean host time per batch of the 19 ``consensus.window`` spans of
``models/transducer.py``'s window loop (forward and softmax vote enqueued),
inside ``ConsensusStep.submit``, over the profiler slice."""
from benchmark.lib import program_spans


def read(run):
    return program_spans.per_batch_ms(run, "consensus.submit", ["consensus.window"])
