"""Mean host time per batch of ``consensus.vote`` (the argmax) and
``consensus.readback`` (the label pack, the pinned allocation, its copy and
event) inside ``ConsensusStep.submit``, over the profiler slice."""
from benchmark.lib import program_spans


def read(run):
    return program_spans.per_batch_ms(run, "consensus.submit",
                                      ["consensus.vote", "consensus.readback"])
