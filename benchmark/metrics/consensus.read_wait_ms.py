"""Mean host time per batch that ``ConsensusStep.read`` waits for the card
(``consensus.read.wait``, the readback's event synchronised), over the
profiler slice."""
from benchmark.lib import program_spans


def read(run):
    return program_spans.per_batch_ms(run, "consensus.read", ["consensus.read.wait"])
