"""Mean host time of one ``ConsensusStep.transfer`` on the prefetch thread
(pinning a batch and issuing its copy on the side stream), over the traced
window."""


def read(run):
    return run.spans.mean_ms("transfer")
