"""Mean host time of one ``ConsensusStep.submit`` (the enqueue of a batch's
19 windows, vote, argmax and packed label copy), over the traced window."""


def read(run):
    return run.spans.mean_ms("submit")
