"""Mean host time of one ``tbptt_step`` call with its batch's host-to-device
copies, before its loss is read, over the traced window."""


def read(run):
    return run.spans.mean_ms("tbptt_step")
