"""Mean ms the host spends in a train step: the port's span ``train.step``,
which the step function opens around its work (the enqueue, and any wait
for the device that an op inside the step makes), over the steps of the
window's whole epochs (host clock)."""

from benchmark import spans


def read(record):
    return spans.per_step_ms(record, "train.step")
