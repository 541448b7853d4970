"""Device: share of the traced slice in which no kernel, copy or fill ran
on the card (``torch.profiler``), under ingest."""

from ragbench.layer_metrics._common import idle_percent


def read(d):
    return idle_percent(d)
