"""Embedder under ingest (``models/bert.py`` under ``add_texts``): the
encoder FLOPs of the real tokens of every chunk the window stored, over
the window's time at the bf16 peak of 989 TFLOP/s."""

from ragbench.layer_metrics._common import encoder_bound_s


def read(d):
    texts = [t for _, _, _, batch in d.tracer.of("add_texts") for t in batch]
    if not texts or d.window_s <= 0:
        return None
    return 100.0 * encoder_bound_s(d, texts) / d.window_s
