"""Data plane (``data/manager.py``, ``data/catalog.py``,
``data/persistence.py``): the share of the window spent outside
``TorchVectorStore.add_texts`` (persisting files, catalog writes, parsing,
chunking, the sync's diff), from the harness's spans."""


def read(d):
    spans = d.tracer.of("add_texts")
    if d.window_s <= 0 or not spans:
        return None
    return 100.0 * (1.0 - sum(t1 - t0 for _, t0, t1, _ in spans) / d.window_s)
