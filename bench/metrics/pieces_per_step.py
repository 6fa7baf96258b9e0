"""Pieces reached a batched reach launch: the pieces the stream service served in
the window over the batches it ran (its ``stats["batches_run"]``)."""


def read(run):
    if not run.counters.get("batches_run"):
        return None
    return run.counters["pieces"] / run.counters["batches_run"]
