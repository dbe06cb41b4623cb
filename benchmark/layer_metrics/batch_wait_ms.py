"""Mean milliseconds a step waited for its batch from the data layer
(`RecDataModule.train_batches`): harness spans around the next batch."""


def read(view):
    spans = view.spans_named("bench.batch_wait")
    if not spans:
        return None
    return sum(s.dur_us for s in spans) / len(spans) / 1e3
