"""Trainer and loader (`Trainer.train_call`, `pack_batch`, the native
packer, `data/prefetch.py`): the host time a window call waits for its
batches, in ms, the mean over the window's calls."""


def read(run):
    t0 = run.calls[0][1] if run.calls else None
    got = [b - a for a, b, _ in run.spans.of("loader_wait")
           if t0 is not None and a >= t0]
    return 1e3 * sum(got) / len(got) if got else None
