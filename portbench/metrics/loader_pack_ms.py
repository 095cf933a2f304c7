"""Trainer and loader (`data/prefetch.py`'s producer thread, `pack_batch`,
the native packer): the producer's packing time per batch (the program's
ring, `loader.pack`), in ms, the mean over the batches the traced calls
took, selected on the host clock.

Prints on stderr the same over every call of the window, and the share
of batches the consumer found already queued."""

from portbench import program_spans as ps


def summary(batches) -> str:
    packs = [1e-6 * (r.end_ns - r.start_ns) for r in batches]
    queued = sum(bool(r.queued) for r in batches)
    return (f"{len(batches)} batches, pack {sum(packs) / len(packs):.4f} ms "
            f"mean, {max(packs):.4f} ms max, {queued} of {len(batches)} "
            f"already queued when taken")


def read(run):
    traced = ps.loader_batches(run)
    if not traced:
        return None
    ps.say(f"loader, traced calls: {summary(traced)}")
    window = ps.loader_batches(run, traced_only=False)
    if window:
        ps.say(f"loader, window calls: {summary(window)}")
    return 1e3 * sum((r.end_ns - r.start_ns) * 1e-9
                     for r in traced) / len(traced)
