"""Pinned host blocks that the CUDA caching host allocator had to allocate
(each a cudaHostAlloc, which stalls the launching thread) across the
engine's dispatches and finalizes, per group finalized
(`ServeStats.pinned_allocs / ServeStats.batches`): a count per unit of
work, so an engine that finalizes more groups in the window does not read
worse for it. None where the program does not count them."""


def read(ctx):
    stats = ctx["out"]["stats"]
    n = getattr(stats, "pinned_allocs", None)
    return n / stats.batches if n is not None and stats.batches else None
