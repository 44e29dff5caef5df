"""Requests per engine group in the window (`ServeStats.batch_sizes`)."""


def read(ctx):
    sizes = ctx["out"]["stats"].batch_sizes
    return sum(sizes) / len(sizes) if sizes else None
