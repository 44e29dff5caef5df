"""The share of the traced serving window in which no operation ran on the
device, in %."""


def read(ctx):
    trace = ctx["out"]["trace"]
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
