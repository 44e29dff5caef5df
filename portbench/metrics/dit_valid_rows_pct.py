"""The share of the frame rows the DiT estimator computed in the traced
window that were valid frames, in % (the program's row counter,
`observability.ESTIMATOR_ROWS`: rows from the calls' shapes, valid rows
from their masks). None where the program does not count them."""


def read(ctx):
    rows = ctx["out"].get("rows")
    if not rows or not rows[0]:
        return None
    return 100.0 * rows[1] / rows[0]
