"""Device milliseconds a step of the optimizer (``optim/adamw.py``): the
device time launched inside the harness's profiler range around each
``adamw_update`` call of the traced block, a step."""

from portbench.metrics import range_s_per_step


def read(ctx):
    s = range_s_per_step(ctx, ("portbench.adamw",))
    return None if s is None else s * 1e3
