"""Device milliseconds a step of the torch passes of ``ssd_chunked``
(``models/ssm.py``): the device time launched inside the program's own
profiler ranges ``ssd.pad``, ``ssd.cum``, ``ssd.contrib`` and
``ssd.recurrence``, in the forward and in its rematerialised recompute, a
step of the traced block.  Nothing to read in a cell without Mamba2
layers."""

from portbench.metrics import range_s_per_step


def read(ctx):
    s = range_s_per_step(ctx, ("ssd.pad", "ssd.cum", "ssd.contrib", "ssd.recurrence"))
    return None if s is None else s * 1e3
