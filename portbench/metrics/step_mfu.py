"""The coded step's share of the card's bf16 peak: the forward and backward
operations of every sequence the step computes, counted from the
configuration's sizes with nothing recomputed counted (``flops.step_ops``),
over the coded step's own time, the harness's spans around each call of the
window's steps (each ended by a synchronize), a step; at
``flops.PEAK_BF16_OPS``.  The master loop's time between the steps is
``host_ms_per_job``'s."""

from portbench import flops


def read(ctx):
    w = ctx.window
    if not w["jobs"] or not w["step_s"]:
        return None
    ops = flops.step_ops(ctx.model, ctx.seqs, ctx.mix["seq_len"])
    return 100 * ops / (w["step_s"] / w["jobs"]) / flops.PEAK_BF16_OPS
