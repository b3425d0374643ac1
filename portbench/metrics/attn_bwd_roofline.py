"""The attention backward kernels' share of their roofline, in %: the bound
of a step's attention backward work at the cell's shape (the larger of its
operations at the bf16 peak and its bytes at the memory peak,
``flops.attention_bwd_work``) over the device time of the step's dQ and
dK/dV launches.  Nothing to read in a cell without attention."""

from portbench import flops
from portbench.metrics import kernel_s_per_step


def read(ctx):
    t = kernel_s_per_step(ctx, "flash_attention_bwd", ("attn_bwd_dq", "attn_bwd_dkdv"))
    if not t:
        return None
    ops, n_bytes = flops.attention_bwd_work(ctx.model, ctx.seqs, ctx.mix["seq_len"])
    calls = ctx.launches["per_job"]["flash_attention_bwd"]
    return 100 * calls * flops.bound_s(ops, n_bytes) / t
