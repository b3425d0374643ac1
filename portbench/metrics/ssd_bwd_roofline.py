"""The SSD chunk scan backward kernels' share of their roofline, in %: the
bound of a step's SSD backward work at the cell's shape (the larger of its
operations at the bf16 peak and its bytes at the memory peak,
``flops.ssd_bwd_work``) over the device time of the step's inter, intra and
finish launches.  Nothing to read in a cell without Mamba2 layers."""

from portbench import flops
from portbench.metrics import kernel_s_per_step


def read(ctx):
    t = kernel_s_per_step(ctx, "ssd_chunk_scan_bwd",
                          ("ssd_bwd_inter", "ssd_bwd_intra", "ssd_bwd_finish"))
    if not t:
        return None
    ops, n_bytes = flops.ssd_bwd_work(ctx.model, ctx.seqs, ctx.mix["seq_len"])
    calls = ctx.launches["per_job"]["ssd_chunk_scan_bwd"]
    return 100 * calls * flops.bound_s(ops, n_bytes) / t
