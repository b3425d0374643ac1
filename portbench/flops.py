"""The yardstick's arithmetic: the card's peaks, the operations and bytes of
the work the metrics divide by, and the port's kernel launches a coded step.

Everything here is counted from the configuration's sizes and the cell's
shapes, so it stays the same whatever computes the work.  A product of an
(m, k) by a (k, n) matrix counts 2 m k n operations; elementwise work is not
counted.
"""

from __future__ import annotations

from .reference.model import CONV_K, head_dim, ssm_sizes

#: one NVIDIA H100 SXM at its 700 W limit (NVIDIA's data sheet, dense)
PEAK_BF16_OPS = 989e12
PEAK_BYTES = 3.35e12

BYTES = {"bfloat16": 2, "float32": 4}


def pairs(seq: int, causal: bool) -> int:
    """Query-key pairs a head scores over one sequence."""
    return seq * (seq + 1) // 2 if causal else seq * seq


def forward_ops(model: dict, seq: int) -> int:
    """Operations of one sequence of ``seq`` positions through the model's
    forward: every layer's products and the head."""
    d, L = model["d_model"], model["num_layers"]
    ops = 2 * seq * d * model["vocab_size"]                          # head
    if model["family"] in ("dense", "audio"):
        dh, hq, hkv = head_dim(model), model["num_heads"], model["num_kv_heads"]
        proj = 2 * seq * d * (hq + 2 * hkv) * dh + 2 * seq * hq * dh * d
        mlp = 2 * seq * 3 * d * model["d_ff"]
        attn = 2 * 2 * hq * dh * pairs(seq, model.get("causal", True))
        return ops + L * (proj + mlp + attn)
    if model["family"] == "ssm":
        di, st, nh, hd = ssm_sizes(model)
        Q = min(model.get("ssm_chunk", 64), seq)
        nc = -(-seq // Q)
        causal = Q * (Q + 1) // 2
        proj = 2 * seq * d * (2 * di + 2 * st + nh) + 2 * seq * di * d
        conv = 2 * seq * CONV_K * (di + 2 * st)
        ssd = nc * (2 * st * causal             # C B^T over the causal pairs
                    + 2 * nh * hd * causal      # the intra-chunk output
                    + 2 * Q * nh * hd * st      # the chunk's state
                    + 2 * Q * st * nh * hd      # C . h_prev
                    + 2 * nh * hd * st)         # the recurrence
        return ops + L * (proj + conv + ssd)
    raise NotImplementedError(f"no operation count for the {model['family']} family")


def step_ops(model: dict, seqs: int, seq: int) -> int:
    """A training step over ``seqs`` sequences: forward and backward, the
    backward twice the forward, nothing recomputed counted."""
    return 3 * seqs * forward_ops(model, seq)


def attention_bwd_work(model: dict, b: int, seq: int) -> tuple[int, int]:
    """(operations, bytes) of one attention backward call over ``b``
    sequences: the scores recomputed, dV, dP, dQ and dK, each 2 dh a pair a
    head; q, k, v, dO, the f32 log-sum-exp read, dq, dk, dv written once."""
    dh, hq, hkv = head_dim(model), model["num_heads"], model["num_kv_heads"]
    ops = 10 * dh * b * hq * pairs(seq, model.get("causal", True))
    elem = BYTES[model["dtype"]]
    n_bytes = elem * b * seq * dh * (3 * hq + 4 * hkv) + 4 * b * hq * seq
    return ops, n_bytes


def ssd_bwd_work(model: dict, b: int, seq: int) -> tuple[int, int]:
    """(operations, bytes) of one call of the SSD chunk scan's backward over
    ``b`` sequences: x, B, C, dy in the model's type, dt, cum, h_prev, D in
    f32 read once; dx, dB, dC in the model's type, ddt, dcum, dh_prev, dD in
    f32 written once.  The products: S = C B^T, dW and W^T dy over the
    causal pairs, dB and dC from dS, G = dy . h_prev and dh_prev; and the
    elementwise terms."""
    di, st, nh, hd = ssm_sizes(model)
    Q = min(model.get("ssm_chunk", 64), seq)
    nc = -(-seq // Q)
    bc, elem = b * nc, BYTES[model["dtype"]]
    causal = Q * (Q + 1) // 2
    ops = bc * (3 * 2 * causal * st + nh * (2 * 2 * causal * hd + 2 * 2 * Q * hd * st
                                            + 6 * causal + 4 * Q * st + 6 * Q * hd))
    x, bcm, rows = bc * Q * nh * hd, bc * Q * st, bc * Q * nh
    h_prev = bc * nh * hd * st
    dy = b * seq * nh * hd
    n_bytes = (elem * (x + 2 * bcm + dy) + 4 * (2 * rows + h_prev + nh)          # inputs
               + elem * (x + 2 * bcm) + 4 * (2 * rows + h_prev + nh))            # outputs
    return ops, n_bytes


def bound_s(ops: int, n_bytes: int) -> float:
    """The least time the card could take: the larger of the operations at
    the bf16 tensor-core peak and the bytes at the memory peak."""
    return max(ops / PEAK_BF16_OPS, n_bytes / PEAK_BYTES)


def launches_per_step(model: dict) -> dict[str, int]:
    """The port's kernel launches of one coded step (each layer body
    rematerialised: its forward kernels run in the forward and again in the
    backward, its backward kernels once; the final norm's forward once)."""
    L = model["num_layers"]
    if model["family"] == "ssm":
        norms, attn, scans = 2 * L, 0, L
    else:
        norms, attn, scans = 2 * L, L, 0
    return {"flash_attention": 2 * attn, "flash_attention_bwd": attn,
            "rmsnorm": 2 * norms + 1, "rmsnorm_bwd": norms + 1,
            "ssd_chunk_scan": 2 * scans, "ssd_chunk_scan_bwd": scans,
            "ssd_intra_chunk": 0, "coded_combine": 0}
