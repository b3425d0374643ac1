"""The yardstick's arithmetic: the card's peaks, the operations and bytes of
the work the metrics divide by, and the port's kernel launches a coded step.

Everything here is counted from the configuration's sizes and the cell's
shapes, so it stays the same whatever computes the work.  A product of an
(m, k) by a (k, n) matrix counts 2 m k n operations; elementwise work is not
counted.  The layers' operations and launches are the family's stack module's
(``stack_ops``, ``launches_per_step``: ``reference.stacks.stack_for``, the
contract in that package's docstring); a family with no module raises here
as in the reference.  The kernels' work functions read sizes from the model,
whatever its family.
"""

from __future__ import annotations

from .reference.model import head_dim, ssm_sizes
from .reference.stacks import stack_for

#: one NVIDIA H100 SXM at its 700 W limit (NVIDIA's data sheet, dense)
PEAK_BF16_OPS = 989e12
PEAK_BYTES = 3.35e12

BYTES = {"bfloat16": 2, "float32": 4}


def pairs(seq: int, causal: bool) -> int:
    """Query-key pairs a head scores over one sequence."""
    return seq * (seq + 1) // 2 if causal else seq * seq


def forward_ops(model: dict, seq: int) -> int:
    """Operations of one sequence of ``seq`` positions through the model's
    forward: the stack's (``stack_ops``) and the head."""
    head = 2 * seq * model["d_model"] * model["vocab_size"]
    return head + stack_for(model).stack_ops(model, seq)


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


def step_launches(norms: int = 0, attention: int = 0, scans: int = 0) -> dict[str, int]:
    """The port's kernel launches of one coded step whose layers run
    ``norms`` RMSNorms, ``attention`` attention calls and ``scans`` fused SSD
    chunk scans a forward.  Each layer body is rematerialised: its forward
    kernels run in the forward and again in the backward, its backward
    kernels once; the final norm's forward runs once."""
    return {"flash_attention": 2 * attention, "flash_attention_bwd": attention,
            "rmsnorm": 2 * norms + 1, "rmsnorm_bwd": norms + 1,
            "ssd_chunk_scan": 2 * scans, "ssd_chunk_scan_bwd": scans,
            "ssd_intra_chunk": 0, "coded_combine": 0}


def launches_per_step(model: dict) -> dict[str, int]:
    """The port's kernel launches of one coded step: the family's stack
    module's ``launches_per_step``.  A family with no stack module raises; its
    launches are never counted as another family's.  ``chip_smoke._per_step``
    stays the copy that ``test_launch_formula_is_chip_smokes`` checks this
    against, for the families that have modules (dense and audio, ssm)."""
    return stack_for(model).launches_per_step(model)
