"""Model configuration: a field-for-field copy of the JAX package's
``ModelConfig``, so that a config of either package compares equal with its
twin."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0           # 0 -> d_model // num_heads
    qkv_bias: bool = False
    rope_theta: float = 500_000.0
    sliding_window: int = 0     # 0 = full attention
    tie_embeddings: bool = False

    # MoE
    num_experts: int = 0
    num_experts_per_tok: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0           # per-expert hidden dim (0 -> d_ff)

    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 64

    # hybrid (zamba2-style): one *shared* attention block applied after
    # every ``attn_every`` SSM layers
    attn_every: int = 0

    # modality
    causal: bool = True          # False -> encoder-only (audio)
    frontend: str = "none"       # none | vision_stub | audio_stub
    num_prefix_tokens: int = 0   # patch embeddings prepended (vlm)

    dtype: str = "float32"
    remat: bool = True
    # JAX package: Pallas kernels vs jnp path.  Never read by the port,
    # which dispatches on the tensors' device.
    use_pallas: bool = False
    # JAX package: unroll the layer scan, so that XLA's cost analysis, which
    # counts a while-loop body once, counts every layer.  Never read by the
    # port, whose layer loop is a Python loop and so always unrolled.
    scan_unroll: bool = False
    # FSDP-style activation constraint: when non-empty, layer bodies pin
    # hidden states to (act_batch_axes, act_seq_axis, whole) so that the
    # (sharded) params are gathered rather than the activations summed
    # (§Perf).  act_seq_axis="model" gives Megatron-style sequence
    # parallelism (long-sequence prefill where batch < mesh).  The port reads
    # them in ``transformer._act_constraint``, which redistributes DTensor
    # hidden states to that layout; plain tensors pass through.
    act_batch_axes: tuple = ()
    act_seq_axis: str = ""
    # activation-checkpoint policy: "full" | "dots" | "none" (see §Perf)
    remat_policy: str = "full"
    source: str = ""             # citation for the config

    @property
    def head_dim_(self) -> int:
        return self.head_dim or (self.d_model // max(self.num_heads, 1))

    @property
    def prefix_len(self) -> int:
        """Positions before the text: a vlm's patch embeddings, else 0.
        Sequence lengths and decode positions count them."""
        return self.num_prefix_tokens if self.frontend == "vision_stub" else 0

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def has_decode(self) -> bool:
        """Encoder-only models have no autoregressive decode step."""
        return self.causal

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic path available (SSM/hybrid recurrence or SWA)."""
        return self.family in ("ssm", "hybrid") or self.sliding_window > 0

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim

    @property
    def expert_d_ff(self) -> int:
        return self.moe_d_ff or self.d_ff

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # -- parameter counting (for roofline's 6*N*D) ------------------------
    def param_count(self, active_only: bool = False) -> int:
        d, dh = self.d_model, self.head_dim_
        n_attn_layers, n_ssm_layers = self._layer_split()
        attn = (
            d * (self.num_heads * dh)            # q
            + 2 * d * (self.num_kv_heads * dh)   # k, v
            + (self.num_heads * dh) * d          # o
        )
        if self.qkv_bias:
            attn += (self.num_heads + 2 * self.num_kv_heads) * dh
        mlp_dense = 3 * d * self.d_ff            # SwiGLU
        total = 0
        if self.family == "moe":
            e_ff = self.expert_d_ff
            routed = self.num_experts * 3 * d * e_ff
            active = self.num_experts_per_tok * 3 * d * e_ff
            shared = self.num_shared_experts * 3 * d * e_ff
            router = d * self.num_experts
            per_layer = attn + router + shared + (active if active_only else routed)
            total += self.num_layers * (per_layer + 2 * d)
        elif self.family in ("ssm", "hybrid"):
            di, st, nh = self.ssm_d_inner, self.ssm_state, self.ssm_heads
            # in_proj(z,x,B,C,dt) + out_proj + conv + A,D
            ssm_layer = (
                d * (2 * di + 2 * st + nh)
                + di * d
                + 4 * (di + 2 * st)
                + 2 * nh
                + d
            )
            total += n_ssm_layers * ssm_layer
            if self.family == "hybrid" and n_attn_layers:
                total += attn + mlp_dense + 2 * d  # ONE shared block
        else:
            total += self.num_layers * (attn + mlp_dense + 2 * d)
        total += self.vocab_size * d  # embedding
        if not self.tie_embeddings:
            total += self.vocab_size * d  # lm head
        total += d  # final norm
        return total

    def _layer_split(self) -> tuple[int, int]:
        if self.family == "hybrid":
            n_shared_calls = self.num_layers // max(self.attn_every, 1)
            return n_shared_calls, self.num_layers
        if self.family == "ssm":
            return 0, self.num_layers
        return self.num_layers, 0
