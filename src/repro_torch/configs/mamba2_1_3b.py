"""mamba2-1.3b [ssm] — SSD (state-space duality) [arXiv:2405.21060].

Attention-free: 48 Mamba2 blocks, d_state=128, expand=2 (d_inner=4096,
64 heads of dim 64)."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=64,
    dtype="bfloat16",
    source="arXiv:2405.21060",
)

SMOKE = CONFIG.replace(
    name="mamba2-1.3b-smoke",
    num_layers=2,
    d_model=256,
    vocab_size=512,
    ssm_state=32,
    ssm_head_dim=32,
    ssm_chunk=16,
    dtype="float32",
)
