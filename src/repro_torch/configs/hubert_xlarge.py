"""hubert-xlarge [audio] — encoder-only, wav2vec2-style backbone
[arXiv:2106.07447].

The mel-spectrogram + conv feature extractor is STUBBED, as in the JAX
package: ``input_specs`` provides precomputed frame embeddings of width
d_model.  Encoder-only => no autoregressive decode step (``skip_reason``
skips decode_32k and long_500k).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="audio",
    num_layers=48,
    d_model=1280,
    num_heads=16,
    num_kv_heads=16,
    head_dim=80,
    d_ff=5120,
    vocab_size=504,
    causal=False,
    frontend="audio_stub",
    dtype="bfloat16",
    source="arXiv:2106.07447",
)

SMOKE = CONFIG.replace(
    name="hubert-xlarge-smoke",
    num_layers=2,
    d_model=256,
    num_heads=4,
    num_kv_heads=4,
    head_dim=64,
    d_ff=512,
    vocab_size=64,
    dtype="float32",
)
