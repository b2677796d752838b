"""hubert-xlarge [audio] — encoder-only (bidirectional), masked-unit
prediction over 504 k-means units. 48L d_model=1280 16H d_ff=5120.
The conv waveform frontend is a STUB: input_specs provides precomputed
frame embeddings (B, S, d_model) [arXiv:2106.07447]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name='hubert-xlarge', family='audio',
    num_layers=48, d_model=1280,
    num_heads=16, num_kv_heads=16, head_dim=80,
    d_ff=5120, vocab_size=504,
    causal=False, pos_kind='none',
    input_mode='embeds',
    norm_kind='ln', norm_eps=1e-5, act='gelu', mlp_gated=False,
    tie_embeddings=False,
    source='arXiv:2106.07447; unverified',
)
