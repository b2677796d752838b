"""qwen2-vl-2b [vlm] — M-RoPE (t/h/w position streams), GQA kv=2.
28L d_model=1536 12H d_ff=8960 vocab=151936. The vision patch frontend
is a STUB: input_specs provides patch/text embeddings plus the 3-stream
position ids [arXiv:2409.12191]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name='qwen2-vl-2b', family='vlm',
    num_layers=28, d_model=1536,
    num_heads=12, num_kv_heads=2, head_dim=128,
    d_ff=8960, vocab_size=151936,
    pos_kind='mrope', mrope_sections=(16, 24, 24), rope_theta=1e6,
    qkv_bias=True,
    input_mode='embeds',
    tie_embeddings=False,
    source='arXiv:2409.12191; hf',
)
