"""qwen1.5-32b [dense] — QKV bias, full MHA kv=40.
64L d_model=5120 40H d_ff=27392 vocab=152064 [hf:Qwen/Qwen1.5].

cache_dtype=fp8 (e4m3), as the reference's config, which gives the
reason (the KV bytes of full multi-head attention at decode_32k)."""
import torch

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name='qwen1.5-32b', family='dense',
    num_layers=64, d_model=5120,
    num_heads=40, num_kv_heads=40, head_dim=128,
    d_ff=27392, vocab_size=152064,
    qkv_bias=True, rope_theta=1e6,
    cache_dtype=torch.float8_e4m3fn,
    tie_embeddings=False,
    source='hf:Qwen/Qwen1.5-0.5B; hf',
)
