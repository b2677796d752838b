"""recurrentgemma-9b [hybrid] — RG-LRU + local attention, 2 recurrent :
1 attention. 38L d_model=4096 16H (MQA kv=1) d_ff=12288 vocab=256000
window=2048 [arXiv:2402.19427]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name='recurrentgemma-9b', family='hybrid',
    num_layers=38, d_model=4096,
    num_heads=16, num_kv_heads=1, head_dim=256,
    d_ff=12288, vocab_size=256_000,
    block_pattern=('rglru', 'rglru', 'local_attn'),
    window=2048,
    lru_width=4096, lru_chunk=256, conv_width=4,
    embed_scale=True, act='gelu',
    source='arXiv:2402.19427; unverified',
)
