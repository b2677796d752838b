"""granite-3-8b [dense] — GQA kv=8.
40L d_model=4096 32H d_ff=12800 vocab=49155 [hf:ibm-granite]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name='granite-3-8b', family='dense',
    num_layers=40, d_model=4096,
    num_heads=32, num_kv_heads=8, head_dim=128,
    d_ff=12800, vocab_size=49155,
    source='hf:ibm-granite/granite-3.0-2b-base; hf',
)
