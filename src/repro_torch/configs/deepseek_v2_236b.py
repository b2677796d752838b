"""deepseek-v2-236b [moe] — MLA (kv_lora=512, decoupled rope 64) + MoE
160 routed experts top-6 + 2 shared. 60L d_model=5120 128H
d_ff(expert)=1536 vocab=102400 [arXiv:2405.04434].

Simplification noted in DESIGN.md: every layer is MoE (the HF model's
first layer uses a dense 12288 FFN)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name='deepseek-v2-236b', family='moe',
    num_layers=60, d_model=5120,
    num_heads=128, num_kv_heads=128, head_dim=128,
    d_ff=1536, vocab_size=102400,
    block_pattern=('mla',),
    q_lora_rank=1536, kv_lora_rank=512,
    qk_nope_dim=128, rope_head_dim=64, v_head_dim=128,
    moe=True, num_experts=160, num_shared_experts=2, top_k=6,
    tie_embeddings=False,
    source='arXiv:2405.04434; hf',
)
