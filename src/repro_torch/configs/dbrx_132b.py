"""dbrx-132b [moe] — 16 fine-grained experts top-4, GQA kv=8.
40L d_model=6144 48H d_ff(expert)=10752 vocab=100352 [hf:databricks]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name='dbrx-132b', family='moe',
    num_layers=40, d_model=6144,
    num_heads=48, num_kv_heads=8, head_dim=128,
    d_ff=10752, vocab_size=100352,
    rope_theta=5e5,
    moe=True, num_experts=16, num_shared_experts=0, top_k=4,
    tie_embeddings=False,
    source='hf:databricks/dbrx-base; unverified',
)
