"""mamba2-1.3b [ssm] — SSD (state-space duality), attention-free.
48L d_model=2048 d_ff=0 vocab=50280 ssm_state=128 [arXiv:2405.21060]."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name='mamba2-1.3b', family='ssm',
    num_layers=48, d_model=2048,
    num_heads=64, num_kv_heads=0, head_dim=64,   # SSD heads = d_inner/64
    d_ff=0, vocab_size=50280,
    block_pattern=('ssd',),
    ssm_state=128, ssm_expand=2, ssm_head_dim=64, ssm_groups=1,
    ssm_chunk=256, conv_width=4,
    norm_kind='rms',
    source='arXiv:2405.21060; unverified',
)
