"""``repro_torch.data`` — the synthetic token pipeline, port of ``repro.data``."""
from repro_torch.data.pipeline import SyntheticLM, shard_batch

__all__ = ['SyntheticLM', 'shard_batch']
