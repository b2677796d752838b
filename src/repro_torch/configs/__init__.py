"""Architecture registry: --arch <id> resolution for every launcher.

Port of ``repro.configs``: the same ten configs, data only."""
from __future__ import annotations

from typing import Dict, List

from repro_torch.configs.base import (ArchConfig, ShapeSpec, SHAPES, input_specs,
                                      make_batch, skip_reason, smoke_config)

from repro_torch.configs import (mamba2_1_3b, recurrentgemma_9b, codeqwen1_5_7b,
                                 granite_3_8b, qwen1_5_32b, internlm2_1_8b,
                                 hubert_xlarge, qwen2_vl_2b, deepseek_v2_236b,
                                 dbrx_132b)

_MODULES = (mamba2_1_3b, recurrentgemma_9b, codeqwen1_5_7b, granite_3_8b,
            qwen1_5_32b, internlm2_1_8b, hubert_xlarge, qwen2_vl_2b,
            deepseek_v2_236b, dbrx_132b)

ARCHS: Dict[str, ArchConfig] = {m.CONFIG.name: m.CONFIG for m in _MODULES}

__all__ = ['ARCHS', 'ArchConfig', 'SHAPES', 'ShapeSpec', 'get_config', 'input_specs',
           'list_archs',
           'make_batch', 'skip_reason', 'smoke_config']


def get_config(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f'unknown arch {name!r}; choose from {sorted(ARCHS)}')
    return ARCHS[name]


def list_archs() -> List[str]:
    return list(ARCHS)
