"""The port's config registry (``repro_torch.configs``) against the
reference's (``repro.configs``): every ``ArchConfig`` field by field,
``smoke_config``, ``SHAPES`` and ``skip_reason``; and ``make_batch``'s
seeded batches."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
import repro_torch.configs as C


def _fields(cfg):
    out = dataclasses.asdict(cfg)
    out['cache_dtype'] = str(out['cache_dtype']).replace('torch.', '')
    return out


def _ref_fields(cfg):
    out = dataclasses.asdict(cfg)
    out['cache_dtype'] = np.dtype(out['cache_dtype']).name
    return out


def test_the_registry_lists_the_same_archs():
    assert C.list_archs() == RC.list_archs()
    assert len(C.ARCHS) == 10
    with pytest.raises(KeyError, match='unknown arch'):
        C.get_config('gpt-5')


@pytest.mark.parametrize('arch', RC.list_archs())
def test_configs_equal_field_by_field(arch):
    assert [f.name for f in dataclasses.fields(C.ArchConfig)] == [
        f.name for f in dataclasses.fields(RC.ArchConfig)]
    assert _fields(C.get_config(arch)) == _ref_fields(RC.get_config(arch))
    assert (_fields(C.smoke_config(C.get_config(arch)))
            == _ref_fields(RC.smoke_config(RC.get_config(arch))))


def test_cache_dtypes_are_torch_dtypes():
    assert C.get_config('internlm2-1.8b').cache_dtype is torch.bfloat16
    assert C.get_config('qwen1.5-32b').cache_dtype is torch.float8_e4m3fn


def test_shapes_and_skip_reasons():
    assert {k: dataclasses.asdict(v) for k, v in C.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in RC.SHAPES.items()}
    for arch in RC.list_archs():
        for name in RC.SHAPES:
            assert (C.skip_reason(C.get_config(arch), C.SHAPES[name])
                    == RC.skip_reason(RC.get_config(arch), RC.SHAPES[name]))


@pytest.mark.parametrize('arch', ['internlm2-1.8b', 'qwen2-vl-2b', 'hubert-xlarge'])
def test_make_batch_is_seeded(arch):
    """The reference's keys, shapes and dtypes (its values come from
    jax.random, the port's from numpy given the seed)."""
    cfg, rcfg = C.get_config(arch), RC.get_config(arch)
    b = C.make_batch(cfg, batch=2, seq=5, seed=3, device='cpu')
    rb = RC.make_batch(rcfg, batch=2, seq=5, dtype=jnp.float32)
    assert {k: (tuple(v.shape), str(v.dtype)) for k, v in b.items()} == {
        k: (tuple(v.shape), 'torch.' + str(v.dtype)) for k, v in rb.items()}
    again = C.make_batch(cfg, batch=2, seq=5, seed=3, device='cpu')
    assert all(torch.equal(b[k], again[k]) for k in b)
    if 'tokens' in b:
        assert int(b['tokens'].min()) >= 0 and int(b['tokens'].max()) < cfg.vocab_size
