"""The port's ``LRUPlanCache`` against the reference's
(``repro.serve.plan_cache``): the same operations on both give the same
keys in LRU order, the same byte totals, the same evictions in the same
order, and the same count of failed eviction hooks. Also the reference's
own unit cases (``tests/test_serve_drainer.py::test_lru_plan_cache_unit``),
run on both packages."""
import warnings

import numpy as np
import pytest

from repro.serve.plan_cache import LRUPlanCache as RefCache
from repro_torch.serve.plan_cache import LRUPlanCache as PortCache

CACHES = pytest.mark.parametrize("cls", [RefCache, PortCache], ids=['reference', 'port'])


def _trace(cls, ops, **kw):
    """Run ``ops`` on a fresh cache; everything observable after each."""
    evicted = []

    def hook(k, v):
        evicted.append(k)
        if isinstance(k, str) and k.endswith('!'):
            raise RuntimeError(f"hook failed on {k}")
    c = cls(on_evict=hook, **kw)
    out = []
    with warnings.catch_warnings():
        warnings.simplefilter('ignore', RuntimeWarning)
        for op, key, arg in ops:
            if op == 'put':
                c.put(key, key.upper(), nbytes=arg)
            elif op == 'grow':
                c.grow(key, arg)
            elif op == 'get':
                out.append(c.get(key))
            elif op == 'pop':
                out.append(c.pop(key))
            elif op == 'set_nbytes':
                c.set_nbytes(key, arg)
            out.append((c.keys(), c.total_bytes, len(c), key in c, c.nbytes(key),
                        list(evicted), c.evictions, c.evict_errors))
    return out


def _random_ops(seed: int, n: int = 200):
    rng = np.random.default_rng(seed)
    keys = ['a', 'b', 'c', 'd', 'e!', 'f']
    names = ['put', 'put', 'grow', 'get', 'get', 'pop', 'set_nbytes']
    return [(names[rng.integers(len(names))], keys[rng.integers(len(keys))],
             int(rng.integers(0, 50))) for _ in range(n)]


@pytest.mark.parametrize("caps", [dict(max_entries=3), dict(max_bytes=100),
                                  dict(max_entries=2, max_bytes=60), dict()],
                         ids=['entries', 'bytes', 'both', 'unbounded'])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_same_operations_same_cache(caps, seed):
    ops = _random_ops(seed)
    assert _trace(PortCache, ops, **caps) == _trace(RefCache, ops, **caps)


@CACHES
def test_lru_plan_cache_unit(cls):
    evicted = []
    c = cls(max_entries=2, on_evict=lambda k, v: evicted.append(k))
    c.put('a', 1)
    c.put('b', 2)
    assert c.get('a') == 1                     # 'a' now MRU
    c.put('c', 3)
    assert evicted == ['b'] and c.keys() == ['a', 'c']
    assert c.get('b') is None
    # byte budget with growth
    cb = cls(max_bytes=100)
    cb.put('x', 'X', nbytes=60)
    cb.put('y', 'Y', nbytes=30)
    cb.grow('y', 40)                           # 60 + 70 > 100 -> evict x
    assert cb.keys() == ['y'] and cb.total_bytes == 70
    cb.grow('y', 1000)                         # sole entry never evicted
    assert cb.keys() == ['y']
    with pytest.raises(ValueError, match="max_entries"):
        cls(max_entries=0)
    with pytest.raises(ValueError, match="max_bytes"):
        cls(max_bytes=-1)


@CACHES
def test_raising_hook_warns_and_keeps_the_budget(cls):
    def hook(k, v):
        raise RuntimeError("flaky hook")
    c = cls(max_entries=1, on_evict=hook)
    c.put('a', 1, nbytes=5)
    with pytest.warns(RuntimeWarning, match="flaky hook"):
        c.put('b', 2, nbytes=7)
    assert c.keys() == ['b'] and c.total_bytes == 7
    assert c.evictions == 1 and c.evict_errors == 1
