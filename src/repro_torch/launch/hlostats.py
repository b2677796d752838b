"""Step statistics for the roofline analysis: what one eager step
dispatches.

Port of ``repro.launch.hlostats``. The reference compiles a step and
parses the HLO text (each while body once, scaled by its trip count);
the port's steps are eager, so this module counts the *dispatched
operations of one eager step*: every ATen and c10d operation that
reaches the dispatcher while :func:`count` is open, forward and
backward alike (autograd's backward and the recomputation of a
``torch.utils.checkpoint`` run on the calling thread and carry the
mode), so a loop of ten products is ten products here without any trip
count. It counts on ``meta`` tensors under a ``fake`` process group (the
dry run), on gloo ranks and on the card.

    with hlostats.count() as st:
        step(params, batch)
    st.analyze()      # the reference's keys, plus 'copies', 'ops' and 'kernels'

It reports, as the reference's ``analyze``:

* collective bytes by kind (``COLLECTIVES``), the operand-size
  convention: the bytes each rank hands the collective (an all-gather's
  block, a reduce-scatter's whole input, a send's tensor); a wire-byte
  estimate with the (g-1)/g ring factors, g read from the op's process
  group; and the number of collectives. A ring permute (``send`` and
  ``recv_``) counts at its send, as XLA's one collective-permute;
* ``dot_flops``: 2*M*N*K of every product (``mm``, ``bmm``, ``addmm``,
  ``baddbmm``, ``mv``, ``dot``; ``einsum`` and ``matmul`` arrive as
  these), also by the product's dtype (``dot_flops_by_dtype``: the
  card's peak differs by dtype);
* ``hbm_bytes_proxy``: operand plus result bytes of every dispatched
  operation except views and allocations. An eager operation does read
  its operands and write its result, so this is the step's traffic, not
  an over-count of fused chains as the reference's proxy is.

and beside them ``copies`` (bytes written by ``copy_``, ``clone``, which
``contiguous`` dispatches as, and ``_to_copy``, a cast, by op), ``ops``
(dispatched operations) and, through :attr:`StepStats.peak_live_bytes`,
the peak of live intermediate bytes: every storage an operation creates
is counted from its creation until it is freed.

The hand-written kernels launch through raw pointers, which no dispatch
mode sees: each launch (on the card, or a ``meta`` tensor's, which
launches nothing) reports to :data:`repro_torch.kernels.HOOKS`, where
:func:`count` holds a hook. ``kernels`` counts them by kernel module:
launches (also by body), bytes read and written (each plane once) and
flops (5 n log2 n a pencil, fp32); their bytes are in
``hbm_bytes_proxy`` and their flops in ``kernel_flops``.

Not ported: ``shape_bytes``, ``parse_computations``,
``wire_ratio_from_spmd`` and ``compile_with_spmd_dump``, which read XLA
text; the port's collectives run in their own dtype, so no wire
correction applies.
"""
from __future__ import annotations

import contextlib
import functools
import weakref
from collections import defaultdict
from typing import Dict, Iterator, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import kernels as K

COLLECTIVES = ('all-gather', 'all-reduce', 'reduce-scatter', 'all-to-all',
               'collective-permute')

#: c10d op -> (kind, index of the argument that holds the operand)
_C10D = {
    'allreduce_': ('all-reduce', 0),
    'allreduce_coalesced_': ('all-reduce', 0),
    'allgather_': ('all-gather', 1),
    '_allgather_base_': ('all-gather', 1),
    'allgather_into_tensor_coalesced_': ('all-gather', 1),
    'reduce_scatter_': ('reduce-scatter', 1),
    '_reduce_scatter_base_': ('reduce-scatter', 1),
    'reduce_scatter_tensor_coalesced_': ('reduce-scatter', 1),
    'alltoall_base_': ('all-to-all', 1),
    'alltoall_': ('all-to-all', 1),
    'send': ('collective-permute', 0),
}
#: c10d ops that move no bytes of their own (the receiving half of a permute)
_C10D_SILENT = {'recv_', 'recv_any_source_', 'barrier', 'monitored_barrier_'}

_COPIES = {'copy_', 'clone', '_to_copy'}
_ALLOC = {'empty', 'empty_like', 'new_empty', 'empty_strided', 'new_empty_strided',
          '_local_scalar_dense'}


def tensors_in(tree) -> list:
    """The tensors in an operation's arguments or result (nested tuples,
    lists and dicts)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (tuple, list)):
        return [t for x in tree for t in tensors_in(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in tensors_in(x)]
    return []


@functools.lru_cache(maxsize=None)
def _functional(func) -> bool:
    """Whether ``func`` makes new tensors only: no write to an operand,
    no result that aliases one."""
    sch = func._schema
    return (func.namespace == 'aten' and not sch.is_mutable and bool(sch.returns)
            and all(r.alias_info is None and str(r.type) == 'Tensor' for r in sch.returns))


_HASHABLE = (int, float, bool, str, type(None), torch.dtype, torch.device, torch.memory_format,
             torch.layout)


def _meta_key(x):
    """What a ``meta`` operation's result depends on: its tensors'
    shapes, strides and dtypes and its other arguments (None where an
    argument is not on ``meta`` or cannot be keyed)."""
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), x.stride(), x.dtype) if x.device.type == 'meta' else None
    if isinstance(x, (tuple, list)):
        parts = tuple(_meta_key(v) for v in x)
        return None if any(p is None and v is not None for p, v in zip(parts, x)) else parts
    if isinstance(x, dict):
        return _meta_key(tuple(x.items()))
    return x if isinstance(x, _HASHABLE) else None


@functools.lru_cache(maxsize=None)
def _composite(func) -> bool:
    """Whether ``func`` is a composite (it runs other operations)."""
    return torch._C._dispatch_has_kernel_for_dispatch_key(
        func.name(), torch._C.DispatchKey.CompositeImplicitAutograd)


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _dot_flops(name: str, args) -> float:
    """2*M*N*K of a product (a bias add not counted)."""
    if name in ('mm', 'bmm'):
        a, b = args[0], args[1]
    elif name in ('addmm', 'baddbmm'):
        a, b = args[1], args[2]
    elif name in ('mv', 'dot'):
        a, b = args[0], args[1]
    else:
        return 0.0
    # every product here is a (..., M, K) @ (..., K, N); mv/dot have N = 1
    return 2.0 * a.numel() * (b.shape[-1] if b.dim() >= 2 else 1)


def _group_ranks(args) -> Tuple[int, ...]:
    """The global ranks of the process group a c10d op runs on (it
    arrives boxed)."""
    pg_type = torch.distributed.ProcessGroup
    for a in args:
        if isinstance(a, torch.ScriptObject):
            a = pg_type.unbox(a)
        if isinstance(a, pg_type):
            return tuple(torch.distributed.get_process_group_ranks(a))
    raise ValueError('hlostats: a c10d op without its process group')


class StepStats(TorchDispatchMode):
    """The counters of one :func:`count` block (a ``TorchDispatchMode``)."""

    def __init__(self):
        super().__init__()
        self.num_partitions = (torch.distributed.get_world_size()
                               if torch.distributed.is_initialized() else 1)
        self.collective_bytes: Dict[str, float] = defaultdict(float)
        self.collective_wire_bytes: Dict[str, float] = defaultdict(float)
        self.collective_counts: Dict[str, float] = defaultdict(float)
        self.copies: Dict[str, float] = defaultdict(float)
        #: wire bytes by (kind, the group's global ranks): what crosses which links
        self.wire_by_group: Dict[Tuple[str, Tuple[int, ...]], float] = defaultdict(float)
        self.dot_flops = 0.0
        self.dot_flops_by_dtype: Dict[str, float] = defaultdict(float)
        self.hbm_bytes = 0.0
        self.ops = 0
        self.live_bytes = 0
        #: the most bytes of storages made inside the block alive at once
        self.peak_live_bytes = 0
        self._live: set = set()
        self._meta_results: Dict = {}
        #: the hand-written kernels' launches by kernel module
        self.kernels: Dict[str, Dict] = {}
        self.kernel_flops = 0.0

    def _kernel(self, rec: dict) -> None:
        """A kernel launch's report (``repro_torch.kernels.report``)."""
        k = self.kernels.setdefault(rec['name'], {'launches': 0, 'launches_by_body': {},
                                                  'bytes_read': 0, 'bytes_written': 0,
                                                  'flops': 0.0})
        k['launches'] += 1
        k['launches_by_body'][rec['body']] = k['launches_by_body'].get(rec['body'], 0) + 1
        k['bytes_read'] += rec['bytes_read']
        k['bytes_written'] += rec['bytes_written']
        k['flops'] += rec['flops']
        self.hbm_bytes += rec['bytes_read'] + rec['bytes_written']
        self.kernel_flops += rec['flops']

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        # under inference_mode a composite operation (matmul, linear,
        # einsum, contiguous, ...) arrives whole: count the parts it runs
        if _composite(func):
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = self._run(func, args, kwargs)
        self.ops += 1
        ns, name = func.namespace, func._schema.name.split('::')[-1]
        if ns == 'c10d':
            self._collective(name, args)
            return out
        if func.is_view:
            return out
        ins, outs = tensors_in(args) + tensors_in(kwargs), tensors_in(out)
        self._track(outs, ins)
        if name in _ALLOC:
            return out
        self.hbm_bytes += _nbytes(ins) + _nbytes(outs)
        if name in _COPIES:
            self.copies[name] += _nbytes(outs)
        flops = _dot_flops(name, args)
        if flops:
            self.dot_flops += flops
            self.dot_flops_by_dtype[str(outs[0].dtype).replace('torch.', '')] += flops
        return out

    def _run(self, func, args, kwargs):
        """``func``'s result. On ``meta`` a functional operation's result
        depends only on its operands' shapes, strides and dtypes, so it
        is made from a table of those: the meta kernels run in Python
        and would take most of a dry run's time."""
        key = _meta_key((args, kwargs)) if _functional(func) else None
        if key is None:
            return func(*args, **kwargs)
        key = (func, key)
        made = self._meta_results.get(key)
        if made is None:
            out = func(*args, **kwargs)
            outs = out if isinstance(out, tuple) else (out,)
            if all(t.device.type == 'meta' for t in outs):     # not a factory for a device
                self._meta_results[key] = (isinstance(out, tuple), tuple(
                    (tuple(t.shape), t.stride(), t.dtype) for t in outs))
            return out
        many, specs = made
        outs = tuple(torch.empty_strided(s, st, dtype=dt, device='meta') for s, st, dt in specs)
        return outs if many else outs[0]

    def _collective(self, name: str, args) -> None:
        if name in _C10D_SILENT:
            return
        if name not in _C10D:
            raise NotImplementedError(f'hlostats: c10d.{name} is not counted; add it to _C10D')
        kind, pos = _C10D[name]
        op_bytes = _nbytes(tensors_in(args[pos]))
        res_bytes = _nbytes(tensors_in(args[1 - pos])) if pos == 1 else op_bytes
        ranks = _group_ranks(args)
        g = len(ranks)
        if kind == 'all-reduce':
            wire = 2.0 * op_bytes * (g - 1) / g
        elif kind == 'collective-permute':
            wire = op_bytes
        else:
            wire = max(op_bytes, res_bytes) * (g - 1) / g
        self.collective_bytes[kind] += op_bytes
        self.collective_wire_bytes[kind] += wire
        self.collective_counts[kind] += 1
        self.wire_by_group[kind, ranks] += wire
        self.hbm_bytes += op_bytes + res_bytes

    def _track(self, outs, ins) -> None:
        """Count each storage among ``outs`` that no input holds (an
        operation's new result, not an in-place write) as live until it
        is freed."""
        held = {id(t.untyped_storage()) for t in ins}
        for t in outs:
            st = t.untyped_storage()
            key = id(st)
            if key in self._live or key in held:
                continue
            n = st.nbytes()
            self._live.add(key)
            self.live_bytes += n
            self.peak_live_bytes = max(self.peak_live_bytes, self.live_bytes)
            weakref.finalize(st, self._free, key, n)

    def _free(self, key: int, n: int) -> None:
        self._live.discard(key)
        self.live_bytes -= n

    def analyze(self) -> Dict:
        """The reference ``analyze``'s keys with their meanings (the
        per-rank counts of one step), plus ``copies`` and ``ops``."""
        return {
            'num_partitions': self.num_partitions,
            'collective_bytes': dict(self.collective_bytes),
            'collective_bytes_total': float(sum(self.collective_bytes.values())),
            # each collective ran once: nothing is scaled by a trip count
            'collective_bytes_once': dict(self.collective_bytes),
            'collective_wire_bytes': dict(self.collective_wire_bytes),
            'collective_wire_total': float(sum(self.collective_wire_bytes.values())),
            'collective_counts': dict(self.collective_counts),
            'dot_flops': float(self.dot_flops),
            'dot_flops_by_dtype': dict(self.dot_flops_by_dtype),
            'hbm_bytes_proxy': float(self.hbm_bytes),
            'copies': dict(self.copies),
            'ops': self.ops,
            'kernels': {k: {**v, 'launches_by_body': dict(v['launches_by_body'])}
                        for k, v in self.kernels.items()},
            'kernel_flops': float(self.kernel_flops),
        }


@contextlib.contextmanager
def count() -> Iterator[StepStats]:
    """Count what the block dispatches on this thread and the kernels it
    launches (see the module's docstring); ``analyze()`` the result after
    the block."""
    st = StepStats()
    K.HOOKS.append(st._kernel)
    try:
        with st:
            yield st
    finally:
        K.HOOKS.remove(st._kernel)
