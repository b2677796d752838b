"""Port parity: twiddle tables, layout algebra and schedules.

The port's host tables are the reference's numpy float64 arithmetic, so
they must be BITWISE equal; the layout algebra is pure Python, so its
results must be equal.
"""
import itertools

import numpy as np
import pytest

from repro.comm import cost as jcost
from repro.core import plan as jplan
from repro.core import twiddle as jtw
from repro.core import wse_model as jwm
from repro.fft import pencil as jpencil
from repro_torch.comm import cost as tcost
from repro_torch.core import plan as tplan
from repro_torch.core import twiddle as ttw
from repro_torch.core import wse_model as twm
from repro_torch.fft import pencil as tpencil

POW2 = [1 << k for k in range(0, 11)]


def _same(a, b):
    if isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", POW2)
def test_twiddle_tables_bitwise(n, inverse):
    _same(ttw.roots_of_unity_np(n, inverse=inverse),
          jtw.roots_of_unity_np(n, inverse=inverse))
    _same(ttw.stage_twiddles_np(n, inverse=inverse),
          jtw.stage_twiddles_np(n, inverse=inverse))
    _same(ttw.dft_matrix_np(n, inverse=inverse), jtw.dft_matrix_np(n, inverse=inverse))
    n1, n2 = ttw.four_step_factors(n)
    assert (n1, n2) == jtw.four_step_factors(n)
    _same(ttw.four_step_twiddle_np(n1, n2, inverse=inverse),
          jtw.four_step_twiddle_np(n1, n2, inverse=inverse))


def test_pow2_helpers():
    for n in range(0, 70):
        assert ttw.is_pow2(n) == jtw.is_pow2(n)
        if jtw.is_pow2(n):
            assert ttw.log2i(n) == jtw.log2i(n)
        else:
            with pytest.raises(ValueError):
                ttw.log2i(n)


def _layouts():
    """Every rank-3 layout of ('x', 'y', None) and the rank-2 layouts
    with single and tuple mesh axes."""
    out = list(itertools.permutations(('x', 'y', None)))
    for ax in ('x', ('x', 'y'), ('y', 'x')):
        out += [(ax, None), (None, ax)]
    return out


@pytest.mark.parametrize("layout", _layouts(), ids=str)
def test_schedules_equal_reference(layout):
    assert tpencil.forward_schedule(layout) == jpencil.forward_schedule(layout)
    assert tpencil.inverse_schedule(layout) == jpencil.inverse_schedule(layout)
    assert tplan.memory_axes(layout) == jplan.memory_axes(layout)


@pytest.mark.parametrize("layout", _layouts(), ids=str)
def test_real_schedules_and_pad_equal_reference(layout):
    """Schedules with the r2c axis forced first (``first_mem``), and the
    padded half-spectrum extent for several meshes, with and without
    the restore swaps."""
    for mem in tplan.memory_axes(layout):
        assert (tpencil.forward_schedule(layout, mem)
                == jpencil.forward_schedule(layout, mem))
        assert (tpencil.inverse_schedule(layout, mem)
                == jpencil.inverse_schedule(layout, mem))
    if layout[-1] is not None:
        return
    shape = (16,) * len(layout)
    for mesh in ({'x': 1, 'y': 1}, {'x': 2, 'y': 2}, {'x': 2, 'y': 4}, {'x': 4, 'y': 1}):
        for restore in (False, True):
            assert (tpencil.real_padded_extent(shape, layout, mesh, restore_layout=restore)
                    == jpencil.real_padded_extent(shape, layout, mesh,
                                                  restore_layout=restore)), (mesh, restore)


@pytest.mark.parametrize("rank", [2, 3])
def test_plan_swaps_equal_reference(rank):
    lays = [lay for lay in _layouts() if len(lay) == rank]
    for src, dst in itertools.product(lays, lays):
        if {o for o in src if o} != {o for o in dst if o}:
            continue
        assert tplan.plan_swaps(src, dst) == jplan.plan_swaps(src, dst), (src, dst)
        for ax in {o for o in src if o}:
            assert tplan.owner_pos(src, ax) == jplan.owner_pos(src, ax)
            for mp in tplan.memory_axes(src):
                assert tplan.swap(src, ax, mp) == jplan.swap(src, ax, mp)


def test_layout_errors_match_reference():
    lay = ('x', 'y', None)
    for mod in (tplan, jplan):
        with pytest.raises(ValueError):
            mod.swap(lay, 'x', 0)
        with pytest.raises(ValueError):
            mod.owner_pos(lay, 'z')


def test_plan_factories_match_reference():
    mesh = {'x': 2, 'y': 4}

    class _Mesh:
        shape = mesh

    t3, j3 = tplan.make_fft3d_plan(16, _Mesh()), jplan.make_fft3d_plan(16, None)
    assert (t3.shape, t3.layout) == (j3.shape, j3.layout)
    assert t3.local_shape() == (8, 4, 16)
    t2, j2 = tplan.make_fft2d_plan(16, 32, _Mesh()), jplan.make_fft2d_plan(16, 32, None)
    assert (t2.shape, t2.layout) == (j2.shape, j2.layout)
    assert t2.local_shape() == (2, 32)
    assert t2.local_shape(t2.layout[::-1]) == (16, 4)
    t3.validate()
    with pytest.raises(ValueError):
        tplan.make_fft2d_plan(4, 32, _Mesh()).validate()   # 4 rows over 8 ranks


@pytest.mark.parametrize("precision", ['fp16', 'fp32'])
def test_method_choice_equal_reference(precision):
    for n in [1 << k for k in range(1, 16)] + [3, 12, 100]:
        assert tcost.select_method(n, precision) == jcost.select_method(n, precision)
        if ttw.is_pow2(n):
            assert twm.pencil_cycles(n, precision) == jwm.pencil_cycles(n, precision)
        for m in ('stockham', 'four_step', 'block', 'direct'):
            assert (twm.pencil_cycles_method(n, precision, m)
                    == jwm.pencil_cycles_method(n, precision, m))
