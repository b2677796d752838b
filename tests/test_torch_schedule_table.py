"""The port's ``ScheduleTable`` and its persistence against the
reference's (``repro.comm.cost``): the same rows give the same merges
and the same lookups, by dtype, backend, load level, wire format, kernel
tier and operator; the port's table lives in its own file and under its
own environment variable (``BENCH_torch_serve_schedule.json``,
``REPRO_TORCH_SERVE_SCHEDULES``) and never reads the reference's. The
reference's own table cases (``tests/test_serve_fft.py``) run on both
packages."""
import json
import os

import pytest

from repro.comm import cost as rcost
from repro_torch.comm import cost as pcost

MODULES = pytest.mark.parametrize("cost", [rcost, pcost], ids=['reference', 'port'])

BASE = dict(mesh='1x1', shape='8x8', kind='complex', strategy='all_to_all')

#: rows covering every tag and the merge identity (the last row replaces
#: the first: same key, new numbers)
ROWS = [
    dict(BASE, dtype='complex64', coalesce_width=8, overlap_chunks=2, us_per_request=10.0),
    dict(BASE, dtype='complex128', coalesce_width=4, overlap_chunks=4, us_per_request=5.0),
    dict(BASE, dtype='complex64', coalesce_width=2, overlap_chunks=1, us_per_request=1.0,
         backend='cuda'),
    dict(BASE, dtype='complex64', coalesce_width=4, overlap_chunks=2, us_per_request=9.0,
         backend='cpu'),
    dict(BASE, dtype='complex64', coalesce_width=16, overlap_chunks=4, us_per_request=3.0,
         load=2),
    dict(BASE, dtype='complex64', coalesce_width=1, overlap_chunks=1, us_per_request=4.0,
         load=5),
    dict(BASE, dtype='complex64', coalesce_width=4, overlap_chunks=1, us_per_request=2.0,
         wire='fp16'),
    dict(BASE, dtype='complex64', coalesce_width=4, overlap_chunks=4, us_per_request=2.5,
         kernel='pallas'),
    dict(BASE, dtype='float32', kind='real', coalesce_width=2, overlap_chunks=2,
         us_per_request=6.0, op='greens'),
    dict(BASE, dtype='complex64', coalesce_width='8', overlap_chunks='1', us_per_request=7.5),
]

LOOKUPS = [
    dict(dtype='complex64'), dict(dtype='float32'), dict(), dict(backend='cpu'),
    dict(backend='cuda'), dict(backend='tpu'), dict(load=0), dict(load=3), dict(load=9),
    dict(wire='fp16'), dict(wire='bf16'), dict(kernel='pallas'),
    dict(kernel='pallas', backend='cuda'), dict(kind='real', op='greens'),
    dict(kind='real'), dict(mesh={'x': 2, 'y': 2}),
]


def _lookup(tbl, q):
    q = dict(q)
    mesh = q.pop('mesh', {'x': 1, 'y': 1})
    kind = q.pop('kind', 'complex')
    return tbl.lookup(mesh, (8, 8), kind, 'all_to_all', **q)


@pytest.mark.parametrize("q", LOOKUPS, ids=[json.dumps(q, sort_keys=True) for q in LOOKUPS])
def test_same_rows_same_lookup(q):
    assert (_lookup(pcost.ScheduleTable(ROWS), q)
            == _lookup(rcost.ScheduleTable(ROWS), q))


def test_same_rows_same_merge():
    p, r = pcost.ScheduleTable(ROWS[:5]), rcost.ScheduleTable(ROWS[:5])
    p.merge(ROWS[5:])
    r.merge(ROWS[5:])
    assert p.rows() == r.rows() and len(p) == len(r) == len(ROWS) - 1
    assert pcost.ScheduleTable.make_key({'x': 2, 'y': 4}, (16, 8), 'real', 'ppermute') == \
        rcost.ScheduleTable.make_key({'x': 2, 'y': 4}, (16, 8), 'real', 'ppermute')


@MODULES
def test_schedule_table_lookup_prefers_dtype(cost):
    rows = [dict(mesh='4x4', shape='8x8', kind='complex', strategy='all_to_all',
                 dtype='complex64', coalesce_width=8, overlap_chunks=2, us_per_request=10.0),
            dict(mesh='4x4', shape='8x8', kind='complex', strategy='all_to_all',
                 dtype='complex128', coalesce_width=4, overlap_chunks=4, us_per_request=5.0)]
    tbl = cost.ScheduleTable(rows)
    mesh_shape = {'x': 4, 'y': 4}
    got = tbl.lookup(mesh_shape, (8, 8), 'complex', 'all_to_all', dtype='complex64')
    assert (got['coalesce_width'], got['overlap_chunks']) == (8, 2)
    # unmeasured dtype: the fastest row of the key answers
    got = tbl.lookup(mesh_shape, (8, 8), 'complex', 'all_to_all', dtype='float32')
    assert got['coalesce_width'] == 4
    assert tbl.lookup(mesh_shape, (8, 8), 'real', 'all_to_all') is None
    assert tbl.lookup({'x': 2}, (8, 8), 'complex', 'all_to_all') is None


@MODULES
def test_schedule_table_backend_isolation(cost):
    mk = dict(mesh='4x4', shape='8x8', kind='complex', strategy='all_to_all', dtype='complex64')
    tbl = cost.ScheduleTable([
        dict(mk, coalesce_width=4, overlap_chunks=2, us_per_request=1.0, backend='gpu'),
        dict(mk, coalesce_width=2, overlap_chunks=1, us_per_request=9.0, backend='cpu')])
    assert len(tbl) == 2                       # same config, both survive
    mesh_shape = {'x': 4, 'y': 4}
    got = tbl.lookup(mesh_shape, (8, 8), 'complex', 'all_to_all', backend='cpu')
    assert got['coalesce_width'] == 2          # never the gpu row
    assert tbl.lookup(mesh_shape, (8, 8), 'complex', 'all_to_all', backend='tpu') is None


@MODULES
def test_save_load_and_persist_merge(cost, tmp_path):
    path = str(tmp_path / 'table.json')
    assert cost.ScheduleTable.load(path) is None          # absent
    cost.ScheduleTable(ROWS[:3]).save(path)
    assert cost.ScheduleTable.load(path).rows() == cost.ScheduleTable(ROWS[:3]).rows()
    assert cost.persist_schedule_rows(ROWS[3:], path) == os.path.abspath(path)
    assert cost.schedule_table(path).rows() == cost.ScheduleTable(ROWS).rows()
    with open(path, 'w') as fh:
        fh.write('{not json')
    assert cost.ScheduleTable.load(path) is None          # unreadable


def test_port_table_is_its_own(tmp_path, monkeypatch):
    """The port's default file and variable are its own; the reference's
    variable does not move the port's table, and '' disables it."""
    monkeypatch.delenv(pcost.SCHEDULE_ENV, raising=False)
    assert pcost.SCHEDULE_ENV == 'REPRO_TORCH_SERVE_SCHEDULES' != rcost.SCHEDULE_ENV
    default = pcost.schedule_table_path()
    assert os.path.basename(default) == 'BENCH_torch_serve_schedule.json'
    # beside the reference's BENCH_serve_schedule.json, at the repo root
    assert os.path.dirname(default) == os.path.dirname(
        os.path.abspath(rcost._default_schedule_path()))
    monkeypatch.setenv(rcost.SCHEDULE_ENV, str(tmp_path / 'reference.json'))
    assert pcost.schedule_table_path() == default
    alt = str(tmp_path / 'alt.json')
    monkeypatch.setenv(pcost.SCHEDULE_ENV, alt)
    assert pcost.schedule_table_path() == alt
    assert pcost.persist_schedule_rows(ROWS[:1]) == alt
    assert not os.path.exists(str(tmp_path / 'reference.json'))
    monkeypatch.setenv(pcost.SCHEDULE_ENV, '')
    assert pcost.schedule_table_path() is None
    assert pcost.persist_schedule_rows([]) is None
    assert pcost.schedule_table() is None
