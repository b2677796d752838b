"""The port's adaptive drainer policy (``repro_torch.serve.policy``)
against the reference's (``repro.serve.policy``).

Both sides get the same seeded event sequences (arrivals, latencies and
time steps) under one fake clock, and every estimate and decision must
be equal — the policy is pure Python arithmetic, so equal means exactly
equal. The load-tagged rows round-trip through the port's own
``ScheduleTable`` and equal the reference's rows for the same history.
Plus the reference's own policy cases (``tests/test_serve_service.py``)
on the port.
"""
import dataclasses

import numpy as np
import pytest

import repro.comm.cost as jcost
import repro.serve.policy as jpol
import repro_torch.comm.cost as pcost
import repro_torch.serve.policy as ppol


class FakeClock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


def _events(seed, count=300):
    """(dt seconds, arrivals, latency us or None) triples: bursts, idle
    gaps and backward clock steps (a skewed clock)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        kind = rng.integers(0, 10)
        if kind == 0:
            dt = float(rng.uniform(0.5, 3.0))          # idle gap
        elif kind == 1:
            dt = -float(rng.uniform(0.0, 0.2))         # clock steps back
        else:
            dt = float(rng.exponential(0.004))
        n = int(rng.choice([0, 1, 1, 1, 2, 5, 40]))
        lat = float(rng.uniform(50, 5e4)) if rng.random() < 0.3 else None
        out.append((dt, n, lat))
    return out


def _decision(d):
    return (d.watermark, d.max_wait_ms, d.load_level, d.rate_per_s)


CONFIGS = [dict(), dict(max_coalesce=4, max_wait_ms=50.0), dict(max_coalesce=1),
           dict(max_coalesce=16, min_wait_ms=2.0, max_wait_ms=20.0, tau_s=0.1),
           dict(max_coalesce=8, max_wait_ms=100.0, tau_s=2.0, overlap_chunks=2)]


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("cfg", CONFIGS, ids=[f"cfg{i}" for i in range(len(CONFIGS))])
def test_policy_decisions_equal_the_references(cfg, seed):
    clock = FakeClock()
    port, ref = ppol.AdaptivePolicy(clock=clock, **cfg), jpol.AdaptivePolicy(clock=clock, **cfg)
    assert port.n_levels == ref.n_levels
    for dt, n, lat in _events(seed):
        clock.t += dt
        port.observe(n)
        ref.observe(n)
        assert _decision(port.decide()) == _decision(ref.decide())
        if lat is not None:
            port.note_latency(lat)
            ref.note_latency(lat)
    assert port._levels == ref._levels and port._level_us == ref._level_us
    key = ({'x': 1, 'y': 1}, (512, 512, 512), 'real', 'all_to_all')
    assert port.rows(*key, backend='cuda') == ref.rows(*key, backend='cuda')
    assert repr(port) == repr(ref)


@pytest.mark.parametrize("seed", range(3))
def test_rate_estimator_equals_the_references(seed):
    clock = FakeClock()
    port, ref = ppol.RateEstimator(0.5, clock=clock), jpol.RateEstimator(0.5, clock=clock)
    assert port.rate() == ref.rate() == 0.0
    for dt, n, _ in _events(seed):
        clock.t += dt
        port.observe(n)
        ref.observe(n)
        assert port.rate() == ref.rate() >= 0.0
        assert port.rate(clock.t + 0.25) == ref.rate(clock.t + 0.25)


def test_validation_matches_the_reference():
    for p in (ppol, jpol):
        with pytest.raises(ValueError, match="tau_s"):
            p.RateEstimator(0.0)
        with pytest.raises(ValueError, match="n must be"):
            p.RateEstimator().observe(-1)
        with pytest.raises(ValueError, match="max_coalesce"):
            p.AdaptivePolicy(0)
        with pytest.raises(ValueError, match="min_wait_ms"):
            p.AdaptivePolicy(4, min_wait_ms=10.0, max_wait_ms=5.0)
    assert ([f.name for f in dataclasses.fields(ppol.DrainerDecision)]
            == [f.name for f in dataclasses.fields(jpol.DrainerDecision)])


# ---------------------------------------------------------------------------
# Persistence: load-tagged rows through the port's ScheduleTable
# ---------------------------------------------------------------------------

def _visited(policy_mod, clock=None):
    pol = policy_mod.AdaptivePolicy(max_coalesce=16, max_wait_ms=50.0)
    t = 1000.0
    for burst in (0, 40, 4000):              # visit several load levels
        pol.observe(burst, t)
        pol.decide(t)
        pol.note_latency(123.0, t)
        t += 0.0005
    return pol


@pytest.mark.parametrize("backend", ['cuda', 'cpu'])
def test_rows_seed_round_trip_through_the_ports_table(tmp_path, backend):
    path = str(tmp_path / "sched.json")
    pol = _visited(ppol)
    ms, shape = {'x': 1, 'y': 1}, (32, 32)
    rows = pol.rows(ms, shape, 'complex', 'auto', backend=backend)
    assert rows == _visited(jpol).rows(ms, shape, 'complex', 'auto', backend=backend)
    assert len(rows) >= 2 and all(isinstance(r['load'], int) for r in rows)
    assert all(r['backend'] == backend for r in rows)
    pcost.persist_schedule_rows(rows, path)

    table = pcost.ScheduleTable.load(path)
    fresh = ppol.AdaptivePolicy(max_coalesce=16, max_wait_ms=50.0)
    assert fresh.seed(table, ms, shape, 'complex', 'auto', backend=backend) == len(rows)
    assert fresh._levels == pol._levels and fresh._level_us == pol._level_us
    # the other device type's rows never answer; the engine's load-less
    # lookup never sees policy rows
    other = 'cpu' if backend == 'cuda' else 'cuda'
    assert ppol.AdaptivePolicy(16).seed(table, ms, shape, 'complex', 'auto',
                                        backend=other) == 0
    assert table.lookup(ms, shape, 'complex', 'auto') is None
    # the reference's policy seeds from the same rows the same way
    jfresh = jpol.AdaptivePolicy(max_coalesce=16, max_wait_ms=50.0)
    assert jfresh.seed(jcost.ScheduleTable(rows), ms, shape, 'complex', 'auto',
                       backend=backend) == len(rows)
    assert jfresh._levels == fresh._levels


def test_seeded_rows_obey_the_cap_and_wait_bounds():
    table = pcost.ScheduleTable([dict(mesh='1x1', shape='8x8', kind='complex', strategy='auto',
                                      coalesce_width=64, overlap_chunks=1, load=1,
                                      max_wait_ms=1e6, backend='cpu')])
    pol = ppol.AdaptivePolicy(max_coalesce=4, max_wait_ms=50.0)
    assert pol.seed(table, {'x': 1, 'y': 1}, (8, 8), 'complex', 'auto', backend='cpu') == 1
    assert pol._levels[1] == (4, 50.0)
    assert pol.seed(None, {'x': 1, 'y': 1}, (8, 8), 'complex', 'auto') == 0


# ---------------------------------------------------------------------------
# The reference's policy cases (tests/test_serve_service.py) on the port
# ---------------------------------------------------------------------------

def test_rate_estimator_monotone_in_events():
    t0 = 1000.0
    a, b = ppol.RateEstimator(tau_s=0.5), ppol.RateEstimator(tau_s=0.5)
    a.observe(5, t0)
    b.observe(9, t0)
    assert b.rate(t0) > a.rate(t0)
    r_before = a.rate(t0)
    a.observe(1, t0)
    assert a.rate(t0) > r_before


def test_rate_estimator_decays_while_idle():
    est = ppol.RateEstimator(tau_s=0.5)
    est.observe(50, 1000.0)
    r0, r1, r2 = est.rate(1000.0), est.rate(1000.5), est.rate(1002.0)
    assert r0 > r1 > r2 > 0
    assert ppol.RateEstimator().rate() == 0.0


def test_rate_estimator_converges_to_arrival_rate():
    est = ppol.RateEstimator(tau_s=0.5)
    for i in range(2000):                    # 100 events/s for 20s
        est.observe(1, 1000.0 + i * 0.01)
    assert est.rate(1020.0) == pytest.approx(100.0, rel=0.1)


def test_policy_never_exceeds_max_coalesce():
    pol = ppol.AdaptivePolicy(max_coalesce=8, max_wait_ms=50.0)
    t = 1000.0
    for burst in (0, 1, 10, 1000, 100000):
        pol.observe(burst, t)
        d = pol.decide(t)
        assert 1 <= d.watermark <= 8
        assert pol.min_wait_ms <= d.max_wait_ms <= pol.max_wait_ms
        t += 0.001
    pol2 = ppol.AdaptivePolicy(max_coalesce=4)
    pol2._levels[2] = (64, 10.0)
    pol2.observe(100000, t)
    assert pol2.decide(t).watermark <= 4


def test_policy_load_levels_monotone_in_rate():
    pol = ppol.AdaptivePolicy(max_coalesce=16, max_wait_ms=50.0)
    levels = [pol.load_level(r) for r in (0.0, 10.0, 100.0, 1000.0, 100000.0)]
    assert levels == sorted(levels)
    assert levels[0] == 0 and levels[-1] == pol.n_levels - 1


def test_schedule_table_load_keyed_lookup():
    base = dict(mesh='4x4', shape='32x32', kind='complex', strategy='auto', overlap_chunks=1)
    table = pcost.ScheduleTable([
        dict(base, coalesce_width=2, us_per_request=10.0),
        dict(base, coalesce_width=4, load=1, us_per_request=20.0),
        dict(base, coalesce_width=8, load=3, us_per_request=30.0),
    ])
    ms, sh = {'x': 4, 'y': 4}, (32, 32)
    assert table.lookup(ms, sh, 'complex', 'auto')['coalesce_width'] == 2
    assert table.lookup(ms, sh, 'complex', 'auto', load=1)['coalesce_width'] == 4
    assert table.lookup(ms, sh, 'complex', 'auto', load=2)['coalesce_width'] == 4
    assert table.lookup(ms, sh, 'complex', 'auto', load=7)['coalesce_width'] == 8
    t2 = pcost.ScheduleTable([dict(base, coalesce_width=2)])
    assert t2.lookup(ms, sh, 'complex', 'auto', load=3)['coalesce_width'] == 2
