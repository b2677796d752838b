"""The port's fault-injection plane (``repro_torch.serve.faults``)
against the reference's: the reference's own cases of FaultPlan and
FaultPoint (``tests/test_serve_faults.py``: schedules, limits, seeded
per-site determinism, interleaving invariance, clock skew, the raise
and stall helpers, thread safety, ``kill_socket``), each run on both
packages, and the same plan drawing the same fires in both."""
import socket
import threading

import pytest

from repro.serve import faults as ref_faults
from repro_torch.serve import faults as port_faults

MODULES = pytest.mark.parametrize("faults", [ref_faults, port_faults],
                                  ids=['reference', 'port'])


@pytest.mark.parametrize("seed", [0, 5])
def test_same_plan_same_fires(seed):
    """One plan of every schedule kind, drawn in one interleaved order,
    fires the same points in both packages."""
    def run(mod):
        plan = mod.FaultPlan([mod.FaultPoint('a', 'raise', p=0.4),
                              mod.FaultPoint('a', 'delay', every=3, limit=4),
                              mod.FaultPoint('b', 'stall', at=[1, 5, 6]),
                              mod.FaultPoint('b', 'skew', p=0.2, skew_s=1.5)], seed=seed)
        out = []
        for i in range(60):
            pt = plan.draw('ab'[i % 2])
            out.append(None if pt is None else pt.action)
        return out, plan.stats(), plan.total_fired(), plan.skew_s('b')
    assert run(port_faults) == run(ref_faults)


@MODULES
def test_fault_point_needs_exactly_one_schedule(faults):
    with pytest.raises(ValueError):
        faults.FaultPoint('s', 'drop')                      # no schedule
    with pytest.raises(ValueError):
        faults.FaultPoint('s', 'drop', p=0.5, at=[1])       # two schedules
    with pytest.raises(ValueError):
        faults.FaultPoint('s', 'nonsense', p=0.5)           # unknown action
    with pytest.raises(ValueError):
        faults.FaultPoint('s', 'drop', every=0)
    with pytest.raises(ValueError):
        faults.FaultPoint('s', 'drop', p=1.5)
    for a in faults.ACTIONS:
        faults.FaultPoint('s', a, p=0.5)                    # all actions arm


@MODULES
def test_scripted_at_schedule_fires_exactly_there(faults):
    plan = faults.FaultPlan([faults.FaultPoint('x', 'raise', at=[0, 3])])
    fired = [plan.draw('x') is not None for _ in range(6)]
    assert fired == [True, False, False, True, False, False]
    assert plan.stats()['x'] == {'hits': 6, 'fired': 2}


@MODULES
def test_every_schedule_fires_periodically(faults):
    plan = faults.FaultPlan([faults.FaultPoint('x', 'raise', every=3)])
    fired = [plan.draw('x') is not None for _ in range(9)]
    assert fired == [False, False, True] * 3


@MODULES
def test_limit_caps_fires(faults):
    plan = faults.FaultPlan([faults.FaultPoint('x', 'raise', every=1, limit=2)])
    fired = [plan.draw('x') is not None for _ in range(5)]
    assert fired == [True, True, False, False, False]


@MODULES
def test_probability_stream_is_deterministic_per_seed_and_site(faults):
    def run(seed):
        plan = faults.FaultPlan([faults.FaultPoint('a', 'raise', p=0.5),
                          faults.FaultPoint('b', 'raise', p=0.5)], seed=seed)
        return ([plan.draw('a') is not None for _ in range(64)],
                [plan.draw('b') is not None for _ in range(64)])

    a1, b1 = run(7)
    a2, b2 = run(7)
    a3, _ = run(8)
    assert a1 == a2 and b1 == b2          # same seed -> same schedule
    assert a1 != a3                       # different seed -> different
    assert a1 != b1                       # per-site independent streams
    assert any(a1) and not all(a1)


@MODULES
def test_site_streams_are_interleaving_invariant(faults):
    """A site's fire pattern depends only on ITS hit order — not on
    what other sites did in between (the property that makes a chaos
    run reproducible even when thread interleavings differ)."""
    plan1 = faults.FaultPlan([faults.FaultPoint('a', 'raise', p=0.3)], seed=3)
    solo = [plan1.draw('a') is not None for _ in range(32)]

    plan2 = faults.FaultPlan([faults.FaultPoint('a', 'raise', p=0.3),
                       faults.FaultPoint('b', 'raise', p=0.9)], seed=3)
    mixed = []
    for i in range(32):
        plan2.draw('b')                   # interleave another site
        mixed.append(plan2.draw('a') is not None)
        plan2.draw('b')
    assert solo == mixed


@MODULES
def test_exhausted_point_keeps_draw_sequence_invariant(faults):
    """A limit-exhausted probabilistic point still consumes its RNG
    draw, so a second point on the site sees the same stream whether
    or not the first ran out."""
    def pattern(limit):
        plan = faults.FaultPlan([faults.FaultPoint('x', 'delay', p=0.5, limit=limit),
                          faults.FaultPoint('x', 'raise', p=0.5)], seed=11)
        out = []
        for _ in range(64):
            pt = plan.draw('x')
            out.append(None if pt is None else pt.action)
        return out

    unlimited = pattern(limit=None)
    capped = pattern(limit=2)
    # after the cap, every hit where 'delay' fired in the unlimited run
    # must resolve identically for the SECOND point
    fires_seen = 0
    for u, c in zip(unlimited, capped):
        if u == 'delay':
            fires_seen += 1
            if fires_seen <= 2:
                assert c == 'delay'
        elif u == 'raise':
            assert c == 'raise'
        else:
            assert c is None


@MODULES
def test_skew_accumulates_into_clock(faults):
    plan = faults.FaultPlan([faults.FaultPoint('policy.clock', 'skew', at=[1, 2],
                                 skew_s=10.0)])
    clock = plan.clock()
    t0 = clock()                          # hit 0: no skew yet
    t1 = clock()                          # hit 1: +10
    t2 = clock()                          # hit 2: +20
    t3 = clock()                          # hit 3: stays +20
    assert t1 - t0 > 9.0
    assert t2 - t1 > 9.0
    assert t3 - t2 < 1.0
    assert plan.skew_s() == pytest.approx(20.0)


@MODULES
def test_perhaps_raise_and_stall(faults):
    plan = faults.FaultPlan([faults.FaultPoint('err', 'raise', at=[0], note='boom'),
                      faults.FaultPoint('sl', 'stall', at=[0], delay_s=0.01)])
    with pytest.raises(faults.FaultInjected) as ei:
        plan.perhaps_raise('err')
    assert ei.value.site == 'err' and 'boom' in str(ei.value)
    plan.perhaps_raise('err')             # hit 1: no fire, no raise
    assert plan.perhaps_stall('sl') == pytest.approx(0.01)
    assert plan.perhaps_stall('sl') == 0.0
    assert plan.total_fired() == 2


@MODULES
def test_plan_is_thread_safe_and_counts_every_hit(faults):
    plan = faults.FaultPlan([faults.FaultPoint('x', 'raise', p=0.5)], seed=1)
    n_threads, per_thread = 8, 200

    def worker():
        for _ in range(per_thread):
            plan.draw('x')

    threads = [threading.Thread(target=worker) for _ in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    st = plan.stats()['x']
    assert st['hits'] == n_threads * per_thread
    assert 0 < st['fired'] < st['hits']


@MODULES
def test_kill_socket_never_raises(faults):
    a, b = socket.socketpair()
    faults.kill_socket(a)
    faults.kill_socket(a)                        # double-kill is fine
    assert b.recv(1) == b''               # peer observes EOF
    b.close()
