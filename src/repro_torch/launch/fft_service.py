"""Launcher for the multi-tenant FFT service (repro_torch.serve.service).

Port of ``repro.launch.fft_service``, with the same subcommands and
flags, except that ``--mesh RxC`` and ``--device cuda|cpu`` name the
port's mesh (``make_fft_mesh``) where the reference took ``--devices``
(its fake host devices). The default device is ``cuda``, which raises
without a card. The service serves on one rank (``--mesh 1x1``): its
engine's drainer refuses a larger mesh.

Three entry points:

* ``serve`` — bind an :class:`repro_torch.serve.FFTService` to a unix socket
  (or TCP ``host:port``) and serve until interrupted (or
  ``--duration`` elapses). Tenants are declared as
  ``name[:rate_per_s[:burst[:max_inflight[:slo]]]]`` and/or a
  ``--tenant-file`` JSON list of TenantConfig dicts; ``SIGHUP``
  re-reads the file and hot-swaps the tenant set atomically (the
  in-band equivalent of a client RELOAD frame) without dropping
  inflight requests.
* ``client`` — connect as one tenant, stream a mixed workload of
  complex and real transforms, verify every result numerically, and
  print the server's metrics document.
* ``--smoke`` (also the ``smoke`` subcommand) — one process, one
  1x1-mesh service, two concurrent tenant clients over a unix socket;
  asserts results, per-tenant accounting, and a clean drain on
  shutdown. This is the CI gate.

    PYTHONPATH=src python -m repro_torch.launch.fft_service --smoke
    PYTHONPATH=src python -m repro_torch.launch.fft_service --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.fft_service serve \\
        --address /tmp/fft.sock --mesh 1x1 --device cuda \\
        --tenants alice:100:16:8:standard,batch:inf:64:16:batch
    PYTHONPATH=src python -m repro_torch.launch.fft_service client \\
        --address /tmp/fft.sock --tenant alice --requests 8
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import tempfile
import threading
import time


def _mesh(spec: str, device: str):
    from repro_torch.launch.mesh import make_fft_mesh
    rows, cols = (int(t) for t in spec.split('x'))
    return make_fft_mesh(rows, cols, device=device)


def _address(spec: str):
    if ':' in spec and not spec.startswith('/'):
        host, port = spec.rsplit(':', 1)
        return (host, int(port))
    return spec


def _tenant_specs(spec: str):
    """``name[:rate[:burst[:max_inflight[:slo]]]]`` entries, comma-
    separated."""
    import math
    from repro_torch.serve import TenantConfig
    out = []
    for item in filter(None, (s.strip() for s in spec.split(','))):
        parts = item.split(':')
        kw = {'name': parts[0]}
        if len(parts) > 1:
            kw['rate_per_s'] = (math.inf if parts[1] in ('inf', '')
                                else float(parts[1]))
        if len(parts) > 2 and parts[2]:
            kw['burst'] = int(parts[2])
        if len(parts) > 3 and parts[3]:
            kw['max_inflight'] = int(parts[3])
        if len(parts) > 4 and parts[4]:
            kw['slo'] = parts[4]
        out.append(TenantConfig(**kw))
    return out


def _load_tenant_file(path: str):
    """A JSON list of TenantConfig dicts — the durable, reloadable
    form (``TenantConfig.to_dict`` round-trips through it)."""
    from repro_torch.serve import TenantConfig
    with open(path) as f:
        specs = json.load(f)
    if not isinstance(specs, list):
        raise ValueError(f"{path}: expected a JSON list of tenant "
                         f"configs, got {type(specs).__name__}")
    return [TenantConfig.from_dict(d) for d in specs]


def _mixed_requests(rng, shapes, count):
    """Alternating complex/real operands over the shape rotation."""
    import numpy as np
    reqs = []
    for i in range(count):
        shape = shapes[i % len(shapes)]
        x = rng.standard_normal(shape).astype(np.float32)
        if i % 2:
            x = (x + 1j * rng.standard_normal(shape)).astype(np.complex64)
        reqs.append(x)
    return reqs


def _verify(x, y) -> float:
    """Max abs error of a served transform vs the numpy reference."""
    import numpy as np
    ref = (np.fft.fftn(x) if np.iscomplexobj(x)
           else np.fft.rfftn(x))
    err = float(np.abs(np.asarray(y) - ref).max())
    scale = max(1.0, float(np.abs(ref).max()))
    if err > 1e-3 * scale:
        raise AssertionError(f"served transform diverged: max abs err "
                             f"{err:g} (scale {scale:g})")
    return err


def cmd_serve(args) -> None:
    from repro_torch.serve import FFTService
    mesh = _mesh(args.mesh, args.device)
    tenants = _tenant_specs(args.tenants)
    if args.tenant_file:
        tenants += _load_tenant_file(args.tenant_file)
    svc = FFTService(
        mesh, tenants=tenants,
        max_inflight=args.max_inflight,
        policy=None if args.no_adaptive else 'adaptive',
        allow_unknown_tenants=args.allow_unknown or None,
        max_coalesce=args.max_coalesce,
        heartbeat_timeout_s=args.heartbeat_timeout or None,
        schedule_table=args.schedules if args.schedules else 'auto',
    ).start(_address(args.address))
    # the SIGHUP handler goes in before the ready line: a caller that
    # signals on reading it must not meet SIGHUP's default, which ends
    # the process
    if args.tenant_file and hasattr(signal, 'SIGHUP'):
        def _on_hup(signum, frame):
            # hot reload: re-read the file and swap the tenant set
            # atomically; inflight requests ride through untouched
            try:
                gen = svc.reload_tenants(
                    _load_tenant_file(args.tenant_file),
                    retire_missing=True)
                print(f'[fft_service] SIGHUP: tenant config reloaded '
                      f'from {args.tenant_file} (generation {gen})',
                      flush=True)
            except Exception as exc:
                # a malformed file must never take the service down:
                # the old config stays in force
                print(f'[fft_service] SIGHUP reload FAILED, keeping '
                      f'previous config: {exc}', flush=True)
        signal.signal(signal.SIGHUP, _on_hup)
    print(f'[fft_service] serving on {svc.address!r} '
          f'(mesh {args.mesh} on {args.device}, tenants '
          f'{sorted(t.name for t in tenants) or "open"})',
          flush=True)
    try:
        if args.duration:
            time.sleep(args.duration)
        else:
            while True:
                time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        svc.close(drain=True)
        print('[fft_service] drained and closed', flush=True)


def cmd_client(args) -> None:
    import numpy as np
    from repro_torch.serve import FFTClient
    shapes = [tuple(int(t) for t in s.split('x'))
              for s in args.shapes.split(',')]
    reqs = _mixed_requests(np.random.default_rng(args.seed), shapes,
                           args.requests)
    with FFTClient(_address(args.address), tenant=args.tenant) as c:
        t0 = time.perf_counter()
        outs = c.transform(reqs, real=None, slo=args.slo or None)
        dt = time.perf_counter() - t0
        for x, y in zip(reqs, outs):
            _verify(x, y)
        c.drain(timeout=60)
        m = c.metrics()
        print(f'[fft_service] tenant {args.tenant}: {len(reqs)} requests '
              f'in {dt:.2f}s ({dt / len(reqs) * 1e3:.1f} ms/req), '
              f'all verified')
        print(json.dumps(m['tenants'].get(args.tenant, {}), indent=2))


def cmd_smoke(args) -> None:
    """Server + two tenant clients in one process over a unix socket;
    asserts results, accounting, backpressure typing, clean drain."""
    import numpy as np
    from repro_torch.serve import (FFTClient, FFTService, RetryAfter,
                             TenantConfig)
    mesh = _mesh('1x1', args.device)
    path = os.path.join(tempfile.mkdtemp(prefix='fft_service_'),
                        'fft.sock')
    svc = FFTService(
        mesh, schedule_table=None,
        tenants=[TenantConfig('alice', max_inflight=8),
                 TenantConfig('bob', max_inflight=8, slo='interactive')],
        allow_unknown_tenants=False,
    ).start(path)

    shapes = [(16, 16), (8, 8, 8)]
    errs, failures = [], []

    def run_client(tenant: str, seed: int, slo: str) -> None:
        try:
            reqs = _mixed_requests(np.random.default_rng(seed), shapes, 6)
            with FFTClient(path, tenant=tenant) as c:
                outs = c.transform(reqs, slo=slo)
                for x, y in zip(reqs, outs):
                    errs.append(_verify(x, y))
                c.drain(timeout=60)
        except BaseException as exc:         # surfaced after join
            failures.append((tenant, exc))

    threads = [threading.Thread(target=run_client, args=a)
               for a in [('alice', 0, 'standard'),
                         ('bob', 1, 'interactive')]]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive(), 'smoke client wedged'
    assert not failures, f'client failures: {failures!r}'
    assert len(errs) == 12, f'expected 12 verified results, got {len(errs)}'

    with FFTClient(path, tenant='alice') as probe:
        m = probe.metrics()
    for tenant in ('alice', 'bob'):
        tm = m['tenants'][tenant]
        assert tm['completed'] == 6, (tenant, tm)
        assert tm['failed'] == 0 and tm['inflight'] == 0, (tenant, tm)
    assert m['service']['inflight'] == 0, m['service']

    # typed backpressure is importable and carries the retry hint
    ra = RetryAfter('rate', 12.5, 'alice')
    assert ra.retry_after_ms == 12.5 and ra.reason == 'rate'

    # hot tenant reload swaps configs in place (generation bumps, the
    # re-weighted tenant is visible in metrics, nothing drops)
    gen = svc.reload_tenants(
        [TenantConfig('alice', max_inflight=8, weight=2.0),
         TenantConfig('bob', max_inflight=8, slo='interactive')])
    assert gen == 1, gen
    rm = svc.metrics()
    assert rm['service']['reload_generation'] == 1
    assert rm['tenants']['alice']['weight'] == 2.0

    svc.close(drain=True)
    assert svc._inflight_total == 0
    assert svc.engine.closed
    # the socket path is gone: nothing half-open survives the drain
    assert not os.path.exists(path)
    print('[fft_service] smoke: 2 tenants x 6 mixed requests verified, '
          'metrics consistent, clean drain')
    print('fft_service smoke OK')


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    if '--smoke' in argv:
        argv = ['smoke'] + [a for a in argv if a != '--smoke']
    ap = argparse.ArgumentParser(prog='fft_service')
    sub = ap.add_subparsers(dest='cmd', required=True)

    s = sub.add_parser('serve', help='run the service')
    s.add_argument('--address', required=True,
                   help='unix socket path or host:port')
    s.add_argument('--mesh', default='1x1')
    s.add_argument('--device', choices=('cuda', 'cpu'), default='cuda')
    s.add_argument('--tenants', default='',
                   help='name[:rate[:burst[:max_inflight[:slo]]]],...')
    s.add_argument('--tenant-file', default='',
                   help='JSON list of TenantConfig dicts; SIGHUP '
                        're-reads it and hot-swaps the tenant set')
    s.add_argument('--heartbeat-timeout', type=float, default=0,
                   help='reap connections idle this many seconds '
                        '(0: never)')
    s.add_argument('--max-inflight', type=int, default=64)
    s.add_argument('--max-coalesce', type=int, default=16)
    s.add_argument('--no-adaptive', action='store_true')
    s.add_argument('--allow-unknown', action='store_true')
    s.add_argument('--schedules', default='',
                   help='schedule table path (default: packaged table)')
    s.add_argument('--duration', type=float, default=0,
                   help='serve this many seconds, then drain (0: forever)')
    s.set_defaults(fn=cmd_serve)

    c = sub.add_parser('client', help='stream a verified workload')
    c.add_argument('--address', required=True)
    c.add_argument('--tenant', default='default')
    c.add_argument('--shapes', default='16x16,8x8x8')
    c.add_argument('--requests', type=int, default=8)
    c.add_argument('--seed', type=int, default=0)
    c.add_argument('--slo', default='')
    c.set_defaults(fn=cmd_client)

    k = sub.add_parser('smoke', help='single-process CI smoke')
    k.add_argument('--device', choices=('cuda', 'cpu'), default='cuda')
    k.set_defaults(fn=cmd_smoke)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == '__main__':
    main()
