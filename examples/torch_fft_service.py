"""Two tenants share one FFT engine through the port's multi-tenant service.

The PyTorch counterpart of ``examples/fft_service.py``: clients connect
to a :class:`repro_torch.serve.FFTService` over a unix socket and speak
the ``WFFT`` frame protocol (``repro_torch.serve.protocol``, the same
bytes as the JAX package's). The service multiplexes every connection
onto ONE engine on the card — all tenants' requests coalesce into the
same batched dispatches — while keeping the tenants isolated at the edge:

* ``ana`` is an *interactive* tenant: small quota, tight SLO deadline,
  so a lone request never sits out a long coalescing window.
* ``bulk`` is a *batch* tenant with a tiny inflight quota: fire-hosing
  past it earns typed ``RetryAfter`` backpressure (with a retry hint)
  instead of queue bloat, and ana's latency is untouched.

Outputs are bit-identical to per-request plan calls — the service only
changes who may enter and when groups dispatch, never the math. The
service runs on one rank (its engine's drainer does), on the card by
default:

    PYTHONPATH=src python examples/torch_fft_service.py --n 64 --requests 10
    PYTHONPATH=src python examples/torch_fft_service.py --device cpu
"""
import argparse
import os
import tempfile
import threading

import numpy as np

from repro_torch.launch.mesh import make_fft_mesh
from repro_torch.serve import FFTClient, FFTService, RetryAfter, TenantConfig
from repro_torch.weights import from_numpy


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--n', type=int, default=16)
    ap.add_argument('--requests', type=int, default=10)
    ap.add_argument('--device', choices=('cuda', 'cpu'), default='cuda')
    args = ap.parse_args()
    n = args.n
    mesh = make_fft_mesh(1, 1, device=args.device)
    shapes = [(n, n, n), (n, n)]
    rng = np.random.default_rng(7)

    reqs = []
    for i in range(args.requests):
        x = rng.standard_normal(shapes[i % len(shapes)]).astype(np.float32)
        if i % 2:
            x = (x + 1j * rng.standard_normal(x.shape)).astype(np.complex64)
        reqs.append(x)

    sock = os.path.join(tempfile.mkdtemp(prefix='fft_service_'), 's.sock')
    svc = FFTService(
        mesh=mesh, schedule_table=None,
        tenants=[TenantConfig('ana', max_inflight=4, slo='interactive'),
                 TenantConfig('bulk', max_inflight=2, slo='batch')],
    ).start(sock)
    try:
        # -- ana: mixed interactive stream, verified bit-identical ---------
        with FFTClient(sock, tenant='ana') as ana:
            outs = ana.transform(reqs)           # retries RetryAfter
            for x, y in zip(reqs, outs):
                p = svc.engine.plan_for(not np.iscomplexobj(x), shape=x.shape)
                ref = p.forward(from_numpy(x, mesh.device)).cpu().numpy()
                assert np.array_equal(y, ref)
            print(f"[fft_service] ana: {len(reqs)} mixed requests over the socket, "
                  f"bit-identical to per-request plans on {args.device}")

            # -- bulk floods past its quota while ana keeps serving ---------
            stats = {'served': 0, 'rejected': 0}

            def flood():
                with FFTClient(sock, tenant='bulk') as bulk:
                    tickets = [bulk.submit(reqs[0]) for _ in range(12)]
                    for t in tickets:
                        try:
                            t.result(timeout=600)
                            stats['served'] += 1
                        except RetryAfter as ra:
                            assert ra.retry_after_ms > 0
                            stats['rejected'] += 1

            th = threading.Thread(target=flood)
            th.start()
            ana_outs = ana.transform(reqs[:4])
            th.join(timeout=600)
            assert len(ana_outs) == 4 and not th.is_alive()

            m = ana.metrics()
            assert m['tenants']['ana']['rejected'] == {}
            lat = m['tenants']['ana']['latency_ms'].get('interactive', {})
            print(f"[fft_service] bulk: served={stats['served']} "
                  f"rejected={stats['rejected']} (quota 2, typed backpressure); "
                  f"ana: 0 rejections, p99 {lat.get('p99_ms', float('nan')):.1f}ms")
            pol = m['service'].get('policy')
            if pol:
                print(f"  adaptive policy: level={pol['load_level']} "
                      f"watermark={pol['watermark']} wait={pol['max_wait_ms']:.1f}ms "
                      f"(rate {pol['rate_per_s']:.0f}/s)")
    finally:
        svc.close(drain=True)
    print('torch_fft_service OK')


if __name__ == '__main__':
    main()
