"""``repro_torch.serve`` — FFT and language-model serving on the port.

Port of ``repro.serve``: the language-model server
:class:`ServeEngine` (prefill a prompt batch, then greedy decode; one
rank), and the FFT serving stack: :class:`FFTEngine`
(request coalescing, the background drainer, the stream pipeline,
retries, ``autotune`` and ``register_op``), its :class:`LRUPlanCache`,
the deterministic fault-injection plane (:class:`FaultPlan`), and the
multi-tenant service over it — the ``WFFT`` wire protocol
(:mod:`repro_torch.serve.protocol`), the adaptive drainer policy
(:class:`AdaptivePolicy`), :class:`FFTService` and :class:`FFTClient`.

    from repro_torch.serve import ServeEngine
    from repro_torch.launch.mesh import make_host_mesh

    with ServeEngine(cfg, make_host_mesh(1, 1), params, batch=8, prompt_len=2048,
                     max_len=2112) as eng:
        tokens = eng.generate({'tokens': prompts}, 64)

    from repro_torch.serve import FFTEngine
    from repro_torch.launch.mesh import make_fft_mesh

    with FFTEngine((512, 512, 512), make_fft_mesh(1, 1), max_coalesce=4,
                   max_wait_ms=2.0) as eng:
        tickets = [eng.submit(x) for x in requests]
        ys = [t.result() for t in tickets]

    with FFTService(make_fft_mesh(1, 1), max_coalesce=4).start('/tmp/fft.sock'):
        with FFTClient('/tmp/fft.sock', tenant='alice') as c:
            ys = c.transform(requests)              # numpy in, numpy out
"""
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.faults import FaultInjected, FaultPlan, FaultPoint
from repro_torch.serve.fft_engine import FFTEngine, FFTTicket, ResultTimeout
from repro_torch.serve.plan_cache import LRUPlanCache
from repro_torch.serve.policy import AdaptivePolicy, DrainerDecision, RateEstimator
from repro_torch.serve.service import (BrownoutBreaker, FFTClient, FFTService, RetryAfter,
                                       SLOClass, ServiceUnavailable, TenantConfig,
                                       default_slo_classes)

__all__ = ['AdaptivePolicy', 'BrownoutBreaker', 'DrainerDecision', 'FaultInjected',
           'FaultPlan', 'FaultPoint', 'FFTClient', 'FFTEngine', 'FFTService', 'FFTTicket',
           'LRUPlanCache', 'RateEstimator', 'ResultTimeout', 'RetryAfter', 'SLOClass',
           'ServeEngine', 'ServiceUnavailable', 'TenantConfig', 'default_slo_classes']
