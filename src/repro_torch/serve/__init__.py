"""``repro_torch.serve`` — continuous FFT serving on the port.

Port of the engine layer of ``repro.serve``: :class:`FFTEngine` (request
coalescing, the background drainer, the stream pipeline, retries,
``autotune`` and ``register_op``), its :class:`LRUPlanCache`, and the
deterministic fault-injection plane (:class:`FaultPlan`). The service,
its protocol and policy, and the language-model server are not ported
yet.

    from repro_torch.serve import FFTEngine
    from repro_torch.launch.mesh import make_fft_mesh

    with FFTEngine((512, 512, 512), make_fft_mesh(1, 1), max_coalesce=4,
                   max_wait_ms=2.0) as eng:
        tickets = [eng.submit(x) for x in requests]
        ys = [t.result() for t in tickets]
"""
from repro_torch.serve.faults import FaultInjected, FaultPlan, FaultPoint
from repro_torch.serve.fft_engine import FFTEngine, FFTTicket, ResultTimeout
from repro_torch.serve.plan_cache import LRUPlanCache

__all__ = ['FaultInjected', 'FaultPlan', 'FaultPoint', 'FFTEngine', 'FFTTicket',
           'LRUPlanCache', 'ResultTimeout']
