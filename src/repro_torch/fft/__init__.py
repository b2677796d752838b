"""``repro_torch.fft`` — the port's public FFT API.

    import repro_torch.fft as fft
    from repro_torch.launch.mesh import make_fft_mesh

    p = fft.plan((n, n, n), make_fft_mesh(1, 1))
    y = p.forward(x)                   # complex64 in -> complex64 out
    re, im = p.forward((re, im))       # planar float32 pairs work too
    x2 = p.inverse(y)

    r = fft.rplan((n, n, n), make_fft_mesh(1, 1))
    s = r.forward(xr)                  # float32 in -> complex64 (n, n, n//2 + 1)
    xr2 = r.inverse(s)

    q = fft.plan((1 << 24,), make_fft_mesh(1, 1))   # rank 1: the four-step
    y = q.forward(x)                   # (..., n) complex64, np.fft.fft
    s = fft.rplan((1 << 24,), make_fft_mesh(1, 1)).forward(xr)  # np.fft.rfft

    op = fft.plan_op((n, n, n), make_fft_mesh(1, 1), op=fft.spectral_mul,
                     spectra=(g,), spectra_form='spectrum')   # g in rfftn order
    u = op.apply(u)                    # irfftn(rfftn(u) * g), one plan

Local pencil algorithms live in the registry :mod:`repro_torch.fft.methods`;
the swaps dispatch through :mod:`repro_torch.comm.strategies`
(``plan(..., comm='auto')`` picks one with the cost model).
"""
from repro_torch import comm as _comm
from repro_torch.fft import methods
from repro_torch.fft.api import FFT, SpectralOp, plan, plan_op, rplan, spectral_mul
from repro_torch.fft.methods import apply as apply_method
from repro_torch.fft.methods import apply_real as apply_real_method


def available_methods():
    """Concrete method names the registry knows (plus the 'auto' alias)."""
    return methods.names() + ('auto',)


def available_comm_strategies():
    """Registered redistribution strategies (plus the 'auto' alias)."""
    return _comm.names() + ('auto',)


__all__ = ['FFT', 'SpectralOp', 'plan', 'rplan', 'plan_op', 'spectral_mul', 'methods',
           'apply_method', 'apply_real_method', 'available_methods',
           'available_comm_strategies']
