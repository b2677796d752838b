"""A 3-D pseudo-spectral PDE solver on the card: the counterpart of
``examples/spectral_solver.py``.

The paper's motivating workload (§1 "differential equations", §5.3 an
FFT in the time-stepping loop): the field stays where it is, and every
step runs forward FFT -> spectral update -> inverse FFT. The field is
real, so the main loop uses the half-spectrum plan (``fft.rplan``) with
``padded_spectrum=True``: the spectrum stays in the forward's layout and
the factor carries a few zero pad bins. The fused operator plan
(``fft.plan_op`` with the integrating factor baked in ``'spectrum'``
form) runs the whole rfft -> multiply -> irfft step as one ``apply``; a
complex plan runs the same integration as the baseline.

It integrates u_t + c . grad(u) = nu * lap(u) with an exact
integrating-factor step in Fourier space, so each loop's field is held
against the closed-form solution (relative error <= 1e-3). The factors
and the closed-form field are built on the device from the reference's
1-D wavenumber and coordinate vectors by broadcasting, in float64 and
then cast, with no full 3-D grid on the host; each rank builds only its
block.
``--mesh RxC`` runs one process a rank under ``torch.distributed.run``.

    PYTHONPATH=src python examples/torch_spectral_solver.py --steps 200
    PYTHONPATH=src python examples/torch_spectral_solver.py --device cpu --n 16 --steps 20
    PYTHONPATH=src python -m torch.distributed.run --standalone --nproc-per-node 4 -- \\
        examples/torch_spectral_solver.py --mesh 2x2 --device cpu --n 16
"""
import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), '..', 'src'))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

import repro_torch.fft as fft  # noqa: E402
from repro_torch.launch.mesh import make_fft_mesh  # noqa: E402

#: the reference example's limit on each loop's relative error
TOL = 1e-3


def spectral_factor(kx, ky, kz, c, nu, dt):
    """exp((nu*lap + i*adv)*dt) on the wavenumbers given (broadcasting
    float64 tensors), as complex64."""
    lap = -(kx ** 2 + ky ** 2 + kz ** 2)
    adv = -(c[0] * kx + c[1] * ky + c[2] * kz)
    g = torch.exp(nu * lap * dt)
    return torch.complex(g * torch.cos(adv * dt), g * torch.sin(adv * dt)).to(torch.complex64)


def _axes(vectors, slices):
    """The 1-D ``vectors`` cut to a block's ``slices`` and shaped to
    broadcast as the three axes of the block."""
    return [v[s].reshape([-1 if i == a else 1 for i in range(3)])
            for a, (v, s) in enumerate(zip(vectors, slices))]


def _sync(device):
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def run_loop(step, u0, steps, device):
    """Integrate ``steps`` steps of ``step`` from ``u0``; the final field
    and the wall microseconds a step (after one step to warm up)."""
    step(u0)
    _sync(device)
    t0 = time.perf_counter()
    u = u0
    for _ in range(steps):
        u = step(u)
    _sync(device)
    return u, (time.perf_counter() - t0) / steps * 1e6


def _rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| / max |want| over every rank (float64)."""
    t = torch.stack([(got.double() - want).abs().max(), want.abs().max()])
    if dist.is_initialized():
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
    t = t.cpu()
    return float(t[0]) / max(float(t[1]), 1e-9)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--n', type=int, default=32)
    ap.add_argument('--steps', type=int, default=200)
    ap.add_argument('--nu', type=float, default=0.02)
    ap.add_argument('--mesh', default='1x1')
    ap.add_argument('--device', choices=('cuda', 'cpu'), default='cuda')
    args = ap.parse_args()
    rows, cols = (int(t) for t in args.mesh.split('x'))
    if rows * cols > 1:
        if 'LOCAL_RANK' not in os.environ:
            raise SystemExit(f'--mesh {args.mesh}: run under python -m torch.distributed.run '
                             f'--standalone --nproc-per-node {rows * cols}')
        if args.device == 'cuda':
            torch.cuda.set_device(int(os.environ['LOCAL_RANK']))
        dist.init_process_group('nccl' if args.device == 'cuda' else 'gloo')
    mesh = make_fft_mesh(rows, cols, device=args.device)
    dev, pos = mesh.device, mesh.position
    n, steps, nu = args.n, args.steps, args.nu
    c = (1.0, -0.5, 0.25)                     # advection velocity
    dt = 0.01

    # the real-input plan, its half spectrum kept in the forward's layout
    # (padded) across the forward -> update -> inverse loop
    rp = fft.rplan((n, n, n), mesh, padded_spectrum=True)
    pc = fft.plan((n, n, n), mesh)            # complex baseline

    # integer wavenumbers of the 2*pi-periodic domain; the real plan sees
    # the non-negative kz half axis and its zeroed pad bins
    def vec(a):
        return torch.from_numpy(a).to(dev)
    k = vec(np.fft.fftfreq(n, d=1.0 / n))
    kh = vec(np.fft.rfftfreq(n, d=1.0 / n))
    nh_pad = rp.spectrum_shape[-1]
    khp = torch.cat([kh, kh.new_zeros(nh_pad - kh.numel())])
    sl = mesh.block_slices((n, n, nh_pad), rp.out_layout, pos)
    gh = spectral_factor(*_axes((k, k, khp), sl), c, nu, dt)
    gh[..., max(0, kh.numel() - sl[2].start):] = 0.0      # pad bins carry nothing
    gf = spectral_factor(*_axes((k, k, k), mesh.block_slices((n,) * 3, pc.out_layout, pos)),
                         c, nu, dt)

    # the fused operator plan: the Green's function, known in closed form,
    # goes in as an rfftn-order 'spectrum', baked once into the native
    # layout and reused every step
    g_op = spectral_factor(k[:, None, None], k[None, :, None], kh[None, None, :], c, nu, dt)
    op = fft.plan_op((n, n, n), mesh, op=fft.spectral_mul, op_name='greens', real=True,
                     spectra=(g_op,), spectra_form='spectrum')
    del g_op

    # initial condition: a few Fourier modes (a known solution), this
    # rank's block
    x1 = vec(np.arange(n) * (2 * np.pi / n))
    X, Y, Z = _axes((x1, x1, x1), mesh.block_slices((n,) * 3, rp.in_layout, pos))
    u0 = torch.sin(X + 2 * Y) * torch.cos(Z) + 0.5 * torch.cos(3 * X - Y + 2 * Z)
    u0_real = u0.to(torch.float32)
    del u0
    uo, us_op = run_loop(op.apply, u0_real, steps, dev)
    ur, us_real = run_loop(lambda u: rp.inverse(rp.forward(u) * gh), u0_real, steps, dev)
    uc, us_cplx = run_loop(lambda u: pc.inverse(pc.forward(u) * gf),
                           u0_real.to(torch.complex64), steps, dev)

    # closed form: each mode decays by exp(nu*lap*T) and advects
    T = steps * dt

    def decay(kv):
        return np.exp(-nu * (kv[0]**2 + kv[1]**2 + kv[2]**2) * T)
    # sin(x+2y)cos(z) = 1/2[sin(x+2y+z) + sin(x+2y-z)]
    w = 0.5 * decay((1, 2, 1)) * torch.sin(
        (X - c[0]*T) + 2*(Y - c[1]*T) + (Z - c[2]*T))
    w = w + 0.5 * decay((1, 2, -1)) * torch.sin(
        (X - c[0]*T) + 2*(Y - c[1]*T) - (Z - c[2]*T))
    w = w + 0.5 * decay((3, -1, 2)) * torch.cos(
        3*(X - c[0]*T) - (Y - c[1]*T) + 2*(Z - c[2]*T))

    err = _rel_err(ur, w)
    err_c = _rel_err(uc.real, w)
    err_o = _rel_err(uo, w)
    if pos == 0:
        print(f'spectral solver: n={n}^3, {steps} steps on {args.mesh} mesh ({args.device})')
        print(f'  operator plan    : {us_op:8.1f} us/step   '
              f'rel err {err_o:.2e}   (baked x{op.bake_count})')
        print(f'  real (rfft) plan : {us_real:8.1f} us/step   rel err {err:.2e}')
        print(f'  complex plan     : {us_cplx:8.1f} us/step   rel err {err_c:.2e}')
        print(f'  rfft speedup     : {us_cplx / us_real:.2f}x   '
              f'fused speedup: {us_real / us_op:.2f}x')
    assert err < TOL, err
    assert err_c < TOL, err_c
    assert err_o < TOL, err_o
    assert op.bake_count == 1, op.bake_count
    if pos == 0:
        print('spectral_solver OK')
    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == '__main__':
    main()
