"""Quickstart: the distributed 3-D FFT of ``repro_torch.fft`` on the card.

The counterpart of ``examples/quickstart.py``. The paper's mapping
(§4.2): the input A[x, y, z] with (x, y) on the mesh and z in memory;
three supersteps of local pencil FFTs separated by two all-to-all
exchanges, checked against ``numpy.fft`` on the host, the paper's own
method (§4.1). Everything goes through the facade: plan once, run many
times, complex tensors in and out.

On one card the mesh is 1 x 1 and the exchanges are local; ``--mesh
RxC`` runs one process a rank under ``torch.distributed.run`` (NCCL on
cards, gloo with ``--device cpu``). Every rank makes the same global
operand from the seed, transforms its block and checks it against its
block of the numpy transform; the errors are the largest over the ranks,
and rank 0 prints (``--`` before the script keeps an older launcher
from reading ``--n`` as an abbreviation of its own options).

    PYTHONPATH=src python examples/torch_quickstart.py                 # one card, n = 32
    PYTHONPATH=src python examples/torch_quickstart.py --n 512 --n1d 16777216
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu --n 16 --n1d 1024
    PYTHONPATH=src python -m torch.distributed.run --standalone --nproc-per-node 4 -- \\
        examples/torch_quickstart.py --mesh 2x2 --device cpu
"""
import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), '..', 'src'))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

import repro_torch.fft as fft  # noqa: E402
from repro_torch.launch.mesh import make_fft_mesh  # noqa: E402

#: the reference example's limit on each relative error
TOL = 1e-4


def _max_over_ranks(*values):
    """Each value's largest over the mesh's ranks (itself on one rank)."""
    t = torch.tensor(values, dtype=torch.float64)
    if dist.is_initialized():
        dev = 'cuda' if dist.get_backend() == 'nccl' else 'cpu'
        t = t.to(dev)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return [float(v) for v in t.cpu()]


def _gap(got: torch.Tensor, want: np.ndarray, rel: bool = True) -> float:
    """max |got - want| over every rank, divided by max |want| over every
    rank when ``rel``."""
    g = got.detach().cpu().numpy().astype(np.complex128)
    err, scale = _max_over_ranks(float(np.max(np.abs(g - want))),
                                 float(np.max(np.abs(want))))
    return err / scale if rel else err


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--n', type=int, default=32)
    ap.add_argument('--n1d', type=int, default=4096)
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
    say = print if mesh.position == 0 else (lambda *a, **k: None)
    n = args.n
    where = f'{args.mesh} mesh ({args.device})'

    # one signature for ranks 1/2/3; the plan owns layouts and functions
    p = fft.plan((n, n, n), mesh, method='auto')
    rng = np.random.default_rng(0)
    x = rng.standard_normal((n, n, n)) + 1j * rng.standard_normal((n, n, n))
    xd = mesh.shard(torch.from_numpy(x.astype(np.complex64)).to(mesh.device), p.in_layout)

    # forward: ownership rotates ('x', 'y', None) -> ('y', None, 'x')
    y = p.forward(xd)
    want = np.fft.fftn(x)
    err = _gap(y, want[mesh.block_slices(want.shape, p.out_layout, mesh.position)])
    del want
    say(f'3D FFT {n}^3 on {where}: rel err vs numpy.fft = {err:.2e}')
    assert err < TOL, err

    # inverse: the round trip, the paper's fwd+inv loop (§5)
    back = p.inverse(y)
    err2 = _gap(back, x[mesh.block_slices(x.shape, p.in_layout, mesh.position)], rel=False)
    say(f'IFFT(FFT(x)) round trip: max abs err = {err2:.2e}')
    assert err2 < TOL, err2
    del x, xd, y, back

    # the same facade plans a large 1-D transform across the whole mesh
    n1d = args.n1d
    p1 = fft.plan((n1d,), mesh)
    x1 = rng.standard_normal(n1d) + 1j * rng.standard_normal(n1d)
    y1 = p1.forward(mesh.shard(torch.from_numpy(x1.astype(np.complex64)).to(mesh.device),
                               p1.in_layout))
    w1 = np.fft.fft(x1)
    err3 = _gap(y1, w1[mesh.block_slices(w1.shape, p1.out_layout, mesh.position)])
    say(f'1D FFT n={n1d} over {mesh.size} rank(s): rel err vs numpy.fft = {err3:.2e}')
    assert err3 < TOL, err3

    # every plan prices its schedule with the paper's cycle model; the
    # comm='auto' default also uses it to pick the exchange and the
    # overlap depth (repro_torch.comm.cost)
    say()
    say(p.cost_report())
    say('quickstart OK')
    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == '__main__':
    main()
