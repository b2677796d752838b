"""The port's FFT examples run on the CPU: ``examples/torch_quickstart.py``
on one rank and on a gloo 2 x 2 mesh under ``torch.distributed.run``,
and ``examples/torch_spectral_solver.py`` on one rank. Each checks its
own results (the quickstart against ``numpy.fft`` at 1e-4, the solver's
three loops against the closed-form solution at 1e-3 with the factor
baked once) and prints its OK line, which must be there."""
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, PYTHONPATH=os.path.join(ROOT, 'src'))


def _run(args, timeout=240):
    proc = subprocess.run([sys.executable, *args], capture_output=True, text=True, env=ENV,
                          cwd=ROOT, timeout=timeout)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return proc.stdout


def test_quickstart_on_one_rank():
    out = _run(['examples/torch_quickstart.py', '--device', 'cpu', '--n', '16',
                '--n1d', '1024'])
    assert 'quickstart OK' in out and 'rel err vs numpy.fft' in out
    assert 'cost_report shape=(16, 16, 16)' in out


def test_quickstart_on_a_mesh():
    out = _run(['-m', 'torch.distributed.run', '--standalone', '--nproc-per-node', '4', '--',
                'examples/torch_quickstart.py', '--mesh', '2x2', '--device', 'cpu',
                '--n', '16', '--n1d', '1024'])
    assert 'quickstart OK' in out and 'on 2x2 mesh (cpu)' in out
    assert out.count('quickstart OK') == 1          # rank 0 prints


def test_spectral_solver_on_one_rank():
    out = _run(['examples/torch_spectral_solver.py', '--device', 'cpu', '--n', '16',
                '--steps', '20'])
    assert 'spectral_solver OK' in out and '(baked x1)' in out
