"""The port on the card: each CUDA kernel against its plain version, a
small plan end to end, the LM server against the CPU, the FFT-conv
mixer's adjoint against the plain tier, and a train step against the
CPU. Every test
here is marked ``cuda`` and skips without an NVIDIA GPU (the kernels
have no CPU mode). This file imports
no jax, so it runs on the GPU machine as it is:

    python -m pytest -m cuda tests/test_torch_cuda.py

Tolerances: max |kernel - plain| <= 1e-5 * max |plain|, as in
``chip_smoke.py`` (fp32 sums in another order); a plan against
torch.fft.fftn or rfftn and its round trip, relative L2 <= 1e-5.
"""
import pytest
import torch

import repro_torch.fft as fft
from repro_torch import kernels
from repro_torch.kernels import fft_block, fft_fused, fft_matmul, fft_pencil
from repro_torch.launch.mesh import make_fft_mesh

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.Generator(device='cuda').manual_seed(0)


def _planar(shape, gen):
    return (torch.randn(shape, generator=gen, device='cuda'),
            torch.randn(shape, generator=gen, device='cuda'))


def _rel(got, want):
    return (max(float((g - w).abs().max()) for g, w in zip(got, want))
            / max(float(w.abs().max()) for w in want))


@pytest.mark.parametrize("n", [2, 16, 256, 512, 4096])
def test_kernels_match_plain_versions(gen, n):
    """Ragged batches (37 and 29 are not multiples of a block's
    pencils), a leading dim and a broadcast twiddle."""
    x, z, w = _planar((37, n), gen), _planar((3, 29, n), gen), _planar((29, n), gen)
    for inverse in (False, True):
        assert _rel(fft_pencil.fft_pencil(*x, inverse=inverse),
                    fft_pencil.fft_pencil_plain(*x, inverse=inverse)) <= 1e-5
        assert _rel(fft_matmul.fft_matmul(*x, inverse=inverse),
                    fft_matmul.fft_matmul_plain(*x, inverse=inverse)) <= 1e-5
        assert _rel(fft_fused.fft_twiddle_transpose(*z, *w, inverse=inverse),
                    fft_fused.fft_twiddle_transpose_plain(*z, *w, inverse=inverse)) <= 1e-5


@pytest.mark.parametrize("method, counts", [
    ('four_step', {'fft_pencil': 0, 'fft_fused': 0, 'fft_matmul': 6, 'fft_block': 0}),
    ('stockham', {'fft_pencil': 2, 'fft_fused': 4, 'fft_matmul': 0, 'fft_block': 0}),
    ('block', {'fft_pencil': 0, 'fft_fused': 0, 'fft_matmul': 0, 'fft_block': 6}),
])
def test_plan_on_the_card(gen, method, counts):
    n = 64
    p = fft.plan((n, n, n), make_fft_mesh(1, 1), method=method)
    x = torch.complex(*_planar((2, n, n, n), gen))
    kernels.reset_launch_counts()
    y = p.forward(x)
    x2 = p.inverse(y)
    assert kernels.launch_counts() == counts
    assert fft_block.launches_mma == counts['fft_block']    # n = 64: the tensor-core body
    assert fft_matmul.launches_mma == counts['fft_matmul']  # n = 64: the tensor-core body
    assert fft_pencil.launches_radix8 == counts['fft_pencil']  # every n: the radix-8 body
    assert fft_fused.launches_radix8 == counts['fft_fused']
    ref = torch.fft.fftn(x, dim=(1, 2, 3))
    assert float(torch.linalg.vector_norm(y - ref) / torch.linalg.vector_norm(ref)) <= 1e-5
    assert float(torch.linalg.vector_norm(x2 - x) / torch.linalg.vector_norm(x)) <= 1e-5


@pytest.mark.parametrize("n", [2, 16, 512, 4096])
def test_radix2_body_matches_plain_version(gen, n):
    """The radix-2 Stockham body, which the radix-8 one is timed against,
    on a ragged batch and ragged rows with a twiddle."""
    x, z, w = _planar((37, n), gen), _planar((3, 29, n), gen), _planar((3, 29, n), gen)
    y = tuple(torch.empty_like(p) for p in x)
    yz = tuple(torch.empty((3, n, 29), device='cuda') for _ in range(2))
    kernels.reset_launch_counts()
    for inverse in (False, True):
        fft_pencil._launch(*x, *y, n, inverse, _body='radix2')
        assert _rel(y, fft_pencil.fft_pencil_plain(*x, inverse=inverse)) <= 1e-5
        fft_fused._launch(*z, *w, *yz, inverse, _body='radix2')
        assert _rel(yz, fft_fused.fft_twiddle_transpose_plain(*z, *w, inverse=inverse)) <= 1e-5
    assert (fft_pencil.launches, fft_pencil.launches_radix8) == (2, 0)
    assert (fft_fused.launches, fft_fused.launches_radix8) == (2, 0)


@pytest.mark.parametrize("n", [8192, 16384, 32768, 65536])
def test_long_body_matches_plain_versions(gen, n):
    """The long body that all four kernels run for 4096 < n <= 65536 (one
    block a pencil, then clusters of 2 and 4), on 3 pencils and on
    (3, 5, n) rows with one twiddle plane for all slices
    and one a slice; every launch on it."""
    x, z = _planar((3, n), gen), _planar((3, 5, n), gen)
    planes = (_planar((5, n), gen), _planar((3, 5, n), gen))
    kernels.reset_launch_counts()
    for inverse in (False, True):
        assert _rel(fft_pencil.fft_pencil(*x, inverse=inverse),
                    fft_pencil.fft_pencil_plain(*x, inverse=inverse)) <= 1e-5
        assert _rel(fft_matmul.fft_matmul(*x, inverse=inverse),
                    fft_matmul.fft_matmul_plain(*x, inverse=inverse)) <= 1e-5
        xs = torch.stack(x)
        assert _rel(fft_block.fft_block(xs, inverse=inverse),
                    fft_block.fft_block_plain(xs, inverse=inverse)) <= 1e-5
        for w in planes:
            assert _rel(fft_fused.fft_twiddle_transpose(*z, *w, inverse=inverse),
                        fft_fused.fft_twiddle_transpose_plain(*z, *w, inverse=inverse)) <= 1e-5
    for mod in (fft_pencil, fft_matmul, fft_block, fft_fused):
        assert mod.launches == mod.launches_long > 0


@pytest.mark.parametrize("n", [2, 16, 32, 64, 256, 512, 1024, 2048, 4096])
def test_fft_block_matches_plain_version(gen, n):
    """A ragged batch of 37 in both forms: stacked (2, 37, n) and the
    planar pair the method registry passes, on both sides of the
    tensor-core body's range (64 <= n <= 4096; three factors at 2048 and
    4096)."""
    assert fft_block.variant(n) == ('mma' if 64 <= n <= 4096 else 'fma')
    x = torch.stack(_planar((37, n), gen))
    for inverse in (False, True):
        want = fft_block.fft_block_plain(x, inverse=inverse)
        assert _rel(fft_block.fft_block(x, inverse=inverse), want) <= 1e-5
        assert _rel(fft_block.fft_block_planar(x[0], x[1], inverse=inverse), want) <= 1e-5


@pytest.mark.parametrize("n", [64, 512, 4096])
def test_fft_block_takes_planes_that_are_not_16_byte_aligned(gen, n):
    """Contiguous planes 4 bytes past an aligned address: the tensor-core
    body's tile loads take 4-byte copies in place of 16-byte ones."""
    flat = _planar((37 * n + 1,), gen)
    re, im = (t[1:].view(37, n) for t in flat)
    assert re.data_ptr() % 16 and fft_block.variant(n) == 'mma'
    want = fft_block.fft_block_plain(torch.stack([re, im]), inverse=True)
    assert _rel(fft_block.fft_block_planar(re, im, inverse=True), want) <= 1e-5


@pytest.mark.parametrize("n", [64, 128, 256, 512, 1024, 2048, 4096])
def test_fft_matmul_on_the_tensor_core_body_matches_plain_version(gen, n):
    """A ragged batch of 37 (not a multiple of the body's tile) and
    planes 4 bytes past an aligned address (the tile loads' 4-byte
    copies), forward and inverse; every launch on the tensor-core body."""
    assert fft_matmul.variant(n) == 'mma'
    x = _planar((37, n), gen)
    flat = _planar((37 * n + 1,), gen)
    off = tuple(t[1:].view(37, n) for t in flat)
    assert off[0].data_ptr() % 16 and off[1].data_ptr() % 16
    kernels.reset_launch_counts()
    for inverse in (False, True):
        for planes in (x, off):
            assert _rel(fft_matmul.fft_matmul(*planes, inverse=inverse),
                        fft_matmul.fft_matmul_plain(*planes, inverse=inverse)) <= 1e-5
    assert fft_matmul.launches == fft_matmul.launches_mma == 4


@pytest.mark.parametrize("method, counts", [
    ('auto', {'fft_pencil': 2, 'fft_fused': 0, 'fft_matmul': 4, 'fft_block': 0}),
    ('block', {'fft_pencil': 0, 'fft_fused': 0, 'fft_matmul': 0, 'fft_block': 6}),
])
def test_rplan_on_the_card(gen, method, counts):
    """At 64^3 'auto' takes Stockham for the length-32 half pencils and
    the four-step for the length-64 pencils; 'block' runs its length-64
    pencils on the tensor-core body and the half pencils of 32 on the
    CUDA-core one."""
    n = 64
    p = fft.rplan((n, n, n), make_fft_mesh(1, 1), method=method)
    x = torch.randn((2, n, n, n), generator=gen, device='cuda')
    kernels.reset_launch_counts()
    y = p.forward(x)
    x2 = p.inverse(y)
    assert kernels.launch_counts() == counts
    assert fft_block.launches_mma == (4 if method == 'block' else 0)
    assert fft_matmul.launches_mma == counts['fft_matmul']  # n = 64: the tensor-core body
    ref = torch.fft.rfftn(x, dim=(1, 2, 3))
    assert y.shape == ref.shape
    assert float(torch.linalg.vector_norm(y - ref) / torch.linalg.vector_norm(ref)) <= 1e-5
    assert float(torch.linalg.vector_norm(x2 - x) / torch.linalg.vector_norm(x)) <= 1e-5


@pytest.mark.parametrize("real", [False, True], ids=['complex', 'real'])
def test_rank1_stockham_plan_on_the_card(gen, real):
    """A rank-1 plan of n = 2^16 (256 x 256) with method='stockham': the
    complex four-step runs 2 ``fft_fused`` launches a direction, the
    column superstep's with the twiddle planes; the real one runs r2c
    columns and rows on ``fft_pencil``. Forward against torch.fft.fft /
    rfft of each signal and the round trip, relative L2 <= 1e-5."""
    n = 1 << 16
    p = (fft.rplan if real else fft.plan)((n,), make_fft_mesh(1, 1), method='stockham')
    x = (torch.randn((3, n), generator=gen, device='cuda') if real
         else torch.complex(*_planar((3, n), gen)))
    kernels.reset_launch_counts()
    y = p.forward(x)
    fwd = (kernels.launch_counts(), fft_fused.launches_twiddle)
    x2 = p.inverse(y)
    if real:
        assert fwd[0] == {'fft_pencil': 2, 'fft_fused': 0, 'fft_matmul': 0, 'fft_block': 0}
        assert kernels.launch_counts()['fft_pencil'] == 4
    else:
        assert fwd == ({'fft_pencil': 0, 'fft_fused': 2, 'fft_matmul': 0, 'fft_block': 0}, 1)
        assert (fft_fused.launches, fft_fused.launches_twiddle) == (4, 2)
        assert fft_fused.launches_radix8 == 4
    ref = torch.fft.rfft(x) if real else torch.fft.fft(x)
    assert y.shape == ref.shape
    assert float(torch.linalg.vector_norm(y - ref) / torch.linalg.vector_norm(ref)) <= 1e-5
    assert float(torch.linalg.vector_norm(x2 - x) / torch.linalg.vector_norm(x)) <= 1e-5


def _unfused(p, x, k):
    """forward -> spectral_mul -> inverse through the plain plan ``p``."""
    s, sk = p.forward(x), p.forward(k)
    return p.inverse(torch.complex(*fft.spectral_mul(s.real, s.imag, (sk.real, sk.imag))))


@pytest.mark.parametrize("case", ['solver', 'conv', 'fftconv1d', 'conv1d_stockham'])
def test_op_paths_on_the_card(gen, case):
    """The three operator paths of ``chip_smoke.py`` at 64^3 and 2^16
    (256 x 256): the spectral solver's step (real, a factor baked in the
    'spectrum' form), a complex operator with one runtime factor, and a
    rank-1 real operator with a baked kernel; and a rank-1 complex
    operator with method='stockham', whose inverse must run the fused
    kernel's twiddle as the natural-order inverse does. Each bitwise
    equal to its unfused composition on the card, within 1e-5 of the
    library's, the bake once in three applies, and at 64^3 its launches
    an apply: the real one 4 ``fft_matmul`` and, for its half pencils of
    32, 2 ``fft_pencil``; the complex one 9 ``fft_matmul``; every
    ``fft_matmul`` on the tensor-core body."""
    mesh = make_fft_mesh(1, 1)
    kw = {}
    if case == 'fftconv1d':
        shape, real, batch = (1 << 16,), True, (3,)
    elif case == 'conv1d_stockham':
        shape, real, batch, kw = (1 << 16,), False, (3,), dict(method='stockham')
    else:
        shape, real, batch = (64, 64, 64), case == 'solver', ()
    x = (torch.randn(batch + shape, generator=gen, device='cuda') if real
         else torch.complex(*_planar(batch + shape, gen)))
    k = (torch.randn(shape, generator=gen, device='cuda') if real
         else torch.complex(*_planar(shape, gen)))
    p = (fft.rplan if real else fft.plan)(shape, mesh, padded_spectrum=len(shape) > 1 and real,
                                          **kw)
    if case == 'solver':
        g = p.forward(k)      # any rfftn-order factor: here a transformed field
        op = fft.plan_op(shape, mesh, op=fft.spectral_mul, spectra=(g,),
                         spectra_form='spectrum')
        args = (x,)
        want_unfused = p.inverse(torch.complex(*fft.spectral_mul(
            p.forward(x).real, p.forward(x).imag, (g.real, g.imag))))
        want = torch.fft.irfftn(torch.fft.rfftn(x) * torch.fft.rfftn(k), s=shape)
    elif not real:
        op = fft.plan_op(shape, mesh, op=fft.spectral_mul, real=False, n_spectra=1, **kw)
        args = (x, k)
        want_unfused = _unfused(p, x, k)
        dims = tuple(range(-len(shape), 0))
        want = torch.fft.ifftn(torch.fft.fftn(x, dim=dims) * torch.fft.fftn(k, dim=dims),
                               dim=dims)
    else:
        op = fft.plan_op(shape, mesh, op=fft.spectral_mul, spectra=(k,))
        args = (x,)
        want_unfused = _unfused(p, x, k)
        want = torch.fft.irfft(torch.fft.rfft(x) * torch.fft.rfft(k), n=shape[0])
    op.apply(*args)
    kernels.reset_launch_counts()
    for _ in range(2):
        y = op.apply(*args)
    assert op.bake_count == 1
    if len(shape) == 3:
        per_apply = ({'fft_pencil': 2, 'fft_fused': 0, 'fft_matmul': 4, 'fft_block': 0} if real
                     else {'fft_pencil': 0, 'fft_fused': 0, 'fft_matmul': 9, 'fft_block': 0})
        assert kernels.launch_counts() == {k: 2 * v for k, v in per_apply.items()}
        assert fft_matmul.launches_mma == 2 * per_apply['fft_matmul']
    assert torch.equal(y, want_unfused)
    assert float(torch.linalg.vector_norm(y - want) / torch.linalg.vector_norm(want)) <= 1e-5


@pytest.mark.parametrize("name", ['fft_matmul', 'fft_pencil', 'fft_twiddle_transpose',
                                  'fft_block'])
def test_kernels_refuse_gradients(gen, name):
    """A CUDA kernel asked for a gradient raises, as the reference's
    ``pallas_call`` (no backward) does, and launches nothing; without
    grad the same call runs; the plain versions differentiate."""
    x, y = _planar((4, 64), gen)
    call = {'fft_matmul': fft_matmul.fft_matmul, 'fft_pencil': fft_pencil.fft_pencil,
            'fft_twiddle_transpose': fft_fused.fft_twiddle_transpose,
            'fft_block': fft_block.fft_block_planar}[name]
    kernels.reset_launch_counts()
    with pytest.raises(RuntimeError, match="no backward.*kernel='reference'"):
        call(x.requires_grad_(), y)
    assert not any(kernels.launch_counts().values())
    with torch.no_grad():
        call(x, y)
    mesh = make_fft_mesh(1, 1)
    xc = torch.complex(*_planar((16, 16, 16), gen)).requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        fft.plan((16, 16, 16), mesh).forward(xc)
    g, = torch.autograd.grad(
        (fft.plan((16, 16, 16), mesh, kernel='reference').forward(xc).abs() ** 2).sum(), xc)
    assert float(torch.linalg.vector_norm(g - 2 * 4096 * xc.detach())
                 / torch.linalg.vector_norm(g)) <= 1e-5


def test_engine_serves_on_the_card(gen):
    """The serving engine on the card: a coalesced group of 4 complex
    64^3 requests, bitwise equal to per-request forwards, all on the
    tensor-core body; the drainer serves from its own thread (at the
    watermark, the group's width)."""
    from repro_torch.serve import FFTEngine
    mesh = make_fft_mesh(1, 1)
    xs = [torch.complex(*_planar((64, 64, 64), gen)) for _ in range(4)]
    with FFTEngine((64, 64, 64), mesh, max_coalesce=4, background=True,
                   schedule_table=None) as eng:
        eng.set_schedule(4, 1)
        kernels.reset_launch_counts()
        ys = [t.result(timeout=120) for t in [eng.submit(x) for x in xs]]
        assert kernels.launch_counts()['fft_matmul'] == fft_matmul.launches_mma == 3
        p = eng.plan_for(False)
        assert all(torch.equal(y, p.forward(x)) for x, y in zip(xs, ys))


@pytest.mark.parametrize("tcp", [False, True], ids=['unix', 'tcp'])
def test_service_round_trip_on_the_card(gen, tmp_path, tcp):
    """The multi-tenant service on the card: numpy requests in over a
    socket (complex 128^3, real 128^3 and its spectrum back in planar
    form; the real path's half-length pencils of 64 are the tensor-core
    body's shortest), each result the host copy of the card's, bitwise
    equal to the engine's plan one call at a time, every launch on the
    tensor-core body; a keyed resubmit is re-delivered from the host,
    no dispatch."""
    import numpy as np
    from repro_torch.serve import FFTClient, FFTService
    from repro_torch.weights import from_numpy
    mesh = make_fft_mesh(1, 1)
    shape = (128, 128, 128)
    xc = torch.complex(*_planar(shape, gen)).cpu().numpy()
    xr = _planar(shape, gen)[0].cpu().numpy()
    addr = ('127.0.0.1', 0) if tcp else str(tmp_path / 's.sock')
    with FFTService(mesh, schedule_table=None, max_coalesce=4).start(addr) as svc:
        with FFTClient(svc.address, tenant='card') as c:
            kernels.reset_launch_counts()
            yc, yr = c.transform([xc, xr])
            yi = c.transform([(yr.real.copy(), yr.imag.copy())], direction='inv', real=True)[0]
            groups = svc.engine.dispatch_stats()['groups']
            assert kernels.launch_counts()['fft_matmul'] == fft_matmul.launches_mma == 3 * groups
            pc, pr = (svc.engine.plan_for(r, shape=shape) for r in (False, True))
            assert np.array_equal(yc, pc.forward(from_numpy(xc)).cpu().numpy())
            assert np.array_equal(yr, pr.forward(from_numpy(xr)).cpu().numpy())
            planes = tuple(from_numpy(a) for a in (yr.real.copy(), yr.imag.copy()))
            assert np.array_equal(yi, pr.inverse(planes).cpu().numpy())
            assert np.abs(yi - xr).max() <= 1e-4
            again = c.submit(xc, key='k').result(timeout=120)
            assert np.array_equal(c.submit(xc, key='k').result(timeout=120), again)
            assert svc.engine.dispatch_stats()['groups'] == groups + 1
            assert c.metrics()['service']['dedup']['redelivered'] == 1


@pytest.mark.parametrize("arch", ['internlm2-1.8b', 'mamba2-1.3b'])
def test_lm_server_on_the_card_matches_the_cpu(gen, arch):
    """The LM server (smoke config, fp32) on the card against the same
    parameters on the CPU: prefill and four teacher-forced decode steps,
    logits within 1e-5 relative L2 (full fp32 products on the card, no
    TF32), and greedy tokens equal wherever the CPU's top-2 margin
    exceeds 1e-3. The LM path launches no hand-written kernel."""
    from repro_torch.configs import get_config, make_batch, smoke_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model as M
    from repro_torch.models.layers import tree_map
    from repro_torch.serve import ServeEngine
    cfg = smoke_config(get_config(arch))
    params = M.init_params(torch.Generator().manual_seed(0), cfg, torch.float32)
    on_card = tree_map(lambda t: t.cuda(), params)
    prompt = make_batch(cfg, batch=2, seq=20, seed=1, device='cpu')['tokens']
    kernels.reset_launch_counts()
    out = {}
    for dev, p in (('cpu', params), ('cuda', on_card)):
        eng = ServeEngine(cfg, make_host_mesh(1, 1, device=dev), p, batch=2, prompt_len=16,
                          max_len=20)
        logits, caches = eng.prefill({'tokens': prompt[:, :16]})
        steps = [logits]
        for t in range(4):
            logits, caches = eng.decode(caches, prompt[:, 16 + t:17 + t].to(dev), 16 + t)
            steps.append(logits)
        toks = eng.generate({'tokens': prompt[:, :16]}, 5)
        out[dev] = torch.cat(steps, dim=1).cpu(), toks.cpu()
    assert not any(kernels.launch_counts().values())
    assert not torch.backends.cuda.matmul.allow_tf32
    assert torch.get_float32_matmul_precision() == 'highest'
    (cpu, tok_cpu), (card, tok_card) = out['cpu'], out['cuda']
    assert float(torch.linalg.vector_norm(card - cpu) / torch.linalg.vector_norm(cpu)) <= 1e-5
    assert tok_card.dtype == torch.int32
    # the first token's margin is read from the prefill; later ones follow
    # the CPU's own tokens, so compare only up to the first narrow margin
    top2 = torch.topk(cpu[:, 0], 2, dim=-1).values
    wide = (top2[:, 0] - top2[:, 1]) > 1e-3
    assert torch.equal(tok_card[wide, 0], tok_cpu[wide, 0])


@pytest.mark.parametrize("n", [512, 4096])
def test_fftconv_adjoint_on_the_card(gen, n):
    """``_FFTConv`` on the runtime plans of a 1 x 1 card mesh: the forward
    and the backward's two correlation applies launch the kernels (3
    applies, each 3 launches of the four-step and Stockham kernels
    between them), and its gradients of hr and kr are within 1e-5
    relative L2 of autograd through the plain tier (``kernel='reference'``)
    on the same inputs; the forward within 1e-5 of torch.fft."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import ssd
    mesh = make_host_mesh(1, 1)
    hr = torch.randn((2, 8, n), generator=gen, device='cuda')
    kr = torch.randn((8, n), generator=gen, device='cuda')
    w = torch.randn(hr.shape, generator=gen, device='cuda')
    axes = ssd._pick_axes(mesh, n)
    conv = ssd._fftconv_runtime_plan(n, mesh, axes, False)
    adj = ssd._fftconv_runtime_plan(n, mesh, axes, True)
    th, tk = hr.clone().requires_grad_(), kr.clone().requires_grad_()
    kernels.reset_launch_counts()
    y = ssd._FFTConv.apply(th, tk, conv.apply, adj.apply)
    gh, gk = torch.autograd.grad((y * w).sum(), (th, tk))
    assert sum(kernels.launch_counts().values()) == 3 * 6
    plain = fft.plan_op((n,), mesh, op=fft.spectral_mul, real=True, n_spectra=1,
                        mesh_axes=axes, kernel='reference')
    ph, pk = hr.clone().requires_grad_(), kr.clone().requires_grad_()
    yp = plain.apply(ph, pk)
    ah, ak = torch.autograd.grad((yp * w).sum(), (ph, pk))

    def rel(a, b):
        return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))
    assert rel(gh, ah) <= 1e-5 and rel(gk, ak) <= 1e-5
    lib = torch.fft.irfft(torch.fft.rfft(hr) * torch.fft.rfft(kr), n=n)
    assert rel(y.detach(), lib) <= 1e-5


@pytest.mark.parametrize("arch", ['internlm2-1.8b', 'fftconv'])
def test_train_step_on_the_card_matches_the_cpu(gen, arch):
    """One ``make_train_step`` step at smoke size on the card and on the
    CPU from the same parameters and batch: ce, the grad norm and the
    updated parameters within 1e-5 relative (L2 for the parameters);
    the fftconv model's step launches the kernels."""
    import dataclasses
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.data import SyntheticLM, shard_batch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model as M
    from repro_torch.models.layers import tree_leaves, tree_map
    from repro_torch.train.optim import adamw_init
    from repro_torch.train.trainstep import make_train_step
    cfg = smoke_config(get_config('mamba2-1.3b' if arch == 'fftconv' else arch))
    if arch == 'fftconv':
        cfg = dataclasses.replace(cfg, block_pattern=('fftconv',))
    params = M.init_params(torch.Generator().manual_seed(0), cfg, torch.float32)
    batch = SyntheticLM(cfg.vocab_size, 128, 2, seed=0).batch_at(0)
    res = {}
    for dev in ('cpu', 'cuda'):
        mesh = make_host_mesh(1, 1, device=dev)
        p = tree_map(lambda t: t.to(dev, copy=True), params)
        step = make_train_step(cfg, mesh, peak_lr=1e-3, warmup_steps=5, total_steps=100,
                               param_dtype=torch.float32)
        kernels.reset_launch_counts()
        p, _, m = step(p, adamw_init(p), shard_batch(batch, mesh))
        res[dev] = p, {k: float(v) for k, v in m.items()}, kernels.launch_counts()
    (pc, mc, _), (pg, mg, lg) = res['cpu'], res['cuda']
    assert bool(sum(lg.values())) == (arch == 'fftconv')
    for k in ('ce', 'grad_norm'):
        assert abs(mg[k] - mc[k]) <= 1e-5 * abs(mc[k])
    for a, b in zip(tree_leaves(pg), tree_leaves(pc)):
        assert float(torch.linalg.vector_norm(a.cpu() - b) / torch.linalg.vector_norm(b)) <= 1e-5
