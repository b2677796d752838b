"""``repro_torch`` — the PyTorch/CUDA port of the wsFFT reproduction.

The JAX package ``repro`` is the reference; this package mirrors its
module layout (``core``, ``comm``, ``fft``, ``kernels``, ``launch``,
``serve``, ``configs``, ``models``, ``train``, ``data``, ``checkpoint``,
``runtime``) so each counterpart is found under the same name. It imports ``torch``
only, never ``jax`` or ``repro``.

    import repro_torch.fft as fft
    from repro_torch.launch.mesh import make_fft_mesh

    p = fft.plan((n, n, n), make_fft_mesh(1, 1))   # one card
    y = p.forward(x)                               # complex64 on cuda
    x2 = p.inverse(y)

Entry points run on ``cuda`` unless the caller passes ``device='cpu'``
to :func:`repro_torch.launch.mesh.make_fft_mesh`. On a CUDA tensor the
pencils run the hand-written kernels under ``kernels/`` (built from
``csrc/*.cu`` at first use); on a CPU tensor they run the plain PyTorch
versions.
"""
