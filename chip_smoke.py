"""Drive the PyTorch/CUDA port on one GPU and check every kernel on its path.

Run from the root of a checkout, on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases, each printing one line and raising on any failure:

1. card: name and power limit (``nvidia-smi``), torch and CUDA versions;
   then the kernels are built from ``src/repro_torch/csrc`` (one ``nvcc``
   per source, in parallel), each kernel's registers and spills printed
   (a spill in a tensor-core or radix-8 kernel fails the run), each
   radix-8 kernel with its block at the main path's shapes (pencils,
   threads, shared bytes, which the library must agree with);
2. each kernel against its plain PyTorch version on the card, at the main
   path's shapes (512^3 as 262,144 pencils of 512; ``fft_matmul`` and
   ``fft_block`` also at the real path's 262,144 half pencils of 256),
   plus ragged batches of every length 2..4096, the fused kernel with
   a random twiddle, both tensor-core kernels on planes one float
   past a 16-byte boundary (at 512 and 4096), and the rank-1 paths'
   shapes (``fft_matmul`` and ``fft_block`` on 32,768 pencils of 4096
   and of 2048 and on 16,392 of 4096, ``fft_twiddle_transpose`` on
   (8, 4096, 4096) with twiddle planes of (4096, 4096) and without);
   with its median time, the plain version's,
   one PyTorch library call's (``torch.fft.fft``, a yardstick the port
   never calls) and its bound. ``fft_pencil`` and
   ``fft_twiddle_transpose`` also print the body their launches run
   (``variant``: 'radix8', the register-resident body, for
   2 <= n <= 4096), its block, and the radix-2 body's time on the same
   input (``radix2_ms``). ``fft_matmul`` and ``fft_block`` print theirs
   (``variant``: 'mma', the shared tensor-core body of
   ``csrc/four_step_mma.cuh``, for 64 <= n <= 4096, else 'fma'), the
   split it runs (``factors``: two at n <= 1024, 16x16xn3 at 2048 and
   4096), its shared bytes and blocks an SM (``fft_matmul`` its
   registers too), and the CUDA-core body's time on the same input
   (``fma_ms``);
3. the main path with the default plan, ``plan((512,)*3, make_fft_mesh(1, 1))``
   (resolves to four_step / all_to_all): forward against ``torch.fft.fftn``,
   the round trip, and 3 ``fft_matmul`` launches per direction, all of
   them on the tensor-core body;
4. the same with ``method='stockham'``: 2 ``fft_twiddle_transpose`` and 1
   ``fft_pencil`` launches per direction, all of them on the radix-8 body;
5. the same with ``method='block'``: 3 ``fft_block`` launches per direction,
   all of them on the tensor-core body;
6. the real plan ``rplan((512,)*3, make_fft_mesh(1, 1))`` (resolves to
   four_step, spectrum (512, 512, 257)): forward against
   ``torch.fft.rfftn``, the round trip, 3 ``fft_matmul`` launches per
   direction; then the same with ``method='block'``, 3 ``fft_block``;
   every launch of both on the tensor-core body;
7. ``[cost]``, on the host: the cost model's report for the default plan
   of 512^3 on an abstract 512 x 512 mesh (the paper's configuration)
   and on a 2 x 2 one, and the selector's picks (strategy, overlap
   chunks, method) for 32^3 to 512^3 and for rank-1 lengths 2^12 and
   2^24 on 1 x 1, 2 x 2 and 1 x 4 meshes, complex and real, which must
   be the reference's, and every pick must plan (ppermute on 1 x 4,
   hierarchical for rank 1 on 2 x 2);
8. the pipelined paths, 8 overlap chunks a (fft, swap) pair:
   ``overlap`` (``plan(..., overlap_chunks=8)``, four_step: 17
   ``fft_matmul`` launches per direction, 8 + 8 chunked and the last
   superstep), ``stockham_overlap`` (17 ``fft_pencil``, no
   ``fft_fused``: a chunked pair runs its fft unfused) and
   ``real_overlap`` (``rplan``: 10 ``fft_matmul``, the r2c and c2r
   pairs chunked by split-combine, the middle pair serial because its
   257-bin axis does not divide by 8). ``overlap`` and ``real_overlap``
   must give the forward of their unchunked plan bit for bit (the same
   kernel on the same pencils); ``stockham_overlap`` runs
   ``radix8_pencil_kernel`` where its unchunked plan runs
   ``radix8_fused_kernel`` and is held within 1e-6 of it;
9. the rank-1 paths on a batch of 8 signals of n = 2^24 (the 1 GiB of
   the 512^3 paths), each a four-step of 4096 x 4096: ``large1d``
   (``plan((1 << 24,), mesh)``, four_step: 2 ``fft_matmul`` a direction,
   on the tensor-core three-factor body, n = 4096), ``large1d_stockham``
   (``method='stockham'``: 2 ``fft_fused`` a direction, the column
   superstep's with the twiddle planes, ``launches_twiddle``) and
   ``rlarge1d`` (``rplan((1 << 24,), mesh)``, four_step: 2
   ``fft_matmul`` a direction, the r2c columns at 2048 and the rows at
   4096, both on the three-factor body), each held against
   ``torch.fft.fft`` / ``rfft`` of each signal (the largest relative L2
   of the 8); then ``[long]``, the long body that all four kernels run
   for 4096 < n <= 65536 (``csrc/fft_long.cu``, built with the others):
   every C sizing function (shared bytes, threads, scratch) equal to
   its Python mirror (``kernels/smem.py``, ``kernels/_long.py``) for
   every power of two n from 2 to 65536, each body's block within the
   opt-in limit; each kernel at n = 8192, 16384, 32768 and 65536 on
   2^24 / n pencils against its plain version, forward and inverse
   (relative L2 and the largest gap within ``KERNEL_RTOL``), on 3
   pencils too, ``fft_twiddle_transpose`` also with (b, n) twiddle
   planes, one plane a slice and one for all slices, each with its
   time, the plain version's, the library's (``torch.fft.fft``, plus
   the transposing copy for the fused kernel), its bound and
   ``launch_info`` (split, blocks a pencil, threads, shared bytes,
   blocks an SM, clusters the card holds, registers, scratch bytes,
   device bytes an element; the fused kernel's with twiddle planes
   beside its time with them); then six paths at full
   size, every launch on the long body: ``fft2d_long``
   (``plan((8192, 32768))``, 'auto': 2 ``fft_matmul`` a direction),
   ``fft2d_long_stockham`` (1 ``fft_fused`` and 1 ``fft_pencil``),
   ``fft2d_long_block`` (2 ``fft_block``), ``large1d_long``
   (``plan((1 << 28,))``, 16384 x 16384, 'auto', which the selector
   resolves to stockham as the reference's does: 2 ``fft_fused``, the
   column superstep's with twiddle planes), ``large1d_long_stockham``
   (the same, ``method='stockham'``) and ``large1d_long_four_step`` (2
   ``fft_matmul``), each against ``torch.fft.fftn`` / ``fft`` and the
   round trip within ``PATH_RTOL``; and its seconds;
10. the operator plans through ``fft.plan_op`` (``[op]`` and
   ``[profile]`` lines): ``op_solver``, the spectral solver's step at
   512^3 (``real=True``, the integrating factor of
   ``examples/spectral_solver.py`` baked in the 'spectrum' form: 6
   ``fft_matmul`` an apply, the bake transforming nothing),
   ``op_conv`` (complex 512^3 with one runtime factor: 9 an apply, three
   for each forward chain and three for the inverse) and
   ``op_fftconv1d`` (the 8 signals of 2^24 against one baked real
   kernel: 4 an apply, the r2c columns at 2048 and rows at 4096 and
   their mirror, and 2 more once to bake the kernel), each against the
   library's composition (relative L2 <= 1e-5), bitwise against its
   unfused composition (forward, ``spectral_mul``, inverse), every
   launch on the tensor-core body and the bake once in three applies;
   with its apply time, the unfused and the library's; then
   ``compute_dtype=bfloat16``, refused on the kernel tier and run at
   64^3 on the reference tier (its error against ``torch.fft.fftn``
   printed, above 1e-4);
11. ``[serve]``: the serving engine (``FFTEngine``) at 512^3, a mixed
   stream with ``flush()`` and with the drainer, each kind beside its
   per-request calls, a Stockham engine, ``autotune``; every result
   bitwise equal to its per-request call;
12. ``[service]``: the multi-tenant service (``FFTService``) on a unix
   socket, two ``FFTClient`` threads, one a tenant: real 512^3
   forwards, their spectra back as planar inverses, ``op='solver'``
   steps and complex 256^3 forwards, each result bitwise equal to the
   engine's plan call alone, 3 ``fft_matmul`` a group (6 ``solver``);
   a complex 512^3 submit refused on the client (over the frame cap);
   the time a request at the client and through the engine in process,
   the host split of one request (pack, unpack, socket, H2D, D2H), the
   metrics, a drained close, and the launcher's ``--smoke``;
13. ``[grad]``: every kernel refuses an operand that requires grad;
14. ``[lm]``: the language-model server (``ServeEngine``) at full width
   in fp32, parameters drawn on the card by ``weights.draw_params``
   (seeded, as the launcher draws them), 64 new tokens after each
   prompt: internlm2-1.8b and mamba2-1.3b (8
   prompts of 2048 tokens), recurrentgemma-9b (RG-LRU and local
   attention, 4 prompts of 4096, twice its 2048-token window: prefill
   masks the window and folds the ring cache, decode writes across it),
   qwen2-vl-2b (8 x 2048 embeddings, M-RoPE's three streams a
   32 x 32 patch grid then text; decode continues in text),
   codeqwen1.5-7b and granite-3-8b (8 x 2048), qwen1.5-32b (in bf16,
   2 x 2048), dbrx-132b (the MoE feed-forward, 4 of its 40 layers) and
   deepseek-v2-236b (MLA and MoE, 3 of its 60 layers), 8 x 2048; each:
   prefill and decode times (medians of 3, CUDA events), tokens a
   second, peak memory (and what earlier phases still held before the
   parameters, ``base_gib``), bounds, one decode step under the
   profiler; the card against itself (its full forward over prompt +
   generated tokens
   on two rows against prefill's and every decode step's logits, the
   reference's serve contract, and the tokens against its argmax where
   the top-2 margin is wide), against the CPU (the same weights, a
   16-token prompt and 4 decode steps, relative L2 <= 1e-4; past 16
   GiB of weights on a view of the first whole periods of at least 2
   layers), fp32 products
   without TF32, and for the dense GQA configs one layer's prefill
   attention beside ``scaled_dot_product_attention`` (a yardstick the
   path never calls). qwen1.5-32b is held against its own bf16 forward
   and the CPU at ``LM_BF16_REL`` / ``LM_BF16_ATOL``; an MoE config
   prints the share of (token, expert) pairs its prefill dropped at the
   published capacity factor and runs its self-check on two rows at a
   factor at which none drops. internlm2-1.8b also runs the sharded
   steps (``[lm] mesh=1x1 path=sharded``): ``make_prefill_step`` and
   ``make_decode_step`` under the serve rules on a 1 x 1 mesh, where
   every spec is the whole leaf and no collective runs, with
   ``weights.shard_params``'s tree, their tokens and every step's logits
   bitwise equal to the one-rank model code's without rules
   (``models.model.prefill`` and ``decode_step``) on the same weights.
   Then
   hubert-xlarge, encoder-only: its forward
   over 8 x 2048 frame embeddings at full width (time, bound, peak
   memory, finite logits of the expected shape, one forward under the
   profiler) and the card against the CPU at smoke size (relative L2
   <= 1e-5); then ``python -m repro_torch.launch.serve --no-smoke`` as a
   subprocess, which must exit 0 with the phase's tokens. The path is
   plain PyTorch and launches none of the hand-written kernels; each
   model is freed before the next (recurrentgemma-9b's parameters alone
   take 35 GiB);
15. ``[train]``: ``fft_pencil`` and ``fft_matmul`` at the train path's
   shapes against their plain versions (524,288 pencils of 32 and
   270,336 of 64, with times, listed under ``train`` in the ``kernels``
   line); then the trainer (``make_train_step`` on a 1 x 1 mesh: the
   sharded trainer's step under the train rules, which on one rank runs
   every operation of the one-rank step) at full width in fp32,
   TF32 off, after freeing what earlier phases hold (``base_gib``):
   internlm2-1.8b and hubert-xlarge (embeds-mode batches; remat, 8 x
   2048 tokens in 2 microbatches, 4 steps at the default schedule,
   launching no FFT kernel) and the FFT-conv LM
   (mamba2-1.3b's widths with every block ``fftconv``, 48 layers,
   4 x 2048 tokens, 3 steps: 576 ``fft_matmul`` and 576 ``fft_pencil``
   launches a step, 12 of each a layer for the forward, remat's second
   forward and the backward's two correlation applies, every one on the
   tensor-core or radix-8 body). Each prints its step time (median of
   the steps after the first, CUDA events), tokens a second, peak
   memory, ce and grad norm a step, its flop and bound, and one more
   step under the profiler. Then one layer's ``_FFTConv`` at those
   shapes (8192 real signals of 4096): its gradients of hr and kr
   against autograd through the plain tier (``kernel='reference'``),
   its forward against the plain tier and ``torch.fft.rfft``/``irfft``
   (relative L2 <= 1e-5), timed beside both; one step at smoke size on
   the card against one on the CPU for internlm2, mamba2, hubert-xlarge
   and the fftconv model (ce, grad norm, parameters and moments, relative
   <= 1e-5); ``mesh=1x1 path=sharded``: internlm2-1.8b at full width
   and ``TRAIN_BITWISE_LAYERS`` layers, two steps of the step on a 1 x 1
   mesh against two of the step without a mesh (no rules), the losses
   and every parameter bitwise; ``python -m repro_torch.launch.train --arch mamba2-1.3b
   --steps 20 --ckpt-every 5 --fail-at 13`` as a subprocess beside an
   uninterrupted run (``restarts=1``, the final checkpoints equal
   byte for byte); and ``examples/torch_fftconv_lm.py`` as a subprocess
   (its loss falls by more than 0.3 nats). The FFT-conv LM's training
   steps count as the train path's launches in the ``kernels`` line;
16. the unfused supersteps and the rest of the FFT surface, after the
   serial paths (each line with its seconds; ``[new_phases]`` their
   sum): ``default_unfused`` (``pencil.make_fft(plan._pplan,
   fused=False)`` of the default 512^3 plan: 3 ``fft_matmul`` a
   direction on the tensor-core body, bitwise the fused functions'),
   ``stockham_unfused`` (``method='stockham'``: 3 ``fft_pencil`` and no
   ``fft_fused`` a direction on the radix-8 body, within 1e-6 of the
   fused plan, and a facade plan built under ``REPRO_FUSE_SUPERSTEP=0``
   bitwise the unfused function's), each against ``torch.fft.fftn`` and
   the round trip with its fwd+inv time beside the fused one's;
   ``large1d_stockham_unfused`` (the 8 signals of 2^24 planned under
   ``REPRO_FUSE_SUPERSTEP=0``: 2 ``fft_pencil`` a direction, the twiddle
   a product of its own, no ``fft_fused``); ``check=fft3d``
   (``pencil.fft3d``/``ifft3d`` bitwise ``make_fft``'s functions);
   ``check=apply_block`` (``methods.apply_block`` along axis 1 of a
   stacked (2, 512, 512, 512): one ``fft_block`` launch on the
   tensor-core body, bitwise ``methods.apply(method='block')``); then
   ``[example]``: ``examples/torch_quickstart.py --n 512 --n1d 16777216``
   and ``examples/torch_spectral_solver.py --n 512 --steps 50`` as
   subprocesses (their errors, each loop's us a step, the OK lines);
   and ``[paper]``: the headline lines of the analytic
   ``benchmarks/torch_paper_*.py`` scripts (959 us, 18.9 and 32.7 TF/s,
   18% over the DGX; each must print the reference's line verbatim) and
   ``torch_paper_fig3.py --batch 32768``'s GFLOP/s of each pencil on the
   card; ``[bench]``: ``benchmarks/torch_bench_kernels.py``,
   ``torch_bench_serve_fft.py`` and ``torch_bench_serve_service.py``
   with ``--smoke --device cuda``, the three subprocesses at once (each
   one's rows written, every served result bitwise, its seconds); then
   ``[path] label=large1d_factor_order``:
   ``make_fft1d_large``'s default, the factor-transposed D-form of the 8
   signals of 2^24 as (8, 4096, 4096), four_step (2 ``fft_matmul`` a
   direction on the tensor-core body) and stockham (1 ``fft_fused`` with
   twiddle planes and 1 ``fft_pencil``; unfused 2 ``fft_pencil``), both
   ``fused`` values, each against the natural-order result transposed
   (within 1e-6, bitwise where printed) and ``torch.fft.fft``;
   ``[kernel] check=fft_matmul_factors`` (the body's own split runs, a
   foreign one raises ``ValueError`` naming it and launches nothing);
   ``[dryrun]``: ``launch.dryrun.run_cell`` on
   internlm2-1.8b decode_32k at full width on the 16 x 16 mesh in a
   subprocess (``fake`` process group, ``meta`` tensors, no card): status
   ok and the hand count of its collectives; and in ``[lm]``,
   ``check=step_stats``: one real decode step of internlm2-1.8b counted
   by ``launch.hlostats``, its product flops exactly the dense products'
   and attention's over the cache, within 1.25 of 2 N B; ``[path]
   check=kernel_stats``: one fwd+inv of the default 512^3 plan under
   ``hlostats.count()``, its counted ``fft_matmul`` launches (6, on the
   tensor-core body, 16 bytes an element each) equal to the module's
   counter; and ``[dryrun] fft``: ``benchmarks/torch_roofline_fft.py``'s
   512^3 on 16 x 16, in ``[dryrun]``'s subprocess, the record's three
   terms and the dominant one;
17. a ``[total]`` line (the run's seconds), a ``kernels`` JSON line
   (``fft_matmul`` and ``fft_block`` also list
   their rank-1 shapes under ``rank1``: the instance each ran, its
   registers and spills, and its times; every kernel lists its
   ``[long]`` records under ``long`` and the launches of the long paths
   in ``launches_long``), the card line and, last, the result line.

The five serial paths resolve through the cost-model selector, as a
user's default plan does, to one overlap chunk. Each path prints its
fwd+inv time, the library's (``fftn``+``ifftn`` or ``rfftn``+``irfftn``),
its peak memory above the operand and a ``[profile]`` line with device
time by kernel.

It imports neither jax nor the JAX package. Without CUDA, or without the
rest of the repository beside it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import filecmp
import json
import math
import os
import re
import runpy
import subprocess
import sys
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke: torch.cuda.is_available() is False; this script "
             "needs an NVIDIA GPU")

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, 'src'))

import repro_torch.fft as fft  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.kernels import _build, _long, fft_block, fft_fused, fft_matmul, fft_pencil  # noqa: E402
from repro_torch.kernels import smem as smem_mirror  # noqa: E402
from repro_torch.comm import cost as costlib  # noqa: E402
from repro_torch.core.twiddle import four_step_factors  # noqa: E402
from repro_torch.fft import large1d as fft_large1d  # noqa: E402
from repro_torch.fft import methods as fft_methods, pencil as fft_pencil_mod  # noqa: E402
from repro_torch.launch import hlostats  # noqa: E402
from repro_torch.launch.mesh import abstract_fft_mesh, make_fft_mesh, make_host_mesh  # noqa: E402
from repro_torch.configs import get_config, make_batch  # noqa: E402
from repro_torch.models import attention as lm_attn, layers as lm_layers  # noqa: E402
from repro_torch.models import model as lm_model, moe as lm_moe, ssd as lm_ssd  # noqa: E402
from repro_torch.models.layers import tree_leaves, tree_map  # noqa: E402
from repro_torch.parallel import make_rules  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402
from repro_torch.serve.engine import make_decode_step, make_prefill_step  # noqa: E402
from repro_torch.weights import draw_params, shard_params  # noqa: E402

N = 512
SEED = 0

#: H100 SXM data-sheet peaks (dense, at the 700 W limit): HBM bytes/s and
#: fp32 flop/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

#: kernel vs plain version, max |kernel - plain| / max |plain|: both are
#: fp32 (eps 6e-8) through log2(n) = 9 butterfly stages or sums of at most
#: 32 terms per four-step factor, taken in different orders; the largest
#: elementwise gap over 2.7e8 outputs stays far below 1e-5 of the largest
#: magnitude
KERNEL_RTOL = 1e-5
#: main path vs torch.fft.fftn and round trip, relative L2: three fp32
#: pencil passes of the above error each, averaged over the array
PATH_RTOL = 1e-5
#: a chunked Stockham pair (radix8_pencil_kernel) against the serial one
#: (radix8_fused_kernel), max |a - b| / max |b|: one body, the same float
#: operations, so equal unless the compiler contracts them differently
STOCKHAM_OVERLAP_RTOL = 1e-6

#: the reference selector's picks, (strategy, overlap_chunks, method) for
#: (complex, real) plans, layout ('x', 'y', None), no measured table
PICKS = {(n, mesh): picks
         for n in (64, 128, 512)
         for mesh, picks in {
             (1, 1): (('all_to_all', 1, 'four_step'),
                      ('all_to_all', 1, 'auto' if n == 64 else 'four_step')),
             (2, 2): (('all_to_all', 8, 'four_step'),
                      ('all_to_all', 1, 'auto' if n == 64 else 'four_step')),
             (1, 4): (('ppermute', 8, 'four_step'),
                      ('ppermute', 1, 'auto' if n == 64 else 'four_step')),
         }.items()}
PICKS.update({(32, (1, 1)): (('all_to_all', 1, 'stockham'), ('all_to_all', 1, 'stockham')),
              (32, (2, 2)): (('all_to_all', 4, 'stockham'), ('all_to_all', 1, 'stockham'))})

#: the reference's rank-1 picks (``repro.fft.api._resolve_comm_1d``, no
#: measured table), (strategy, overlap_chunks, method) for (complex, real)
PICKS_1D = {
    (1 << 12, (1, 1)): (('all_to_all', 1, 'four_step'), ('all_to_all', 1, 'auto')),
    (1 << 12, (2, 2)): (('hierarchical', 1, 'four_step'), ('hierarchical', 1, 'auto')),
    (1 << 12, (1, 4)): (('all_to_all', 1, 'four_step'), ('all_to_all', 1, 'auto')),
    (1 << 24, (1, 1)): (('all_to_all', 1, 'four_step'), ('all_to_all', 1, 'four_step')),
    (1 << 24, (2, 2)): (('ppermute', 1, 'four_step'), ('ppermute', 1, 'four_step')),
    (1 << 24, (1, 4)): (('ppermute', 1, 'four_step'), ('ppermute', 1, 'four_step')),
}

#: the rank-1 paths: a batch of 8 signals of 2^24, the 512^3 paths' 1 GiB
LARGE1D = (1 << 24,)
LARGE1D_BATCH = (8,)

KERNELS = {
    'fft_pencil': dict(source='src/repro_torch/csrc/fft_pencil.cu',
                       replaces='src/repro/kernels/fft_pencil.py:76'),
    'fft_twiddle_transpose': dict(source='src/repro_torch/csrc/fft_pencil.cu',
                                  replaces='src/repro/kernels/fft_fused.py:58'),
    'fft_matmul': dict(source='src/repro_torch/csrc/fft_matmul.cu',
                       replaces='src/repro/kernels/fft_matmul.py:71'),
    'fft_block': dict(source='src/repro_torch/csrc/fft_block.cu',
                      replaces='src/repro/kernels/fft_block.py:49'),
}
COUNTER = {'fft_pencil': 'fft_pencil', 'fft_twiddle_transpose': 'fft_fused',
           'fft_matmul': 'fft_matmul', 'fft_block': 'fft_block'}


#: the measured keys of each kernel's record in the ``kernels`` JSON line
JSON_KEYS = ('max_abs_err', 'ms', 'plain_ms', 'bound_ms', 'bound_by', 'library_ms')
#: and of each rank-1 shape listed under a four-step kernel's ``rank1``
RANK1_KEYS = ('n', 'pencils', 'instance', 'registers', 'spill_bytes', 'smem_bytes',
              'blocks_per_sm') + JSON_KEYS + ('fma_ms',)


def say(phase: str, **kw) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kw.items()), flush=True)


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median over ``reps`` of one call's device time: CUDA events around
    each call, the calls queued back to back with one synchronize at the
    end, so the host's time to issue a call hides behind the device time
    of the one before (synchronizing after each call would count it)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(reps)]
    for a, b in events:
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    times = sorted(a.elapsed_time(b) for a, b in events)
    return times[len(times) // 2]


def planar(shape, gen) -> tuple:
    return (torch.randn(shape, generator=gen, device='cuda'),
            torch.randn(shape, generator=gen, device='cuda'))


def max_err(got, want) -> tuple:
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    scale = max(float(w.abs().max()) for w in want)
    return err, err / scale


def bound(n_elems: int, flops: float) -> tuple:
    """(bound_ms, bound_by): the larger of bytes over the HBM rate (each
    planar input read once, each output written once) and flops over
    the fp32 rate."""
    t_bytes = 16 * n_elems / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def fft_flops(n: int, pencils: int) -> float:
    """The operations a length-n FFT needs, 5 n log2 n a pencil, whatever
    form a kernel computes it in (the four-step's dense products do more)."""
    return 5.0 * n * math.log2(n) * pencils


def check(name, got, want, where) -> float:
    err, rel = max_err(got, want)
    if not rel <= KERNEL_RTOL:
        raise AssertionError(f"{name} {where}: max err {err:.3e} = {rel:.3e} of max|plain| "
                             f"> {KERNEL_RTOL}")
    return err


#: the kernels whose spills fail the run: the tensor-core bodies (both
#: splits) and the radix-8 Stockham bodies
NO_SPILLS = re.compile(r'_mma3?_kernel|radix8_')


def phase_card() -> tuple:
    """The card line, after building the kernels; and each kernel's
    ptxas entry (registers, spill bytes) by its name."""
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader', '-i', '0'],
        check=True, capture_output=True, text=True).stdout.strip()
    say('card', card=repr(card), torch=torch.__version__, cuda=torch.version.cuda,
        device=repr(torch.cuda.get_device_name(0)))
    t0 = time.perf_counter()
    _build.build()
    report = {}
    for name in _build.SOURCES:
        for entry in ptxas_report(_build.build_log(name)):
            entry.update(radix8_shared(entry['kernel']))
            say('build', source=name, **entry)
            if NO_SPILLS.search(entry['kernel']) and (entry['spill_stores']
                                                     or entry['spill_loads']):
                raise AssertionError(f"{entry['kernel']} spills: {entry}")
            report[entry['kernel']] = entry
    say('build', seconds=f"{time.perf_counter() - t0:.1f}")
    return card, report


def radix8_shared(kernel: str) -> dict:
    """A radix-8 kernel's block at the main path's shapes (262,144
    pencils; rows of 512 for the fused kernel), its shared memory being
    all dynamic: pencils, threads and shared bytes from the layout
    functions, which must give the bytes the library's
    ``radix8_smem_bytes`` gives."""
    m = re.fullmatch(r'radix8_(pencil|fused)_kernel<(\d+)>', kernel)
    if not m:
        return {}
    n, fused = 1 << int(m.group(2)), m.group(1) == 'fused'
    P, threads, smem = (fft_fused.tile_layout(n, N) if fused
                        else fft_pencil.radix8_layout(n, N * N))
    lib = fft_pencil._lib()
    if lib.radix8_smem_bytes(n, P, int(fused)) != smem:
        raise AssertionError(f"{kernel}: the layout's {smem} shared bytes differ from the "
                             f"library's {lib.radix8_smem_bytes(n, P, int(fused))}")
    return dict(pencils=P, threads=threads, smem_bytes=smem)


def kernel_name(sym: str) -> str:
    """A kernel's name from its mangled symbol, with integer template
    arguments: ``_ZN12_GLOBAL__N_116block_mma_kernelILi32ELi16EEEv...``
    is ``block_mma_kernel<32,16>``."""
    if not sym.startswith('_Z'):
        return sym
    i, name = 3 if sym.startswith('_ZN') else 2, sym
    while i < len(sym) and sym[i].isdigit():
        j = i
        while sym[j].isdigit():
            j += 1
        name, i = sym[j:j + int(sym[i:j])], j + int(sym[i:j])
    args = re.match(r'I((?:Li\d+E)+)E', sym[i:])
    if args:
        name += '<' + ','.join(re.findall(r'Li(\d+)E', args.group(1))) + '>'
    return name


def ptxas_report(log: str) -> list:
    """Registers and spill bytes of each kernel in ``nvcc -Xptxas -v``'s
    report, the kernel named by its identifier and template arguments."""
    out = []
    for ln in log.splitlines():
        if 'Compiling entry function' in ln:
            out.append(dict(kernel=kernel_name(ln.split("'")[1]), registers=None,
                            spill_stores=None, spill_loads=None))
        elif out and 'spill stores' in ln:
            st, ld = re.findall(r'(\d+) bytes spill (?:stores|loads)', ln)
            out[-1].update(spill_stores=int(st), spill_loads=int(ld))
        elif out and 'Used' in ln and 'registers' in ln:
            out[-1]['registers'] = int(re.search(r'Used (\d+) registers', ln).group(1))
    return out


def phase_kernels(gen, ptxas: dict) -> dict:
    """Each kernel against its plain version; returns name -> record."""
    rec = {}
    x = planar((N, N, N), gen)
    pencils = N * N
    xc = torch.complex(*x)

    # fft_pencil
    err = max(check('fft_pencil', fft_pencil.fft_pencil(*x, inverse=inv),
                    fft_pencil.fft_pencil_plain(*x, inverse=inv), f"{N}^3 inverse={inv}")
              for inv in (False, True))
    ms = time_ms(lambda: fft_pencil.fft_pencil(*x), 20)
    plain = time_ms(lambda: fft_pencil.fft_pencil_plain(*x), 5)
    lib = time_ms(lambda: torch.fft.fft(xc, dim=-1), 20)
    b, by = bound(x[0].numel(), fft_flops(N, pencils))
    y = tuple(torch.empty_like(p) for p in x)
    P, threads, smem = fft_pencil.radix8_layout(N, pencils)
    rec['fft_pencil'] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b, bound_by=by,
        variant=fft_pencil.variant(N), pencils_per_block=P, threads=threads, smem_bytes=smem,
        radix2_ms=time_ms(lambda: fft_pencil._launch(*x, *y, N, False, _body='radix2'), 20))
    del y

    # fft_twiddle_transpose (the 3-D path has no twiddle; one checked too)
    err = max(check('fft_twiddle_transpose',
                    fft_fused.fft_twiddle_transpose(*x, inverse=inv),
                    fft_fused.fft_twiddle_transpose_plain(*x, inverse=inv),
                    f"{N}^3 inverse={inv}")
              for inv in (False, True))
    w = planar((N, N), gen)
    err = max(err, check('fft_twiddle_transpose',
                         fft_fused.fft_twiddle_transpose(*x, *w),
                         fft_fused.fft_twiddle_transpose_plain(*x, *w),
                         f"{N}^3 with twiddle"))
    ms = time_ms(lambda: fft_fused.fft_twiddle_transpose(*x), 20)
    plain = time_ms(lambda: fft_fused.fft_twiddle_transpose_plain(*x), 5)
    lib = time_ms(lambda: torch.fft.fft(xc, dim=-1).transpose(-1, -2).contiguous(), 20)
    b, by = bound(x[0].numel(), fft_flops(N, pencils))
    y = tuple(torch.empty_like(p) for p in x)
    P, threads, smem = fft_fused.tile_layout(N, N)
    rec['fft_twiddle_transpose'] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b, bound_by=by,
        variant=fft_fused.variant(N), pencils_per_block=P, threads=threads, smem_bytes=smem,
        radix2_ms=time_ms(lambda: fft_fused._launch(*x, None, None, *y, False,
                                                    _body='radix2'), 20))
    del y

    del x, xc

    rec.update(kernels_four_step(gen, N))
    # the real path's r2c/c2r supersteps: 512 * 512 half pencils of 256
    for name, r in kernels_four_step(gen, N // 2).items():
        say('kernel', name=name, n=N // 2, pencils=N * N, tol=KERNEL_RTOL,
            **{k: (f"{v:.6g}" if isinstance(v, float) else v) for k, v in r.items()})
    kernel_unaligned(gen)
    rank1 = kernels_large1d(gen, ptxas)
    for name in rank1:
        rec[name]['rank1'] = rank1[name]

    # ragged tiles and other lengths: every n the kernels take
    for n in (1 << k for k in range(1, 13)):
        y = planar((37, n), gen)
        z = planar((3, 29, n), gen)
        wz = planar((29, n), gen)
        wf = planar((3, 29, n), gen)
        yb = torch.stack(y)
        for inv in (False, True):
            check('fft_block', fft_block.fft_block(yb, inverse=inv),
                  fft_block.fft_block_plain(yb, inverse=inv), f"(2, 37, {n})")
            check('fft_pencil', fft_pencil.fft_pencil(*y, inverse=inv),
                  fft_pencil.fft_pencil_plain(*y, inverse=inv), f"(37, {n})")
            check('fft_matmul', fft_matmul.fft_matmul(*y, inverse=inv),
                  fft_matmul.fft_matmul_plain(*y, inverse=inv), f"(37, {n})")
            check('fft_twiddle_transpose',
                  fft_fused.fft_twiddle_transpose(*z, *wz, inverse=inv),
                  fft_fused.fft_twiddle_transpose_plain(*z, *wz, inverse=inv),
                  f"(3, 29, {n}) with a (29, {n}) twiddle")
            check('fft_twiddle_transpose',
                  fft_fused.fft_twiddle_transpose(*z, *wf, inverse=inv),
                  fft_fused.fft_twiddle_transpose_plain(*z, *wf, inverse=inv),
                  f"(3, 29, {n}) with a twiddle a slice")
    for name, r in rec.items():
        say('kernel', name=name, tol=KERNEL_RTOL,
            **{k: (f"{v:.6g}" if isinstance(v, float) else v) for k, v in r.items()
               if k != 'rank1'})
    return rec


def tensor_core_extras(module, x: tuple, n: int, pencils: int) -> dict:
    """What ``fft_matmul`` and ``fft_block`` print beside their times: the
    CUDA-core body's time on the same planes (``fma_ms``), a yardstick in
    the same run, the dense products' time at the fp32 CUDA-core peak
    (``dense_flop_ms``: 8 n flop an element for each factor of the split
    the launch runs) and what the launch runs (``launch_info``: body,
    split, pencils a tile, shared bytes, blocks an SM; registers for
    fft_matmul)."""
    factors = fft_block.mma_factors(n) if module.variant(n) == 'mma' else four_step_factors(n)
    y = tuple(torch.empty_like(p) for p in x)
    return dict(fma_ms=time_ms(lambda: module._launch(*x, *y, n, False, _body='fma'), 20),
                dense_flop_ms=8.0 * n * sum(factors) * pencils / FP32_FLOP_PER_S * 1e3,
                **module.launch_info(n, pencils))


def kernels_four_step(gen, n: int) -> dict:
    """``fft_matmul`` (a planar pair: the default and real paths) and
    ``fft_block`` (stacked: the block paths) on 512 * 512 pencils of n,
    each against its plain version, forward and inverse; name -> its
    times, bound and tensor-core extras at that shape."""
    pencils = N * N
    x = planar((pencils, n), gen)
    xs = torch.stack(x)
    xc = torch.complex(*x)
    lib = time_ms(lambda: torch.fft.fft(xc, dim=-1), 20)
    b, by = bound(pencils * n, fft_flops(n, pencils))
    runs = (('fft_matmul', fft_matmul, lambda inv: fft_matmul.fft_matmul(*x, inverse=inv),
             lambda inv: fft_matmul.fft_matmul_plain(*x, inverse=inv)),
            ('fft_block', fft_block, lambda inv: fft_block.fft_block(xs, inverse=inv),
             lambda inv: fft_block.fft_block_plain(xs, inverse=inv)))
    rec = {}
    for name, module, run, plain in runs:
        err = max(check(name, run(inv), plain(inv), f"({pencils}, {n}) inverse={inv}")
                  for inv in (False, True))
        rec[name] = dict(max_abs_err=err, ms=time_ms(lambda: run(False), 20),
                         plain_ms=time_ms(lambda: plain(False), 5), library_ms=lib,
                         bound_ms=b, bound_by=by, **tensor_core_extras(module, x, n, pencils))
    return rec


def kernels_large1d(gen, ptxas: dict) -> dict:
    """The kernels at the rank-1 paths' shapes, each against its plain
    version: ``fft_matmul`` and ``fft_block`` (planar, as the paths call
    both) on the 8 x 4096 pencils of 4096 (``large1d``'s columns and rows)
    and of 2048 (``rlarge1d``'s r2c columns), both on the three-factor
    tensor-core body, with their times, the CUDA-core body's
    (``fma_ms``), the library's and the bound, and on ``rlarge1d``'s 8 x
    2049 row pencils of 4096; ``fft_twiddle_transpose`` on the (8, 4096, 4096) column
    superstep with twiddle planes of (4096, 4096), with its times and
    bound, and without them (``large1d_stockham``'s row superstep).
    Returns name -> the records of ``fft_matmul`` and ``fft_block``, each
    with the instance it ran and that instance's registers and spills."""
    b = LARGE1D_BATCH[0] * 4096
    rows = LARGE1D_BATCH[0] * (2048 + 1)
    out = {'fft_matmul': [], 'fft_block': []}
    for n in (4096, 2048):
        x = planar((b, n), gen)
        xc = torch.complex(*x)
        lib = time_ms(lambda: torch.fft.fft(xc, dim=-1), 10)
        bnd, by = bound(b * n, fft_flops(n, b))
        runs = (('fft_matmul', fft_matmul, 'matmul', lambda v, inv: fft_matmul.fft_matmul(
                    *v, inverse=inv), lambda v, inv: fft_matmul.fft_matmul_plain(*v, inverse=inv)),
                ('fft_block', fft_block, 'block', lambda v, inv: fft_block.fft_block_planar(
                    *v, inverse=inv), lambda v, inv: fft_block.fft_block_plain(
                    torch.stack(v), inverse=inv)))
        for name, module, stem, run, plain in runs:
            err = max(check(name, run(x, inv), plain(x, inv), f"({b}, {n}) inverse={inv}")
                      for inv in (False, True))
            if n == 4096:
                part = tuple(p[:rows] for p in x)
                err = max(err, *(check(name, run(part, inv), plain(part, inv),
                                       f"({rows}, {n}) inverse={inv}")
                                 for inv in (False, True)))
            info = tensor_core_extras(module, x, n, b)
            if info['variant'] != 'mma':
                raise AssertionError(f"{name}: n={n} runs the {info['variant']} body")
            instance = next(k for k in ptxas if k.startswith(
                f"{stem}_mma3_kernel<{info['factors'].replace('x', ',')},"))
            r = dict(n=n, pencils=b, max_abs_err=err,
                     ms=time_ms(lambda: run(x, False), 10),
                     plain_ms=time_ms(lambda: plain(x, False), 3), library_ms=lib,
                     bound_ms=bnd, bound_by=by, **info, instance=instance)
            r.update(registers=ptxas[instance]['registers'],
                     spill_bytes=ptxas[instance]['spill_stores'] + ptxas[instance]['spill_loads'])
            say('kernel', name=name, tol=KERNEL_RTOL,
                **{k: (f"{v:.6g}" if isinstance(v, float) else v) for k, v in r.items()})
            out[name].append(r)
        del x, xc
    z = planar(LARGE1D_BATCH + (4096, 4096), gen)
    w = planar((4096, 4096), gen)
    err = max(check('fft_twiddle_transpose',
                    fft_fused.fft_twiddle_transpose(*z, *w, inverse=inv),
                    fft_fused.fft_twiddle_transpose_plain(*z, *w, inverse=inv),
                    f"{tuple(z[0].shape)} with twiddle, inverse={inv}")
              for inv in (False, True))
    err = max(err, *(check('fft_twiddle_transpose',
                           fft_fused.fft_twiddle_transpose(*z, inverse=inv),
                           fft_fused.fft_twiddle_transpose_plain(*z, inverse=inv),
                           f"{tuple(z[0].shape)} inverse={inv}")
                     for inv in (False, True)))
    zc = torch.complex(*z)
    # the (4096, 4096) twiddle planes, shared by the 8 signals, are read
    # once: 8 bytes a twiddle entry, half an element's 16
    bnd, by = bound(z[0].numel() + w[0].numel() // 2, fft_flops(4096, b))
    P, threads, smem = fft_fused.tile_layout(4096, 4096)
    ms = time_ms(lambda: fft_fused.fft_twiddle_transpose(*z, *w), 10)
    plain = time_ms(lambda: fft_fused.fft_twiddle_transpose_plain(*z, *w), 3)
    lib = time_ms(lambda: torch.fft.fft(zc, dim=-1).transpose(-1, -2).contiguous(), 10)
    say('kernel', name='fft_twiddle_transpose', n=4096, pencils=b, twiddle=True,
        tol=KERNEL_RTOL, max_abs_err=f"{err:.6g}", ms=f"{ms:.6g}", plain_ms=f"{plain:.6g}",
        library_ms=f"{lib:.6g}", bound_ms=f"{bnd:.6g}", bound_by=by,
        variant=fft_fused.variant(4096), pencils_per_block=P, threads=threads,
        smem_bytes=smem)
    return out


def kernel_unaligned(gen) -> None:
    """Both tensor-core kernels at n = 512 and 4096 (the two splits) on
    planes one float past a 16-byte boundary: the body's tile loads take
    4-byte copies (``vec`` = 0), which no path's allocations reach."""
    batch = 37
    for n in (N, 4096):
        flat = planar((batch * n + 1,), gen)
        re_, im_ = (t[1:].view(batch, n) for t in flat)
        if not (re_.data_ptr() % 16 and im_.data_ptr() % 16):
            raise AssertionError("unaligned check: the planes are 16-byte aligned")
        xs = torch.stack([re_, im_])
        for inv in (False, True):
            err = check('fft_matmul', fft_matmul.fft_matmul(re_, im_, inverse=inv),
                        fft_matmul.fft_matmul_plain(re_, im_, inverse=inv),
                        f"({batch}, {n}) at an offset of one float, inverse={inv}")
            err = max(err, check('fft_block', fft_block.fft_block_planar(re_, im_, inverse=inv),
                                 fft_block.fft_block_plain(xs, inverse=inv),
                                 f"({batch}, {n}) at an offset of one float, inverse={inv}"))
        say('kernel', check='planes at an offset of one float', n=n, batch=batch,
            variant=fft_matmul.variant(n), max_abs_err=f"{err:.6g}", tol=KERNEL_RTOL)


def profile(fn, sums: dict = None) -> dict:
    """One call under ``torch.profiler``: device time per kernel, the
    device's busy time and its idle share of the call's wall time (the
    profiler's own overhead is in the wall time); ``sums`` names the
    kernels (a regex each) whose device time is also added up. Only
    kernels and copies count: the device-side spans of annotations (a
    collective's ``nccl:all_reduce`` beside its ``ncclDevKernel_*``)
    would count their kernels' time twice."""
    from torch.profiler import ProfilerActivity
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    per_kernel = {}
    for e in prof.key_averages():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(e, 'is_user_annotation', False)
                and not e.key.startswith('nccl:')):
            per_kernel[e.key] = per_kernel.get(e.key, 0.0) + e.self_device_time_total
    busy_us = sum(per_kernel.values())
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:8]
    extra = {name: f"{sum(v for k, v in per_kernel.items() if re.search(rx, k)) / 1e3:.6g}"
             for name, rx in (sums or {}).items()}
    return dict(wall_ms=f"{wall_us / 1e3:.6g}", device_busy_ms=f"{busy_us / 1e3:.6g}",
                idle_share=f"{1 - busy_us / wall_us:.3f}", **extra,
                top=json.dumps([[k[:48], round(v / 1e3, 3)] for k, v in top]))


def phase_path(label: str, gen, expect_method: str, expect: dict, real: bool = False,
               chunks: int = 1, unchunked_rtol: float = 0.0, shape=(N, N, N),
               batch: tuple = (), twiddled: int = 0, long: bool = False,
               by_n: dict = None, **plan_kw) -> dict:
    """One main path: plan, forward, inverse; returns the launch counts.
    A real path (``rplan``) takes a real operand and is held against
    ``torch.fft.rfftn``; a complex one against ``torch.fft.fftn``, over
    the planned axes of each of the ``batch`` signals (relative L2, the
    largest). Every ``fft_matmul``/``fft_block`` launch must be on the
    tensor-core body; every ``fft_pencil``/``fft_fused`` launch on the
    radix-8 body; on a ``long`` path (pencils above 4096) every launch
    on the long body instead; ``twiddled`` ``fft_fused`` launches a
    direction must apply twiddle planes; ``by_n``, where given, gains
    the forward's and inverse's launches by (kernel module, n). A pipelined path (``chunks`` > 1) is also held
    against its unchunked plan's forward: bitwise, or within
    ``unchunked_rtol`` of its largest magnitude."""
    p = (fft.rplan if real else fft.plan)(shape, make_fft_mesh(1, 1), **plan_kw)
    got = (p.method, p.comm, p.overlap_chunks, p.resolved_kernel)
    if got != (expect_method, 'all_to_all', chunks, 'pallas'):
        raise AssertionError(f"{label}: resolved to {got}")
    if real:
        if p.spectrum_shape != shape[:-1] + (shape[-1] // 2 + 1,):
            raise AssertionError(f"{label}: spectrum shape {p.spectrum_shape}")
        x = torch.randn(batch + shape, generator=gen, device='cuda')
    else:
        xr, xi = planar(batch + shape, gen)
        x = torch.complex(xr, xi)
    dims = tuple(range(len(batch), len(batch) + len(shape)))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()

    def count_n(r):
        by_n[r['name'], r['n']] = by_n.get((r['name'], r['n']), 0) + 1
    if by_n is not None:
        kernels.HOOKS.append(count_n)
    try:
        y = p.forward(x)
        fwd = kernels.launch_counts()
        fwd_twiddle = fft_fused.launches_twiddle
        x2 = p.inverse(y)
    finally:
        if by_n is not None:
            kernels.HOOKS.remove(count_n)
    torch.cuda.synchronize()
    total = kernels.launch_counts()
    on_mma = {'fft_block': fft_block.launches_mma, 'fft_matmul': fft_matmul.launches_mma}
    on_radix8 = {'fft_fused': fft_fused.launches_radix8,
                 'fft_pencil': fft_pencil.launches_radix8}
    on_long = {name: mod.launches_long for name, mod in kernels._modules().items()}
    twiddle = {'fwd': fwd_twiddle, 'total': fft_fused.launches_twiddle}
    peak_gib = (torch.cuda.max_memory_allocated() - base) / 2**30
    ref = torch.fft.rfftn(x, dim=dims) if real else torch.fft.fftn(x, dim=dims)
    if y.shape != ref.shape or y.dtype != torch.complex64:
        raise AssertionError(f"{label}: forward gave {y.dtype}{tuple(y.shape)}")

    def rel_l2(a, b):
        a, b = a.reshape(len(a) if batch else 1, -1), b.reshape(len(b) if batch else 1, -1)
        return float((torch.linalg.vector_norm(a - b, dim=-1)
                      / torch.linalg.vector_norm(b, dim=-1)).max())
    fwd_err = rel_l2(y, ref)
    del ref
    rt_err = rel_l2(x2, x)
    for k, per_dir in expect.items():
        if fwd[k] != per_dir or total[k] != 2 * per_dir:
            raise AssertionError(f"{label}: {k} launched {fwd[k]} forward / {total[k]} "
                                 f"in all, expected {per_dir} per direction")
    for k in total:
        if k not in expect and total[k]:
            raise AssertionError(f"{label}: unexpected {k} launches {total[k]}")
    for k, lg in on_long.items():
        if lg != (total[k] if long else 0):
            raise AssertionError(f"{label}: {lg} of {total[k]} {k} launches on the long body")
    for k, mma in on_mma.items():
        if mma != (0 if long else total[k]):
            raise AssertionError(f"{label}: {mma} of {total[k]} {k} launches on the "
                                 "tensor-core body")
    for k, r8 in on_radix8.items():
        if r8 != (0 if long else total[k]):
            raise AssertionError(f"{label}: {r8} of {total[k]} {k} launches on the "
                                 "radix-8 body")
    if twiddle != {'fwd': twiddled, 'total': 2 * twiddled}:
        raise AssertionError(f"{label}: fft_fused launches with twiddle planes {twiddle}, "
                             f"expected {twiddled} per direction")
    if not (fwd_err <= PATH_RTOL and rt_err <= PATH_RTOL):
        raise AssertionError(f"{label}: forward rel L2 {fwd_err:.3e}, round trip "
                             f"{rt_err:.3e}, limit {PATH_RTOL}")
    extra = {}
    if chunks > 1:
        y1 = p.with_options(overlap_chunks=1).forward(x)
        gap = float((y - y1).abs().max() / y1.abs().max())
        extra.update(vs_unchunked_bitwise=torch.equal(y, y1), vs_unchunked_rel=f"{gap:.3e}")
        if not (torch.equal(y, y1) if unchunked_rtol == 0.0 else gap <= unchunked_rtol):
            raise AssertionError(f"{label}: forward differs from the unchunked plan's by "
                                 f"{gap:.3e} of its largest magnitude, limit {unchunked_rtol}")
        del y1
    del y, x2
    ms = time_ms(lambda: p.inverse(p.forward(x)), 5)
    if real:
        lib = time_ms(lambda: torch.fft.irfftn(torch.fft.rfftn(x, dim=dims), s=shape,
                                               dim=dims), 5)
        extra['spectrum'] = json.dumps(list(p.spectrum_shape))
    else:
        extra['planar_fwd_inv_ms'] = (
            f"{time_ms(lambda: p.inverse(p.forward((xr, xi))), 5):.6g}")
        lib = time_ms(lambda: torch.fft.ifftn(torch.fft.fftn(x, dim=dims), dim=dims), 5)
    say('path', label=label, shape=json.dumps(list(batch + shape)), method=p.method,
        comm=p.comm, chunks=p.overlap_chunks, kernel=p.resolved_kernel,
        fwd_rel_l2=f"{fwd_err:.3e}", roundtrip_rel_l2=f"{rt_err:.3e}", tol=PATH_RTOL,
        launches=json.dumps(total), peak_gib_over_operand=f"{peak_gib:.4g}",
        launches_mma=json.dumps(on_mma), launches_radix8=json.dumps(on_radix8),
        **({'launches_long': json.dumps(on_long)} if long else {}),
        launches_twiddle=json.dumps(twiddle), fwd_inv_ms=f"{ms:.6g}",
        library_ms=f"{lib:.6g}", **extra)
    say('profile', label=label, **profile(lambda: p.inverse(p.forward(x)),
                                          LONG_SUMS if long else None))
    return total


#: ``[long]``: the long body's lengths, each on LONG_ELEMS / n pencils
LONG_NS = (8192, 16384, 32768, 65536)
LONG_ELEMS = 1 << 24
#: the keys of each record under a kernel's ``long`` in the ``kernels`` line
LONG_KEYS = ('n', 'pencils', 'variant', 'launches', 'rel_l2') + JSON_KEYS + (
    'twiddle_ms', 'twiddle_hbm_bytes_per_elem', 'factors', 'cluster', 'threads',
    'smem_bytes', 'blocks_per_sm', 'clusters_per_device', 'registers', 'scratch_bytes',
    'hbm_bytes_per_elem')
#: the long body's kernels, a regex each, whose device time the profiles add up
LONG_SUMS = {'long_kernel_ms': r'long_kernel', 'long_transpose_ms': r'long_transpose_kernel'}
#: ``[long]``'s paths: label, shape, plan keywords, launches a direction,
#: fused launches with twiddle planes a direction
LONG_PATHS = (
    # 'auto' stays the plan's method; each pencil resolves to four_step
    ('fft2d_long', (8192, 32768), {}, 'auto', {'fft_matmul': 2}, 0),
    ('fft2d_long_stockham', (8192, 32768), dict(method='stockham'), 'stockham',
     {'fft_fused': 1, 'fft_pencil': 1}, 0),
    ('fft2d_long_block', (8192, 32768), dict(method='block'), 'block', {'fft_block': 2}, 0),
    # 16384 x 16384; the selector picks stockham for both factors, as the
    # reference's does, so 'auto' is the stockham plan
    ('large1d_long', (1 << 28,), {}, 'stockham', {'fft_fused': 2}, 1),
    ('large1d_long_stockham', (1 << 28,), dict(method='stockham'), 'stockham',
     {'fft_fused': 2}, 1),
    ('large1d_long_four_step', (1 << 28,), dict(method='four_step'), 'four_step',
     {'fft_matmul': 2}, 0),
)


def _rel_l2_planar(got, want) -> float:
    num = sum(float(torch.linalg.vector_norm(g - w)) ** 2 for g, w in zip(got, want))
    den = sum(float(torch.linalg.vector_norm(w)) ** 2 for w in want)
    return math.sqrt(num / den)


def kernels_long(gen, ptxas: dict) -> dict:
    """Each kernel on the long body at every length of :data:`LONG_NS`, on
    LONG_ELEMS / n pencils: forward and inverse against its plain version
    (relative L2 and the largest gap, both within KERNEL_RTOL), and on 3
    pencils; ``fft_twiddle_transpose`` also with (b, n) twiddle planes, a
    plane a leading slice and one plane for all; with its time, the plain
    version's, the library's and the bound (the fused route's also with
    (pencils, n) twiddle planes, and one call's device time split between
    its kernel and its transpose), and ``launch_info``, whose shared,
    thread, cluster, scratch and device-byte counts must equal the C
    side's mirrors. Returns name -> its records."""
    out = {name: [] for name in KERNELS}
    for kern in sorted(k for k in ptxas if k.startswith('long_')):
        e = ptxas[kern]
        say('long', build=kern, registers=e['registers'],
            spill_bytes=(e['spill_stores'] or 0) + (e['spill_loads'] or 0))
    for n in LONG_NS:
        pencils = LONG_ELEMS // n
        mirror = dict(smem_bytes=_long.smem_bytes(n), threads=_long.threads(n),
                      cluster=_long.cluster(n),
                      scratch_bytes=[_long.scratch_bytes(n, pencils, False),
                                     _long.scratch_bytes(n, pencils, True)],
                      hbm_bytes_per_elem=[_long.hbm_bytes_per_elem(False),
                                          _long.hbm_bytes_per_elem(True)])
        x = planar((pencils, n), gen)
        xc = torch.complex(*x)
        small = planar((3, n), gen)
        z = planar((3, 5, n), gen)
        wz, wf = planar((5, n), gen), planar((3, 5, n), gen)
        w = planar((pencils, n), gen)
        lib = time_ms(lambda: torch.fft.fft(xc, dim=-1), 10)
        lib_t = time_ms(lambda: torch.fft.fft(xc, dim=-1).transpose(-1, -2).contiguous(), 10)
        bnd, by = bound(pencils * n, fft_flops(n, pencils))
        # name, module, the operand of planes v, the kernel and its plain
        # version on an operand (a planar pair out), the library's time
        runs = (
            ('fft_pencil', fft_pencil, tuple,
             lambda a, inv: fft_pencil.fft_pencil(*a, inverse=inv),
             lambda a, inv: fft_pencil.fft_pencil_plain(*a, inverse=inv), lib),
            ('fft_matmul', fft_matmul, tuple,
             lambda a, inv: fft_matmul.fft_matmul(*a, inverse=inv),
             lambda a, inv: fft_matmul.fft_matmul_plain(*a, inverse=inv), lib),
            ('fft_block', fft_block, torch.stack,
             lambda a, inv: tuple(fft_block.fft_block(a, inverse=inv)),
             lambda a, inv: tuple(fft_block.fft_block_plain(a, inverse=inv)), lib),
            ('fft_twiddle_transpose', fft_fused, tuple,
             lambda a, inv: fft_fused.fft_twiddle_transpose(*a, inverse=inv),
             lambda a, inv: fft_fused.fft_twiddle_transpose_plain(*a, inverse=inv), lib_t),
        )
        for name, module, operand, run, plain, lib_ms in runs:
            kernels.reset_launch_counts()
            err, rel = 0.0, 0.0
            a = operand(x)
            for inv in (False, True):
                for v in (a, operand(small)):
                    got, want = run(v, inv), plain(v, inv)
                    err = max(err, check(name, got, want, f"({len(v[0])}, {n}) inverse={inv}"))
                    rel = max(rel, _rel_l2_planar(got, want))
                    del got, want
            if name == 'fft_twiddle_transpose':
                for v, tw_, where in ((x, w, f"({pencils}, {n}) with ({pencils}, {n}) planes"),
                                      (z, wz, f"(3, 5, {n}) with one (5, {n}) plane"),
                                      (z, wf, f"(3, 5, {n}) with a plane a slice")):
                    for inv in (False, True):
                        got = fft_fused.fft_twiddle_transpose(*v, *tw_, inverse=inv)
                        want = fft_fused.fft_twiddle_transpose_plain(*v, *tw_, inverse=inv)
                        err = max(err, check(name, got, want, f"{where}, inverse={inv}"))
                        rel = max(rel, _rel_l2_planar(got, want))
                        del got, want
            if not rel <= KERNEL_RTOL:
                raise AssertionError(f"{name} n={n}: relative L2 {rel:.3e} against the plain "
                                     f"version > {KERNEL_RTOL}")
            if module.launches_long != module.launches or module.launches_long == 0:
                raise AssertionError(f"{name} n={n}: {module.launches_long} of "
                                     f"{module.launches} launches on the long body")
            yc = torch.fft.fft(xc, dim=-1)
            if name == 'fft_twiddle_transpose':
                yc = yc.transpose(-1, -2)
            vs_lib = _rel_l2_planar(run(a, False), (yc.real, yc.imag))
            del yc
            fused = name == 'fft_twiddle_transpose'
            r = dict(n=n, pencils=pencils, variant=module.variant(n), rel_l2=rel,
                     max_abs_err=err, ms=time_ms(lambda: run(a, False), 10),
                     plain_ms=time_ms(lambda: plain(a, False), 3), library_ms=lib_ms,
                     bound_ms=bnd, bound_by=by, vs_library_rel_l2=vs_lib, twiddle_ms=None,
                     twiddle_hbm_bytes_per_elem=None)
            if fused:
                # the route with (pencils, n) twiddle planes and the bytes it moves an
                # element, and one call's device time split between its two kernels
                r['twiddle_ms'] = time_ms(lambda: fft_fused.fft_twiddle_transpose(*x, *w), 10)
                r['twiddle_hbm_bytes_per_elem'] = _long.hbm_bytes_per_elem(True, twiddle=True)
                prof = profile(lambda: run(a, False), LONG_SUMS)
                r.update({k: prof[k] for k in LONG_SUMS})
            info = module.launch_info(n, pencils)
            if (info['smem_bytes'], info['threads'], info['cluster'], info['scratch_bytes'],
                    info['hbm_bytes_per_elem']) != (
                    mirror['smem_bytes'], mirror['threads'], mirror['cluster'],
                    mirror['scratch_bytes'][fused], mirror['hbm_bytes_per_elem'][fused]):
                raise AssertionError(f"{name} n={n}: launch_info {info} against {mirror}")
            r.update({k: v for k, v in info.items() if k != 'variant'})
            if r['variant'] != 'long':
                raise AssertionError(f"{name} n={n}: runs the {r['variant']} body")
            say('long', name=name, tol=KERNEL_RTOL,
                **{k: (f"{v:.6g}" if isinstance(v, float) else
                       json.dumps(v) if isinstance(v, list) else v) for k, v in r.items()})
            out[name].append(r)
            del a
        del x, xc, w
    return out


def check_smem_mirror() -> int:
    """Every shared-memory and scratch function of the C side against its
    Python mirror (``kernels/smem.py``, ``kernels/_long.py``), for every
    power of two n from 2 to 65536, and the bytes of the launch each
    module's ``variant(n)`` picks within the opt-in limit; the count of
    values compared."""
    pen, mat, blk, lng = fft_pencil._lib(), fft_matmul._lib(), fft_block._lib(), _long.lib()
    pairs = []
    for k in range(1, 17):
        n = 1 << k
        n1, n2 = four_step_factors(n)
        for P in (1, 2, 8):
            for ld in (n, n + 1):
                pairs.append((f"stockham_smem_bytes({n}, {P}, {ld})",
                              pen.stockham_smem_bytes(n, P, ld),
                              smem_mirror.stockham_smem_bytes(n, P, ld)))
            pairs.append((f"four_step_smem_bytes({n1}, {n2}, {P})",
                          mat.four_step_smem_bytes(n1, n2, P),
                          smem_mirror.four_step_smem_bytes(n1, n2, P)))
            pairs.append((f"fft_block_slices({n1}, {n2}, {P})", blk.fft_block_slices(n1, n2, P),
                          smem_mirror.fft_block_slices(n1, n2, P)))
            for jc in (1, n1):
                pairs.append((f"fft_block_smem_bytes({n1}, {n2}, {P}, {jc})",
                              blk.fft_block_smem_bytes(n1, n2, P, jc),
                              smem_mirror.fft_block_smem_bytes(n1, n2, P, jc)))
            if n <= 4096 and P * max(n // 8, 1) <= 1024:
                for fused in (0, 1):
                    pairs.append((f"radix8_smem_bytes({n}, {P}, {fused})",
                                  pen.radix8_smem_bytes(n, P, fused),
                                  fft_pencil.radix8_smem_bytes(n, P, bool(fused))))
        for lib_, fn in ((mat, 'fft_matmul_mma_smem_bytes'), (blk, 'fft_block_mma_smem_bytes')):
            pairs.append((f"{fn}({n})", getattr(lib_, fn)(n), smem_mirror.mma_smem_bytes(n)))
        if _long.takes(n):
            for fn, py in (('long_smem_bytes', _long.smem_bytes), ('long_threads', _long.threads),
                           ('long_cluster', _long.cluster)):
                pairs.append((f"{fn}({n})", getattr(lng, fn)(n), py(n)))
            for pencils in (1, 3, LONG_ELEMS // n, (1 << 28) // n):
                for fused in (0, 1):
                    pairs.append((f"long_scratch_bytes({n}, {pencils}, {fused})",
                                  lng.long_scratch_bytes(n, pencils, fused),
                                  _long.scratch_bytes(n, pencils, bool(fused))))
        else:
            pairs.append((f"long_smem_bytes({n})", lng.long_smem_bytes(n), -1))
        for name in smem_mirror.MODULES:
            for batch in (1, 37, 512):
                body, b = smem_mirror.launch_smem_bytes(name, n, batch)
                if not 0 <= b <= smem_mirror.SMEM_LIMIT:
                    raise AssertionError(f"{name} n={n} batch={batch}: the {body} body takes "
                                         f"{b} shared bytes, over {smem_mirror.SMEM_LIMIT}")
    pairs.append(("long_transpose_smem_bytes()", lng.long_transpose_smem_bytes(),
                  _long.TRANSPOSE_SMEM_BYTES))
    for fused, twiddle in ((0, 0), (1, 0), (1, 1)):
        pairs.append((f"long_hbm_bytes({fused}, {twiddle})", lng.long_hbm_bytes(fused, twiddle),
                      _long.hbm_bytes_per_elem(bool(fused), bool(twiddle))))
    bad = [(what, c, py) for what, c, py in pairs if c != py]
    if bad:
        raise AssertionError(f"shared-byte mirrors differ from the C side: {bad[:8]}")
    return len(pairs)


def phase_long(gen, ptxas: dict) -> tuple:
    """``[long]``: :func:`kernels_long`, then the paths of
    :data:`LONG_PATHS` at full size through :func:`phase_path`, every
    launch on the long body. Returns (kernel records, the paths' launch
    counts, the long launches of each kernel module over the paths)."""
    t0 = time.perf_counter()
    say('long', check='shared-byte mirrors equal the C side', compared=check_smem_mirror())
    rec = kernels_long(gen, ptxas)
    paths, by_n = [], {}
    for label, shape, kw, method, expect, twiddled in LONG_PATHS:
        paths.append(phase_path(label, gen, method, expect, shape=shape, twiddled=twiddled,
                                long=True, by_n=by_n, **kw))
        torch.cuda.empty_cache()
    on_long = {k: sum(t[k] for t in paths) for k in paths[0]}
    for name, rs in rec.items():
        for r in rs:
            r['launches'] = by_n.get((COUNTER[name], r['n']), 0)
    say('long', paths=len(paths), launches=json.dumps(on_long),
        launches_by_n=json.dumps({f"{k}@{n}": v for (k, n), v in sorted(by_n.items())}),
        seconds=f"{time.perf_counter() - t0:.4g}")
    return rec, paths, on_long


@contextlib.contextmanager
def fuse_env(value: str):
    """``$REPRO_FUSE_SUPERSTEP`` set to ``value`` while plans build."""
    key, old = fft_pencil_mod.FUSE_ENV, os.environ.get(fft_pencil_mod.FUSE_ENV)
    os.environ[key] = value
    try:
        yield
    finally:
        if old is None:
            del os.environ[key]
        else:
            os.environ[key] = old


def _rel_l2(a, b) -> float:
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def phase_unfused(label: str, gen, expect: dict, vs_fused_rtol: float, **plan_kw) -> dict:
    """``[path] label=*_unfused``: ``pencil.make_fft(plan._pplan,
    fused=False)`` of the 512^3 plan, forward and inverse on a planar
    batch of one: ``expect`` launches a direction (every four-step
    launch on the tensor-core body, every Stockham one on the radix-8
    body), against ``torch.fft.fftn`` and the round trip (PATH_RTOL),
    and against the fused functions of the same plan (``fused=True``):
    bitwise where ``vs_fused_rtol`` is 0, else within it of the largest
    magnitude. A Stockham plan also builds one facade plan under
    ``REPRO_FUSE_SUPERSTEP=0``, whose forward must be the unfused
    function's bit for bit. Returns the unfused run's launch counts."""
    t0 = time.perf_counter()
    p = fft.plan((N, N, N), make_fft_mesh(1, 1), **plan_kw)
    fns = {f: (fft_pencil_mod.make_fft(p._pplan, fused=f)[0],
               fft_pencil_mod.make_fft(p._pplan, inverse=True, fused=f)[0])
           for f in (True, False)}
    xr, xi = planar((1, N, N, N), gen)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    y = fns[False][0](xr, xi)
    fwd = kernels.launch_counts()
    x2 = fns[False][1](*y)
    torch.cuda.synchronize()
    total = kernels.launch_counts()
    on_mma = {'fft_block': fft_block.launches_mma, 'fft_matmul': fft_matmul.launches_mma}
    on_radix8 = {'fft_fused': fft_fused.launches_radix8,
                 'fft_pencil': fft_pencil.launches_radix8}
    for k in total:
        per_dir = expect.get(k, 0)
        if fwd[k] != per_dir or total[k] != 2 * per_dir:
            raise AssertionError(f"{label}: {k} launched {fwd[k]} forward / {total[k]} in "
                                 f"all, expected {per_dir} per direction")
    for k, body in list(on_mma.items()) + list(on_radix8.items()):
        if body != total[k]:
            raise AssertionError(f"{label}: {body} of {total[k]} {k} launches on the "
                                 "hand-written body (tensor-core or radix-8)")
    yf = fns[True][0](xr, xi)
    x2f = fns[True][1](*yf)
    bitwise = all(torch.equal(a, b) for a, b in zip(y + x2, yf + x2f))
    gap = max(float((a - b).abs().max() / b.abs().max()) for a, b in zip(y + x2, yf + x2f))
    del yf, x2f
    if not (bitwise if vs_fused_rtol == 0.0 else gap <= vs_fused_rtol):
        raise AssertionError(f"{label}: unfused differs from the fused plan by {gap:.3e} of "
                             f"its largest magnitude, limit {vs_fused_rtol}")
    x = torch.complex(xr[0], xi[0])
    got = torch.complex(y[0][0], y[1][0])
    fwd_err = _rel_l2(got, torch.fft.fftn(x))
    rt_err = _rel_l2(torch.complex(x2[0][0], x2[1][0]), x)
    if not (fwd_err <= PATH_RTOL and rt_err <= PATH_RTOL):
        raise AssertionError(f"{label}: forward rel L2 {fwd_err:.3e}, round trip "
                             f"{rt_err:.3e}, limit {PATH_RTOL}")
    extra = {}
    if plan_kw.get('method') == 'stockham':
        with fuse_env('0'):
            q = fft.plan((N, N, N), make_fft_mesh(1, 1), **plan_kw)
            env_bitwise = torch.equal(q.forward(x), got)
        if not env_bitwise:
            raise AssertionError(f"{label}: the plan built under REPRO_FUSE_SUPERSTEP=0 is not "
                                 "bitwise make_fft(fused=False)")
        extra['env_plan_bitwise'] = env_bitwise
    del y, x2, got, x
    ms = time_ms(lambda: fns[False][1](*fns[False][0](xr, xi)), 5)
    ms_fused = time_ms(lambda: fns[True][1](*fns[True][0](xr, xi)), 5)
    say('path', label=label, shape=json.dumps([1, N, N, N]), method=p.method,
        fused=False, launches=json.dumps(total), launches_mma=json.dumps(on_mma),
        launches_radix8=json.dumps(on_radix8), vs_fused_bitwise=bitwise,
        vs_fused_rel=f"{gap:.3e}", vs_fused_tol=vs_fused_rtol, fwd_rel_l2=f"{fwd_err:.3e}",
        roundtrip_rel_l2=f"{rt_err:.3e}", tol=PATH_RTOL, fwd_inv_ms=f"{ms:.6g}",
        fused_fwd_inv_ms=f"{ms_fused:.6g}", **extra,
        seconds=f"{time.perf_counter() - t0:.3g}")
    return total


def check_fft3d(gen) -> dict:
    """``[path] check=fft3d``: ``pencil.fft3d``/``ifft3d`` of the default
    512^3 plan, bitwise ``make_fft``'s forward and inverse; returns the
    one-call forms' launch counts."""
    t0 = time.perf_counter()
    pp = fft.plan((N, N, N), make_fft_mesh(1, 1))._pplan
    xr, xi = planar((1, N, N, N), gen)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    y = fft_pencil_mod.fft3d(xr, xi, pp)
    x2 = fft_pencil_mod.ifft3d(*y, pp)
    torch.cuda.synchronize()
    total = kernels.launch_counts()
    fwd = fft_pencil_mod.make_fft(pp)[0](xr, xi)
    inv = fft_pencil_mod.make_fft(pp, inverse=True)[0](*y)
    bitwise = all(torch.equal(a, b) for a, b in zip(y + x2, fwd + inv))
    if not bitwise or total['fft_matmul'] != 6:
        raise AssertionError(f"fft3d: bitwise {bitwise}, launches {total} (6 fft_matmul)")
    say('path', check='fft3d', shape=json.dumps([1, N, N, N]), bitwise=bitwise,
        launches=json.dumps(total), seconds=f"{time.perf_counter() - t0:.3g}")
    return total


def check_apply_block(gen) -> dict:
    """``[path] check=apply_block``: ``methods.apply_block`` along axis 1
    of a stacked (2, 512, 512, 512) block: one ``fft_block`` launch on the
    tensor-core body, bitwise ``methods.apply(method='block')`` along the
    same axis of the planes, within PATH_RTOL of ``torch.fft.fft``."""
    t0 = time.perf_counter()
    x = torch.randn((2, N, N, N), generator=gen, device='cuda')
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    y = fft_methods.apply_block(x, axis=1)
    torch.cuda.synchronize()
    total, mma = kernels.launch_counts(), fft_block.launches_mma
    yr, yi = fft_methods.apply(x[0], x[1], axis=0, method='block')
    bitwise = torch.equal(y[0], yr) and torch.equal(y[1], yi)
    del yr, yi
    err = _rel_l2(torch.complex(y[0], y[1]), torch.fft.fft(torch.complex(x[0], x[1]), dim=0))
    want = {k: int(k == 'fft_block') for k in total}
    if not (bitwise and err <= PATH_RTOL and total == want and mma == 1):
        raise AssertionError(f"apply_block: bitwise {bitwise}, rel L2 {err:.3e}, launches "
                             f"{total} ({mma} mma)")
    say('path', check='apply_block', shape=json.dumps([2, N, N, N]), axis=1, bitwise=bitwise,
        rel_l2=f"{err:.3e}", tol=PATH_RTOL, launches=json.dumps(total), launches_mma=mma,
        seconds=f"{time.perf_counter() - t0:.3g}")
    return total


#: the solver's per-loop line: name, microseconds a step, relative error
SOLVER_LINE = re.compile(r'\s+(operator plan|real \(rfft\) plan|complex plan)\s*:\s*'
                         r'([\d.]+) us/step\s+rel err ([\d.e+-]+)')
#: the example's limit on each loop's error against the closed form
SOLVER_RTOL = 1e-3


def phase_examples() -> None:
    """``[example]``: the quickstart at 512^3 (and a rank-1 plan of 2^24)
    and the spectral solver at 512^3, 50 steps, as subprocesses."""
    t0 = time.perf_counter()
    q = _run([sys.executable, os.path.join('examples', 'torch_quickstart.py'), '--n', str(N),
              '--n1d', str(1 << 24)], 600)
    errs = [ln.strip() for ln in q.stdout.splitlines() if 'err' in ln]
    if 'quickstart OK' not in q.stdout or len(errs) != 3:
        raise AssertionError(f"quickstart: {q.stdout[-2000:]}")
    t1 = time.perf_counter()
    say('example', name='quickstart', n=N, n1d=1 << 24, lines=json.dumps(errs),
        seconds=f"{t1 - t0:.3g}")
    sv = _run([sys.executable, os.path.join('examples', 'torch_spectral_solver.py'), '--n',
               str(N), '--steps', '50'], 600)
    loops = {m.group(1): (float(m.group(2)), float(m.group(3)))
             for m in SOLVER_LINE.finditer(sv.stdout)}
    if (len(loops) != 3 or any(e > SOLVER_RTOL for _, e in loops.values())
            or '(baked x1)' not in sv.stdout or 'spectral_solver OK' not in sv.stdout):
        raise AssertionError(f"spectral_solver: {sv.stdout[-2000:]}")
    say('example', name='spectral_solver', n=N, steps=50,
        us_per_step=json.dumps({k: v[0] for k, v in loops.items()}),
        rel_err=json.dumps({k: v[1] for k, v in loops.items()}), tol=SOLVER_RTOL,
        bake_count=1, seconds=f"{time.perf_counter() - t1:.3g}")


#: lines each analytic paper script must print verbatim: the reference's
#: values of the paper's headline claims (959 us, 18.9 and 32.7 TF/s, 18%
#: over the DGX, the 1024^3 estimates, 0.8 PB/s, the communication share)
PAPER_LINES = {
    'table1': ('table1/512_fp32_us,959.260,paper=959us',
               'table1/512_fp32_tflops,0.000,derived=18.89 paper=18.9',
               'table1/512_fp16_tflops,0.000,derived=32.70 paper=32.7'),
    'table2': ('# claim: wsFFT 512^3 fp32 18.9 TF/s vs DGX 16.0 TF/s -> 18% faster '
               '(paper: 18%)',),
    'fig4': ('# comm share at 512 fp32: 0.82 (paper: transposes dominate, up to 80%)',
             '# fp32/fp16 comm ratio at 512: 1.78 (paper: 1.8x)'),
    'fig567': ('1024^3,512x512,2,fp16,36.01,yes', '1024^3,512x512,2,fp32,20.74,yes',
               '# 512 fp32: 0.76 PB/s (paper: 0.8)'),
}
#: ``torch_paper_fig3.py``'s batch here: 32,768 pencils fill the card
FIG3_BATCH = 32768


def _script_lines(name: str, argv=(), own_process: bool = False) -> list:
    """The lines ``benchmarks/<name>.py`` prints, run in this process or,
    with ``own_process``, in a process of its own (``_run``: a non-zero
    exit raises)."""
    import io
    path = os.path.join(ROOT, 'benchmarks', f'{name}.py')
    if own_process:
        return _run([sys.executable, path, *argv], timeout=300).stdout.splitlines()
    old = sys.argv
    sys.argv = [path, *argv]
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            runpy.run_path(path, run_name='__main__')
    finally:
        sys.argv = old
    return buf.getvalue().splitlines()


def phase_paper(card: str) -> None:
    """``[paper]``: the analytic scripts' headline lines, then fig3's
    part (b) on the card."""
    t0 = time.perf_counter()
    for name, want in PAPER_LINES.items():
        lines = _script_lines(f'torch_paper_{name}')
        missing = [w for w in want if w not in lines]
        if missing:
            raise AssertionError(f"torch_paper_{name}: missing {missing}")
        say('paper', script=f'torch_paper_{name}', lines=len(lines),
            headline=json.dumps(list(want)))
    lines = _script_lines('torch_paper_fig3', ['--batch', str(FIG3_BATCH)])
    rates = {m.group(1): float(m.group(2)) for m in
             (re.fullmatch(r'fig3/(pencil_\w+_n\d+),[\d.]+,gflops=([\d.]+)', ln)
              for ln in lines) if m}
    if len(rates) != 6:
        raise AssertionError(f"torch_paper_fig3: {lines[-8:]}")
    say('paper', script='torch_paper_fig3', batch=FIG3_BATCH, gflops=json.dumps(rates),
        card=json.dumps(card), seconds=f"{time.perf_counter() - t0:.3g}")


#: the card benchmarks ``[bench]`` runs at their CI size
BENCH_SCRIPTS = ('torch_bench_kernels', 'torch_bench_serve_fft', 'torch_bench_serve_service')


def phase_bench() -> None:
    """``[bench]``: each card benchmark's ``--smoke --device cuda`` in a
    process of its own, the three at once (their smoke runs assert no
    time), their records in a temporary directory: its rows written,
    every served result bitwise its per-request call, and the line of
    its seconds."""
    import tempfile
    from concurrent.futures import ThreadPoolExecutor
    t0 = time.perf_counter()

    def run(name: str, tmp: str) -> tuple:
        t = time.perf_counter()
        out = os.path.join(tmp, f'{name}.json')
        argv = ['--smoke', '--device', 'cuda', '--out', out]
        if name != 'torch_bench_kernels':
            argv += ['--schedule-out', os.path.join(tmp, f'{name}_schedule.json')]
        return out, _script_lines(name, argv, own_process=True), time.perf_counter() - t

    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(len(BENCH_SCRIPTS)) as ex:
        runs = [ex.submit(run, name, tmp) for name in BENCH_SCRIPTS]
        for name, fut in zip(BENCH_SCRIPTS, runs):
            out, lines, seconds = fut.result()
            with open(out) as fh:
                rows = json.load(fh)['results']
            if not rows or not all(r.get('bit_identical', True) for r in rows):
                raise AssertionError(f"{name}: {lines[-6:]}")
            csv = [ln for ln in lines if re.fullmatch(r'[\w/.*:-]+,(nan|[\d.]+),.*', ln)]
            say('bench', script=name, rows=len(rows), csv_lines=len(csv),
                first=json.dumps(csv[0] if csv else None), seconds=f"{seconds:.3g}")
    say('bench', seconds=f"{time.perf_counter() - t0:.3g}")


def spectral_factor(kx, ky, kz, c, nu, dt):
    """exp((nu*lap + i*adv)*dt) on the given wavenumber grid: the
    integrating factor of ``examples/spectral_solver.py``, on tensors."""
    lap = -(kx ** 2 + ky ** 2 + kz ** 2)
    adv = -(c[0] * kx + c[1] * ky + c[2] * kz)
    g = torch.exp(nu * lap * dt)
    return torch.complex(g * torch.cos(adv * dt), g * torch.sin(adv * dt)).to(torch.complex64)


def greens(n: int) -> torch.Tensor:
    """The solver's step factor in ``np.fft.rfftn`` order, (n, n, n//2 + 1),
    with the example's velocity, viscosity and time step."""
    k = torch.fft.fftfreq(n, d=1.0 / n, dtype=torch.float64, device='cuda')
    kh = torch.fft.rfftfreq(n, d=1.0 / n, dtype=torch.float64, device='cuda')
    return spectral_factor(k[:, None, None], k[None, :, None], kh[None, None, :],
                           (1.0, -0.5, 0.25), 0.02, 0.01)


def op_path(label: str, op, operands: tuple, library_fn, unfused_fn,
            per_apply: int, bake: int, dims: tuple) -> dict:
    """One operator path: ``op.apply(*operands)`` once with the launch
    counts set to 0 (the bake and the first apply), then twice more; the
    result against the ``torch.fft`` composition ``library_fn()``
    (relative L2 over ``dims``, the largest of a batch) and bitwise
    against ``unfused_fn()``; ``per_apply``
    ``fft_matmul`` launches an apply, ``bake`` more in the first, all on
    the tensor-core body, and the bake once. Returns the first apply's
    launch counts."""
    if (op.method, op.comm, op.overlap_chunks, op.resolved_kernel) != (
            'four_step', 'all_to_all', 1, 'pallas'):
        raise AssertionError(f"{label}: resolved to {op.method}/{op.comm}/"
                             f"{op.overlap_chunks}/{op.resolved_kernel}")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    y = op.apply(*operands)
    torch.cuda.synchronize()
    first = kernels.launch_counts()
    first_mma = fft_matmul.launches_mma
    peak_gib = (torch.cuda.max_memory_allocated() - base) / 2**30
    kernels.reset_launch_counts()
    for _ in range(2):
        again = op.apply(*operands)
    torch.cuda.synchronize()
    steady = {k: v // 2 for k, v in kernels.launch_counts().items()}
    want = {k: 0 for k in steady}
    want['fft_matmul'] = per_apply
    if steady != want or first != dict(want, fft_matmul=per_apply + bake):
        raise AssertionError(f"{label}: launches {first} in the first apply, {steady} an "
                             f"apply after it; expected {per_apply} fft_matmul an apply and "
                             f"{bake} more to bake")
    if first_mma != first['fft_matmul'] or fft_matmul.launches_mma != 2 * per_apply:
        raise AssertionError(f"{label}: fft_matmul launches not all on the tensor-core body")
    if op.bake_count != 1 or not torch.equal(again, y):
        raise AssertionError(f"{label}: bake_count {op.bake_count} after three applies, "
                             f"repeat equal {torch.equal(again, y)}")
    del again
    ref = library_fn()
    lead = y.shape[:len(y.shape) - len(dims)]
    a, b = (t.reshape(math.prod(lead), -1) for t in (y, ref))
    err = float((torch.linalg.vector_norm(a - b, dim=-1)
                 / torch.linalg.vector_norm(b, dim=-1)).max())
    del ref, a, b
    unfused = unfused_fn()
    same = torch.equal(y, unfused)
    del unfused
    if not (err <= PATH_RTOL and same):
        raise AssertionError(f"{label}: rel L2 {err:.3e} (limit {PATH_RTOL}) against the "
                             f"library, bitwise equal to the unfused composition: {same}")
    del y
    apply_ms = time_ms(lambda: op.apply(*operands), 5)
    unfused_ms = time_ms(unfused_fn, 5)
    library_ms = time_ms(library_fn, 5)
    say('op', label=label, shape=json.dumps(list(operands[0].shape)), method=op.method,
        comm=op.comm, chunks=op.overlap_chunks, kernel=op.resolved_kernel,
        rel_l2_vs_library=f"{err:.3e}", tol=PATH_RTOL, bitwise_vs_unfused=same,
        bake_count=op.bake_count, launches=json.dumps(first),
        launches_per_apply=json.dumps(steady), peak_gib_over_operand=f"{peak_gib:.4g}",
        apply_ms=f"{apply_ms:.6g}", unfused_ms=f"{unfused_ms:.6g}",
        library_ms=f"{library_ms:.6g}")
    say('profile', label=label, **profile(lambda: op.apply(*operands)))
    return first


def phase_op(gen) -> list:
    """The fused spectral-operator plans through ``fft.plan_op`` on one
    card, then the ``compute_dtype`` rule on the kernel tier; returns
    each path's launch counts."""
    mesh = make_fft_mesh(1, 1)
    shape = (N, N, N)
    dims = (-3, -2, -1)
    out = []

    # the spectral solver's step: rfft -> Green's function -> irfft. The
    # factor's Nyquist planes are not Hermitian, so the port's c2r and
    # cuFFT's may read them differently; at 512 it damps them by exp(-13)
    g = greens(N)
    op = fft.plan_op(shape, mesh, op=fft.spectral_mul, op_name='greens', real=True,
                     spectra=(g,), spectra_form='spectrum')
    x = torch.randn(shape, generator=gen, device='cuda')
    rp = fft.rplan(shape, mesh, padded_spectrum=True)

    def solver_unfused():
        s = rp.forward(x)
        return rp.inverse(torch.complex(*fft.spectral_mul(s.real, s.imag, (g.real, g.imag))))
    out.append(op_path('op_solver', op, (x,),
                       lambda: torch.fft.irfftn(torch.fft.rfftn(x) * g, s=shape),
                       solver_unfused, per_apply=6, bake=0, dims=dims))
    del op, x, g, rp

    # a complex operator with one runtime factor (the training-time path)
    op = fft.plan_op(shape, mesh, op=fft.spectral_mul, real=False, n_spectra=1)
    x, k = (torch.complex(*planar(shape, gen)) for _ in range(2))
    p = fft.plan(shape, mesh)

    def conv_unfused():
        s, sk = p.forward(x), p.forward(k)
        return p.inverse(torch.complex(*fft.spectral_mul(s.real, s.imag, (sk.real, sk.imag))))

    def conv_library():
        return torch.fft.ifftn(torch.fft.fftn(x) * torch.fft.fftn(k))
    out.append(op_path('op_conv', op, (x, k), conv_library, conv_unfused,
                       per_apply=9, bake=0, dims=dims))
    del op, x, k, p

    # the FFT-convolution mixer at full length: 8 signals, one baked kernel
    n = LARGE1D[0]
    kern = torch.randn(LARGE1D, generator=gen, device='cuda')
    op = fft.plan_op(LARGE1D, mesh, op=fft.spectral_mul, real=True, spectra=(kern,))
    x = torch.randn(LARGE1D_BATCH + LARGE1D, generator=gen, device='cuda')
    rp = fft.rplan(LARGE1D, mesh)
    kf, sk = torch.fft.rfft(kern), rp.forward(kern)   # the baked spectra, once

    def conv1d_unfused():
        s = rp.forward(x)
        return rp.inverse(torch.complex(*fft.spectral_mul(s.real, s.imag, (sk.real, sk.imag))))
    out.append(op_path('op_fftconv1d', op, (x,),
                       lambda: torch.fft.irfft(torch.fft.rfft(x) * kf, n=n), conv1d_unfused,
                       per_apply=4, bake=2, dims=(-1,)))
    del op, x, rp, kf, sk

    # compute_dtype: the tensor-core bodies take fp32 only; the plain
    # versions round their products' operands
    try:
        fft.plan(shape, mesh, compute_dtype=torch.bfloat16)
    except ValueError as e:
        refused = str(e).split(';')[0]
    else:
        raise AssertionError("compute_dtype=bfloat16 planned on the kernel tier")
    m = 64
    xb = torch.complex(*planar((m, m, m), gen))
    pb = fft.plan((m, m, m), mesh, compute_dtype=torch.bfloat16, kernel='reference')
    yb, ref = pb.forward(xb), torch.fft.fftn(xb)
    bf16_err = float(torch.linalg.vector_norm(yb - ref) / torch.linalg.vector_norm(ref))
    if not bf16_err > 1e-4:
        raise AssertionError(f"compute_dtype=bfloat16 on the reference tier: rel L2 "
                             f"{bf16_err:.3e} from torch.fft.fftn, no sign of the cast")
    say('op', label='compute_dtype', kernel_tier=repr(refused), reference_tier_shape=m,
        method=pb.method, bf16_rel_l2_vs_fftn=f"{bf16_err:.3e}")
    return out


#: the serving phase's stream: (kind, transform shape, requests, op)
SERVE_KINDS = (('complex', (N, N, N), 8, None), ('real', (N, N, N), 4, None),
               ('complex_256', (N // 2,) * 3, 4, None), ('op_solver', (N, N, N), 4, 'op_solver'))
SERVE_COALESCE = 4


def _serve_stream(eng, xs, op=None, wait=False):
    """Submit ``xs``, run them (``flush()``, or the drainer when
    ``wait``), read every result; returns the results and the wall time
    a request in microseconds, the card synchronized at both ends."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tickets = [eng.submit(x, op=op) for x in xs]
    if not wait:
        eng.flush()
    ys = [t.result(timeout=600) for t in tickets]
    torch.cuda.synchronize()
    return ys, (time.perf_counter() - t0) / len(xs) * 1e6


def _median3(fn) -> float:
    times = sorted(fn() for _ in range(3))
    return times[1]


def _serve_kind(label, eng, xs, one, op=None, model=None, modules=('fft_matmul',)):
    """One kind through ``eng``: its launches a group (counts set to 0
    just before, read just after; every launch on the tensor-core or
    radix-8 body), each result bitwise against ``one(x)``, the per-request
    call, and the engine's and the sequential calls' time a request;
    prints the ``[serve]`` line and returns the launch counts."""
    w, c = eng.schedule(op=op) if op else eng.schedule(not xs[0].is_complex(),
                                                      shape=tuple(xs[0].shape))
    groups = -(-len(xs) // w)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    ys, _ = _serve_stream(eng, xs, op)
    counts = kernels.launch_counts()
    body = {'fft_matmul': fft_matmul.launches_mma, 'fft_block': fft_block.launches_mma,
            'fft_pencil': fft_pencil.launches_radix8, 'fft_fused': fft_fused.launches_radix8}
    peak = torch.cuda.max_memory_allocated()
    for k, v in counts.items():
        if body[k] != v or (v and k not in modules) or v % groups:
            raise AssertionError(f"serve {label}: {k} launched {v} times ({body[k]} on the "
                                 f"hand-written body) in {groups} groups")
    bitwise = all(torch.equal(y, one(x)) for x, y in zip(xs, ys))
    if not bitwise:
        raise AssertionError(f"serve {label}: a coalesced result differs from its "
                             "per-request call")
    del ys
    us = _median3(lambda: _serve_stream(eng, xs, op)[1])

    def sequential():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for x in xs:
            one(x)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / len(xs) * 1e6
    seq = _median3(sequential)
    say('serve', label=label, shape=json.dumps(list(xs[0].shape)), requests=len(xs),
        width=w, chunks=c, model_pick_capped_uncapped=json.dumps(model), groups=groups,
        us_per_request=f"{us:.6g}", sequential_us_per_request=f"{seq:.6g}",
        bitwise_vs_per_request=bitwise,
        launches_per_group=json.dumps({k: v // groups for k, v in counts.items() if v}),
        peak_gib=f"{peak / 2**30:.4g}", base_gib=f"{base / 2**30:.4g}")
    return counts


def phase_serve(gen) -> list:
    """The FFT serving engine on one card (``[serve]`` lines): a mixed
    stream (8 complex and 4 real 512^3 requests, 4 complex 256^3 and 4
    ``op_solver`` requests through ``register_op``) on one engine with
    ``max_coalesce=4``, every kind set to groups of 4 (the model's pick,
    printed beside, is 1 on one rank): once with ``flush()`` and once
    with the drainer on (``max_wait_ms=2``, read by ``result()``), every
    result bitwise equal to its per-request call; each kind alone, timed
    beside its per-request calls; a ``method='stockham'`` engine on 4
    complex 256^3 requests; ``autotune`` at 512^3 into a temporary
    schedule table, which a fresh engine must then pick. Returns the
    launch counts of the mixed stream and of the Stockham engine."""
    import tempfile
    from repro_torch.serve import FFTEngine
    mesh = make_fft_mesh(1, 1)
    g = greens(N)
    op_plan = fft.plan_op((N, N, N), mesh, op=fft.spectral_mul, op_name='greens', real=True,
                          spectra=(g,), spectra_form='spectrum')
    reqs = {}
    for kind, shape, n, _ in SERVE_KINDS:
        real = kind in ('real', 'op_solver')
        reqs[kind] = [torch.randn(shape, generator=gen, device='cuda') if real
                      else torch.complex(*planar(shape, gen)) for _ in range(n)]
    # the model's picks, capped and not (16 requests of 512^3 with their
    # temporaries would pass the card's memory): on one rank it prices no
    # swap, so batching gains it nothing and it keeps one request a group
    model = {}
    for cap in (SERVE_COALESCE, 16):
        e = FFTEngine(mesh=mesh, max_coalesce=cap, schedule_table=None)
        e.register_op('op_solver', op_plan)
        model[cap] = {kind: list(e.schedule(op=o) if o else e.schedule(
            kind == 'real', shape=shape)) for kind, shape, _, o in SERVE_KINDS}

    def serving(**kw):
        """An engine of the phase: every kind coalesced SERVE_COALESCE
        wide, one chunk, whatever the model picked."""
        e = FFTEngine(mesh=mesh, max_coalesce=SERVE_COALESCE, schedule_table=None, **kw)
        op = e.register_op('op_solver', op_plan)
        for kind, shape, _, o in SERVE_KINDS:
            e.set_schedule(SERVE_COALESCE, 1, op=o, **({} if o else dict(
                real=kind == 'real', shape=shape)))
        return e, op
    eng, op = serving()

    def one(kind):
        if kind == 'op_solver':
            return op.apply
        p = eng.plan_for(kind == 'real', shape=tuple(reqs[kind][0].shape))
        return p.forward

    # the kinds interleaved, request by request
    mixed = [(reqs[kind][j], o) for j in range(max(n for _, _, n, _ in SERVE_KINDS))
             for kind, _, n, o in SERVE_KINDS if j < n]
    out = []
    for label, engine, wait in (('mixed', eng, False),
                                ('mixed_drainer', serving(max_wait_ms=2.0)[0], True)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        tickets = [engine.submit(x, op=o) for x, o in mixed]
        if not wait:
            engine.flush()
        ys = [t.result(timeout=600) for t in tickets]
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) / len(mixed) * 1e6
        counts = kernels.launch_counts()
        on_mma = fft_matmul.launches_mma
        peak = torch.cuda.max_memory_allocated()
        refs = {id(x): (op.apply if o else eng.plan_for(not x.is_complex(),
                                                          shape=tuple(x.shape)).forward)
                for x, o in mixed}
        bitwise = all(torch.equal(y, refs[id(x)](x)) for (x, _), y in zip(mixed, ys))
        del ys
        if not bitwise or on_mma != counts['fft_matmul'] or any(
                v for k, v in counts.items() if k != 'fft_matmul'):
            raise AssertionError(f"serve {label}: bitwise {bitwise}, launches {counts}, "
                                 f"{on_mma} on the tensor-core body")
        say('serve', label=label, requests=len(mixed), kinds=len(SERVE_KINDS),
            us_per_request=f"{wall_us:.6g}", bitwise_vs_per_request=bitwise,
            groups=engine.dispatch_stats()['groups'],
            width_hist=json.dumps(engine.dispatch_stats()['width_hist']),
            launches=json.dumps(counts), peak_gib=f"{peak / 2**30:.4g}")
        if wait:
            engine.close()
        else:
            out.append(counts)
    for kind, _, _, o in SERVE_KINDS:
        _serve_kind(kind, eng, reqs[kind], one(kind), op=o,
                    model=[model[SERVE_COALESCE][kind], model[16][kind]])
    del reqs, mixed, op, op_plan, eng

    # Stockham: fft_pencil and fft_twiddle_transpose under the engine
    st = FFTEngine(mesh=mesh, max_coalesce=SERVE_COALESCE, method='stockham',
                   schedule_table=None)
    xs = [torch.complex(*planar((N // 2,) * 3, gen)) for _ in range(4)]
    model = list(st.schedule(False, shape=(N // 2,) * 3))
    st.set_schedule(SERVE_COALESCE, 1, shape=(N // 2,) * 3)
    p = st.plan_for(False, shape=(N // 2,) * 3)
    if p.method != 'stockham' or p.resolved_kernel != 'pallas':
        raise AssertionError(f"serve stockham: planned {p.method}/{p.resolved_kernel}")
    out.append(_serve_kind('stockham_256', st, xs, p.forward, model=[model],
                           modules=('fft_pencil', 'fft_fused')))
    del xs, st

    # autotune at 512^3 into a temporary table; a fresh engine picks its row
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, 'BENCH_torch_serve_schedule.json')
        old = os.environ.get(costlib.SCHEDULE_ENV)
        os.environ[costlib.SCHEDULE_ENV] = path
        try:
            tuner = FFTEngine((N, N, N), mesh, max_coalesce=SERVE_COALESCE)
            sample = [torch.complex(*planar((N, N, N), gen)) for _ in range(SERVE_COALESCE)]
            t0 = time.perf_counter()
            w, c = tuner.autotune(sample, repeats=1, widths=(1, 2, 4), chunks=(1, 2),
                                  persist=True)
            tune_s = time.perf_counter() - t0
            row = costlib.schedule_table().lookup(
                dict(mesh.shape), (N, N, N), 'complex', tuner.plan_for(False).comm,
                backend='cuda', kernel='pallas', dtype='complex64')
            fresh = FFTEngine((N, N, N), mesh, max_coalesce=SERVE_COALESCE).schedule(False)
        finally:
            if old is None:
                os.environ.pop(costlib.SCHEDULE_ENV)
            else:
                os.environ[costlib.SCHEDULE_ENV] = old
        del sample, tuner
    if fresh != (w, c) or (row['coalesce_width'], row['overlap_chunks']) != (w, c):
        raise AssertionError(f"serve autotune: tuned {(w, c)}, table row {row}, a fresh "
                             f"engine picked {fresh}")
    say('serve', label='autotune', shape=json.dumps([N] * 3), width=w, chunks=c,
        us_per_request=f"{row['us_per_request']:.6g}", fresh_engine_pick=json.dumps(fresh),
        table_row_kernel=row.get('kernel'), seconds=f"{tune_s:.3g}")
    return out


#: the service phase's traffic, in order: (kind, requests); real 512^3
#: (complex 512^3 is 2^30 bytes, over the wire's frame cap, refused typed)
SERVICE_KINDS = (('real', 4), ('inverse_planar', 4), ('solver', 4), ('complex_256', 4))
SERVICE_TENANTS = (('alice', 'standard'), ('bob', 'batch'))


def _host_split(eng, proto, x: np.ndarray) -> dict:
    """The host's share of one real 512^3 request, each step timed alone
    (ms): packing its SUBMIT frame, unpacking it, a unix socket pair's
    trip of it (send, and ``recv_frame``'s join of the payload), the
    copy to the card (``from_numpy``: the float32 copy and the pageable
    H2D) and the result's copy back (the writer's ``Tensor.cpu()``)."""
    import socket
    import threading
    from repro_torch.serve.service import _host_array
    from repro_torch.weights import from_numpy
    out = {}
    t0 = time.perf_counter()
    buf = proto.pack_frame(proto.SUBMIT, {'req_id': 1, 'direction': 'fwd'}, [x])
    out['pack_ms'] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    proto.unpack_frame(buf)
    out['unpack_ms'] = (time.perf_counter() - t0) * 1e3
    a, b = socket.socketpair()
    try:
        got = []
        reader = threading.Thread(target=lambda: got.append(proto.recv_frame(b)))
        t0 = time.perf_counter()
        reader.start()
        a.sendall(buf)
        reader.join(timeout=120)
        out['socket_ms'] = (time.perf_counter() - t0) * 1e3
        if not got or not np.array_equal(got[0][2][0], x):
            raise AssertionError("service: the socket pair did not carry the frame")
    finally:
        a.close()
        b.close()
    del buf, got
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    xt = from_numpy(x, 'cuda')
    torch.cuda.synchronize()
    out['h2d_ms'] = (time.perf_counter() - t0) * 1e3
    y = eng.plan_for(True, shape=x.shape).forward(xt)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _host_array(y)
    out['d2h_ms'] = (time.perf_counter() - t0) * 1e3
    return {k: f"{v:.6g}" for k, v in out.items()}


def phase_service(gen) -> list:
    """The multi-tenant service on one card (``[service]`` lines): one
    ``FFTService`` over a background engine (every kind set to groups of
    4, as ``[serve]`` sets them) on a unix socket, tenants ``alice``
    (standard) and ``bob`` (batch), ``ops={'solver': op_solver}``. Two
    ``FFTClient`` threads, one a tenant, each submit half of every kind:
    4 real 512^3 forwards, the 4 spectra back in planar form, 4
    ``op='solver'`` steps and 4 complex 256^3 forwards. Each kind's
    stream is checked — every result bitwise equal to its request
    through the engine's plan one at a time on the card, 3
    ``fft_matmul`` launches a group (6 an ``op_solver`` group), all on
    the tensor-core body — and timed (``stream_us_per_request``); then
    three of its requests go one at a time, submit to result at the
    client (``us_per_request``, the median). A complex 512^3 submit must
    raise ``ProtocolError`` on the client with the service still
    serving. Then the metrics (completed counts, no rejection), a
    drained ``close()``, the same requests through ``FFTEngine.submit``
    in process, the host split of one request, and the launcher's
    ``--smoke`` in a subprocess. Returns the checked streams' launch
    counts."""
    import resource
    import tempfile
    import threading
    from repro_torch.serve import FFTClient, FFTEngine, FFTService, TenantConfig
    from repro_torch.serve import protocol as proto
    from repro_torch.weights import from_numpy
    mesh = make_fft_mesh(1, 1)
    shape, shape_c = (N, N, N), (N // 2,) * 3
    g = greens(N)
    op_plan = fft.plan_op(shape, mesh, op=fft.spectral_mul, op_name='greens', real=True,
                          spectra=(g,), spectra_form='spectrum')
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    eng = FFTEngine(mesh=mesh, max_coalesce=SERVE_COALESCE, background=True,
                    schedule_table=None)
    tmp = tempfile.mkdtemp(prefix='chip_smoke_service_')
    path = os.path.join(tmp, 'fft.sock')
    svc = FFTService(engine=eng, ops={'solver': op_plan}, persist_policy=False,
                     tenants=[TenantConfig(n, slo=slo) for n, slo in SERVICE_TENANTS]).start(path)
    if eng._side is not None or svc._link is not None:
        raise AssertionError("service: a one-rank engine made a side group")
    for kw in (dict(real=True, shape=shape), dict(shape=shape_c), dict(op='solver')):
        eng.set_schedule(SERVE_COALESCE, 1, **kw)
    real_plan, cplx_plan = eng.plan_for(True, shape=shape), eng.plan_for(False, shape=shape_c)
    solver = eng.plan_for(op='solver')

    def host(shape_, complex_=False):
        x = torch.randn(shape_, generator=gen, device='cuda')
        if complex_:
            x = torch.complex(x, torch.randn(shape_, generator=gen, device='cuda'))
        return x.cpu().numpy()
    reqs = {'real': [host(shape) for _ in range(4)],
            'solver': [host(shape) for _ in range(4)],
            'complex_256': [host(shape_c, True) for _ in range(4)]}

    def one(kind, x):
        """The request through the engine's plan alone, on the host."""
        if kind == 'inverse_planar':
            y = real_plan.inverse(tuple(from_numpy(a, 'cuda') for a in x))
        else:
            fn = {'real': real_plan.forward, 'solver': solver.apply,
                  'complex_256': cplx_plan.forward}[kind]
            y = fn(from_numpy(x, 'cuda'))
        return y.cpu().numpy()

    clients = [FFTClient(path, tenant=n) for n, _ in SERVICE_TENANTS]
    sent = {n: 0 for n, _ in SERVICE_TENANTS}

    def kind_kw(kind):
        return (dict(op='solver') if kind == 'solver' else
                dict(direction='inv', real=True) if kind == 'inverse_planar' else {})

    def run(kind):
        """Each client thread submits its half of the kind's requests
        (request i goes to tenant i % 2), then reads its results; returns
        the results in request order and the wall time a request (us)."""
        xs = reqs[kind]
        results, errors = [None] * len(xs), []

        def drive(c, idx):
            try:
                tickets = [(i, c.submit(xs[i], **kind_kw(kind))) for i in idx]
                for i, t in tickets:
                    results[i] = t.result(timeout=600)
            except BaseException as exc:
                errors.append(exc)
        threads = [threading.Thread(target=drive, args=(c, range(j, len(xs), 2)))
                   for j, c in enumerate(clients)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        us = (time.perf_counter() - t0) / len(xs) * 1e6
        if errors or any(t.is_alive() for t in threads):
            raise AssertionError(f"service {kind}: client errors {errors!r}")
        for j, (n, _) in enumerate(SERVICE_TENANTS):
            sent[n] += len(range(j, len(xs), 2))
        return results, us

    # complex 512^3 is one 2^30-byte array: over the frame cap, refused on
    # the client before a byte is sent; the service keeps serving after it
    big = np.zeros(shape, np.complex64)
    try:
        clients[0].submit(big)
    except proto.ProtocolError as e:
        refused = str(e)
    else:
        raise AssertionError("service: a complex 512^3 submit was not refused")
    del big

    out, lines = [], []
    for kind, _ in SERVICE_KINDS:
        if kind == 'inverse_planar':
            reqs[kind] = [(y.real.copy(), y.imag.copy()) for y in spectra]
        refs = [one(kind, x) for x in reqs[kind]]
        torch.cuda.synchronize()
        groups0 = eng.dispatch_stats()['groups']
        kernels.reset_launch_counts()
        ys, us0 = run(kind)
        counts = kernels.launch_counts()
        groups = eng.dispatch_stats()['groups'] - groups0
        per = 6 if kind == 'solver' else 3
        if (counts['fft_matmul'] != per * groups or fft_matmul.launches_mma != counts['fft_matmul']
                or any(v for k, v in counts.items() if k != 'fft_matmul')):
            raise AssertionError(f"service {kind}: launches {counts} in {groups} groups, "
                                 f"{fft_matmul.launches_mma} on the tensor-core body")
        bitwise = all(y.dtype == r.dtype and np.array_equal(y, r) for y, r in zip(ys, refs))
        if not bitwise:
            raise AssertionError(f"service {kind}: a served result differs from its "
                                 "per-request plan call")
        if kind == 'real':
            spectra = ys
        del refs, ys

        # a request's latency at the client, submit to result, one in flight
        def latency(i):
            c = clients[i % len(clients)]
            t0 = time.perf_counter()
            c.submit(reqs[kind][i], **kind_kw(kind)).result(timeout=600)
            sent[SERVICE_TENANTS[i % len(clients)][0]] += 1
            return (time.perf_counter() - t0) * 1e6
        us = sorted(latency(i) for i in range(3))[1]
        out.append(counts)
        first = reqs[kind][0]
        lines.append(dict(label=kind, shape=json.dumps(list(np.shape(
            first[0] if isinstance(first, tuple) else first))), requests=len(reqs[kind]),
            groups=groups, launches_per_group=json.dumps({'fft_matmul': per}),
            bitwise_vs_per_request=bitwise, us_per_request=f"{us:.6g}",
            stream_us_per_request=f"{us0:.6g}"))
    del spectra

    m = clients[0].metrics()
    for n, _ in SERVICE_TENANTS:
        tm = m['tenants'][n]
        if tm['completed'] != sent[n] or tm['failed'] or tm['rejected'] or tm['inflight']:
            raise AssertionError(f"service: tenant {n} metrics {tm}, {sent[n]} sent")
    for c in clients:
        c.close()
    svc.close(drain=True)
    if svc._inflight_total or os.path.exists(path) or eng.closed:
        raise AssertionError("service: close() left requests, its socket or closed the "
                             "engine it does not own")
    os.rmdir(tmp)
    dispatch = m['service']['dispatch']

    # the same requests through the engine in process: numpy in, the
    # result finished on the card, one at a time (median of 3) and the
    # kind's 4 together; a lone request dispatches at once (watermark 1),
    # whatever the service's policy left
    eng.set_drainer(watermark=1, max_wait_ms=2.0)

    def engine_us(kind, xs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in [eng.submit(x, **kind_kw(kind)) for x in xs]:
            t.result(timeout=600)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / len(xs) * 1e6
    for line in lines:
        xs = reqs[line['label']]
        line['engine_us_per_request'] = "%.6g" % sorted(
            engine_us(line['label'], [x]) for x in xs[:3])[1]
        line['engine_stream_us_per_request'] = f"{engine_us(line['label'], xs):.6g}"
    split = _host_split(eng, proto, reqs['real'][0])
    eng.close()
    peak = torch.cuda.max_memory_allocated() / 2**30
    peak_host = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
    for line in lines:
        say('service', **line)
    say('service', label='host_split', shape=json.dumps(list(shape)), **split)
    say('service', label='summary', refused_complex_512=json.dumps(refused[:60]),
        tenants=json.dumps({n: m['tenants'][n]['completed'] for n, _ in SERVICE_TENANTS}),
        rejected=0, groups=dispatch['groups'], width_hist=json.dumps(dispatch['width_hist']),
        policy=json.dumps(m['service']['policy']), peak_gib=f"{peak:.4g}",
        peak_host_gib=f"{peak_host:.4g}", side_groups=len(mesh._side_groups))
    del reqs

    # the launcher's CI smoke, on the card, in its own process
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, 'src'))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, '-m', 'repro_torch.launch.fft_service', '--smoke'],
                          capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)
    if proc.returncode != 0 or 'fft_service smoke OK' not in proc.stdout:
        raise AssertionError(f"service: the launcher's --smoke exited {proc.returncode}: "
                             f"{proc.stdout[-2000:]} {proc.stderr[-2000:]}")
    say('service', label='launcher_smoke', rc=proc.returncode,
        seconds=f"{time.perf_counter() - t0:.3g}")
    return out


def phase_grad() -> None:
    """Every CUDA kernel refuses an operand that requires grad (the
    reference's ``pallas_call`` has no backward either); the plain
    versions differentiate."""
    x = torch.randn((4, 64), device='cuda', requires_grad=True)
    y = torch.randn((4, 64), device='cuda')
    calls = {'fft_matmul': lambda: fft_matmul.fft_matmul(x, y),
             'fft_pencil': lambda: fft_pencil.fft_pencil(x, y),
             'fft_twiddle_transpose': lambda: fft_fused.fft_twiddle_transpose(x, y),
             'fft_block': lambda: fft_block.fft_block_planar(x, y)}
    kernels.reset_launch_counts()
    refused = []
    for name, call in calls.items():
        try:
            call()
        except RuntimeError as e:
            if 'no backward' in str(e):
                refused.append(name)
    if refused != list(calls) or any(kernels.launch_counts().values()):
        raise AssertionError(f"grad: refused by {refused}, launched "
                             f"{kernels.launch_counts()}")
    g, = torch.autograd.grad(fft_matmul.fft_matmul_plain(x, y)[0].sum(), x)
    say('grad', refused=json.dumps(refused), plain_grad_finite=bool(torch.isfinite(g).all()))


#: the language-model server (``[lm]``): each config at its published
#: widths, (prompts, tokens a prompt) and 64 new tokens each.
#: recurrentgemma-9b's prompts are twice its 2048-token window, so
#: prefill's window mask and the ring fold run and decode writes across
#: the ring; qwen2-vl-2b's are embeddings with three distinct position
#: streams (``lm_prompt``); qwen1.5-32b serves 2 prompts (its bf16
#: weights take 65.6 GiB)
LM_SHAPES = {'internlm2-1.8b': (8, 2048), 'mamba2-1.3b': (8, 2048),
             'recurrentgemma-9b': (4, 4096), 'qwen2-vl-2b': (8, 2048),
             'codeqwen1.5-7b': (8, 2048), 'granite-3-8b': (8, 2048),
             'qwen1.5-32b': (2, 2048), 'dbrx-132b': (8, 2048),
             'deepseek-v2-236b': (8, 2048)}
LM_ARCHS = tuple(LM_SHAPES)
LM_GEN = 64
#: the depth cut of the configs whose published depth fits no card (40
#: and 60 layers: 526 and 957 GB in fp32); the widths stay published
LM_LAYERS = {'dbrx-132b': 4, 'deepseek-v2-236b': 3}
#: the parameter dtype where it is not fp32: qwen1.5-32b's 131 GiB in fp32
#: do not fit one card
LM_DTYPE = {'qwen1.5-32b': torch.bfloat16}
#: the card against itself (two rows: the full-vocabulary logits of the
#: forward over 2112 tokens are 1.56 GB a row for internlm2): the
#: reference's serve contract (tests/test_serve.py), prefill and decode
#: against the full forward, atol = rtol; generated tokens equal to the
#: forward's argmax where its top-2 margin exceeds LM_MARGIN
LM_ROWS, LM_PREFILL_TOL, LM_DECODE_TOL, LM_MARGIN = 2, 2e-3, 3e-3, 1e-3
#: a bf16 config (qwen1.5-32b, no fp32 twin on one card) against its own
#: bf16 forward: every step's logits within relative L2 LM_BF16_REL and
#: max abs LM_BF16_ATOL (logits of about unit spread; products round to
#: bf16, 8 bits, and prefill, decode and the forward round in other
#: orders through 64 layers: 64 layers at d = 512 on the CPU read 2e-2
#: and 0.10), the generated tokens equal to the forward's argmax where
#: its top-2 margin exceeds twice LM_BF16_ATOL; the card against the CPU
#: within LM_BF16_REL
LM_BF16_REL, LM_BF16_ATOL = 5e-2, 0.25
#: the card against the CPU, the same weights: a 16-token prompt and 4
#: teacher-forced decode steps, logits relative L2 (fp32 products at full
#: precision on both; sums in another order through 24 to 48 layers).
#: Weights past LM_CPU_MAX_BYTES (recurrentgemma-9b, codeqwen1.5-7b,
#: granite-3-8b, qwen1.5-32b, dbrx-132b, deepseek-v2-236b: 30 to 66 GiB,
#: whose copy to the host and CPU forward would take most of a row's
#: time) run as a view of their first whole periods of at least
#: LM_CPU_LAYERS layers (the stacked leaves' first slices): every block
#: kind of the model, fewer repeats of it
LM_CPU_PROMPT, LM_CPU_STEPS, LM_CPU_REL = 16, 4, 1e-4
LM_CPU_MAX_BYTES, LM_CPU_LAYERS = 16 * 2**30, 2
#: an MoE config's self-check runs at a capacity factor at which no
#: (token, expert) pair drops in its prefill or its forward (a drop
#: depends on the sequence's length): from the published factor up, each
#: try raised to cover the largest expert load the last one routed
LM_NO_DROP_TRIES = 4
#: the card's dense bf16 rate (tensor cores, no sparsity), the prefill
#: bound of a bf16 config
BF16_FLOP_PER_S = 989e12
#: the encoder (hubert-xlarge, encoder-only: no decode): a forward over
#: 8 x 2048 frame embeddings at full width; the card against the CPU at
#: smoke size, logits relative L2
ENCODE_ARCH, ENCODE_BATCH, ENCODE_SEQ, ENCODE_CPU_REL = 'hubert-xlarge', 8, 2048, 1e-5


def mrope_grid(B: int, S: int, g: int, device='cuda') -> torch.Tensor:
    """M-RoPE's (3, B, S) int32 positions for a g x g patch grid then
    text: the grid's t fixed at 0, h its row, w its column; the text from
    g on, equal in all three streams (Qwen2-VL's layout)."""
    n = g * g
    r = torch.arange(n, device=device)
    img = torch.stack([torch.zeros_like(r), r // g, r % g])
    text = (g + torch.arange(S - n, device=device))[None].expand(3, S - n)
    return torch.cat([img, text], dim=1)[:, None].expand(3, B, S).to(torch.int32).contiguous()


def lm_prompt(cfg, batch: int, seq: int, seed: int, device='cuda') -> dict:
    """The prompt batch ``make_batch`` draws (tokens, or embeddings in
    embeds mode), M-RoPE's streams a patch grid of side isqrt(seq / 2)
    then text."""
    out = make_batch(cfg, batch=batch, seq=seq, seed=seed, device=device)
    del out['labels']
    if 'positions' in out:
        out['positions'] = mrope_grid(batch, seq, math.isqrt(seq // 2), device)
    return out


def _continue_in_text(params, cfg, prompt: dict, toks, rows: int) -> dict:
    """The full forward's batch over ``rows`` rows of a prompt and the
    tokens decoded after it (in embeds mode their table rows, their
    positions text: the cache length in all three streams)."""
    if 'tokens' in prompt:
        return {'tokens': torch.cat([prompt['tokens'][:rows], toks[:rows]], dim=1)}
    out = {'embeds': torch.cat([prompt['embeds'][:rows],
                                lm_layers.embed_lookup(params['embed'], toks[:rows])], dim=1)}
    if 'positions' in prompt:
        S, n = prompt['embeds'].shape[1], toks.shape[1]
        text = torch.arange(S, S + n, dtype=torch.int32, device=toks.device)
        out['positions'] = torch.cat([prompt['positions'][:, :rows],
                                      text[None, None].expand(3, rows, n)], dim=2)
    return out


def _lm_generate(eng, batch, rows: int):
    """``ServeEngine.generate`` step by step under CUDA events: (tokens,
    prefill ms, decode ms a token, wall s, rows' logits of every step)."""
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    t0 = time.perf_counter()
    ev[0].record()
    logits, caches = eng.prefill(batch)
    ev[1].record()
    tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
    out, kept = [tok], [logits[:rows, -1]]
    for pos in range(eng.prompt_len, eng.prompt_len + LM_GEN - 1):
        logits, caches = eng.decode(caches, tok, pos)
        tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
        out.append(tok)
        kept.append(logits[:rows, -1])
    ev[2].record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return (torch.cat(out, dim=1), ev[0].elapsed_time(ev[1]),
            ev[1].elapsed_time(ev[2]) / (LM_GEN - 1), wall, torch.stack(kept, dim=1), caches)


def _expert_weights(tree, keys=()) -> int:
    """The elements of the routed experts' weights (``moe/wi``,
    ``moe/wo``; the shared experts are dense) in a parameter tree."""
    if isinstance(tree, dict):
        return sum(_expert_weights(v, keys + (k,)) for k, v in tree.items())
    routed = 'moe' in keys and 'shared' not in keys and keys[-1] in ('wi', 'wo')
    return tree.numel() if routed else 0


def _lm_bounds(cfg, params, B: int, S: int) -> dict:
    """The least times the card could take. Prefill: its linear-layer
    products, 2 flop a weight a token (the embedding table and an untied
    head excluded: the logits are the last token's only; a routed
    expert's weights count top_k / E of them, the capacity's padding
    none) over the fp32 rate (bf16: the dense bf16 rate). A decode step:
    the larger of its bytes (every weight it reads once: all but an
    untied model's table, of which it reads B rows, and of the routed
    experts the min(E, B top_k) that B tokens can pick; the caches: the
    dense KV, MLA's latent and roped key, the ring, the SSM and RG-LRU
    states) over the HBM rate, and its operations (2 flop a weight a
    token it multiplies; MLA's decompression of the prompt's latents
    through ``wkv_b`` and attention over them, dense attention's over
    the prompt's keys) over the same flop rate."""
    n = sum(t.numel() for t in tree_leaves(params))
    item = next(iter(tree_leaves(params))).element_size()
    rate = BF16_FLOP_PER_S if item == 2 else FP32_FLOP_PER_S
    table = cfg.vocab_size * cfg.d_model
    head = 0 if cfg.tie_embeddings else table
    experts = _expert_weights(params)
    active = n - table - head - experts + experts * cfg.top_k // max(cfg.num_experts, 1)
    flops = 2.0 * active * B * S
    read = n - (table if head else 0) - experts
    if experts:
        read += experts * min(cfg.num_experts, B * cfg.top_k) // cfg.num_experts
    cache, step_flops = 0, 2.0 * (active + table) * B      # the head: tied or not
    H = cfg.num_heads
    for j in range(cfg.num_layers):
        kind = cfg.block_pattern[j % len(cfg.block_pattern)]
        if kind == 'attn':
            cache += 2 * B * (S + LM_GEN) * cfg.num_kv_heads * cfg.head_dim * item
            step_flops += 4.0 * B * S * H * cfg.head_dim
        elif kind == 'mla':
            cache += B * (S + LM_GEN) * (cfg.kv_lora_rank + cfg.rope_head_dim) * item
            nh, rh, vh = cfg.qk_nope_dim, cfg.rope_head_dim, cfg.v_head_dim
            step_flops += 2.0 * B * S * (cfg.kv_lora_rank * H * (nh + vh) + H * (nh + rh + vh))
        elif kind == 'local_attn':
            cache += 2 * B * min(cfg.window, S + LM_GEN) * cfg.num_kv_heads * cfg.head_dim * item
        elif kind == 'rglru':
            cache += B * cfg.conv_width * cfg.lru_width * item
        else:
            di, Hs, P, Nst = lm_ssd.ssd_dims(cfg)
            cache += B * Hs * Nst * P * 4
    t_bytes = (item * read + cache) / HBM_BYTES_PER_S * 1e3
    t_ops = step_flops / rate * 1e3
    return dict(prefill_bound_ms=f"{flops / rate * 1e3:.6g}",
                decode_bound_ms=f"{max(t_bytes, t_ops):.6g}",
                decode_bound_by='bytes' if t_bytes >= t_ops else 'operations')


def _lm_yardstick(cfg, params, batch) -> dict:
    """One layer's prefill attention: the port's flash attention against
    ``scaled_dot_product_attention`` on the same q/k/v (a yardstick; the
    path never calls it)."""
    B, S = batch['tokens'].shape
    p0 = lm_model._layer(params['blocks'], 0)['0_attn']
    with torch.inference_mode():
        x = lm_layers.embed_lookup(params['embed'], batch['tokens'])
        h = lm_layers.apply_norm(p0['norm1'], x, cfg.norm_eps)
        pos = torch.arange(S, device='cuda')[None].expand(B, S)
        q, k, v = lm_attn.gqa_qkv(p0['attn'], cfg, h, pos)

    @torch.inference_mode()
    def flash():
        return lm_attn.flash_attention(q, k, v, causal=True, chunk=cfg.attn_chunk)

    @torch.inference_mode()
    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), is_causal=True,
            enable_gqa=True).transpose(1, 2)
    err = float((flash() - sdpa()).abs().max())
    return dict(flash_ms=f"{time_ms(flash, 5):.6g}", sdpa_ms=f"{time_ms(sdpa, 5):.6g}",
                flash_vs_sdpa_max_abs=f"{err:.3g}")


@contextlib.contextmanager
def moe_routing():
    """Record every MoE layer's dispatch while the block runs: a list of
    (tokens a row, the largest expert load of a row, dropped pairs,
    pairs), device tensors where they are counts. Wraps the module's
    ``_dispatch_indices`` (which ``moe_apply`` calls) and restores it."""
    rec, inner = [], lm_moe._dispatch_indices

    def spy(idx, E, C):
        order, dest, keep = inner(idx, E, C)
        loads = torch.nn.functional.one_hot(idx.long(), E).sum(dim=(-3, -2))
        rec.append((idx.shape[-2], loads.max(), (~keep).sum(), keep.numel()))
        return order, dest, keep
    lm_moe._dispatch_indices = spy
    try:
        yield rec
    finally:
        lm_moe._dispatch_indices = inner


def _lm_full(cfg, params, batch, toks):
    """The card's full forward over LM_ROWS rows of the prompt and the
    tokens generated after it: the logits of each generated step."""
    S = (batch['tokens'] if 'tokens' in batch else batch['embeds']).shape[1]
    with torch.inference_mode():
        full, _ = lm_model.forward(params, cfg,
                                   _continue_in_text(params, cfg, batch, toks[:, :-1], LM_ROWS))
    return full[:, S - 1:].clone()


def _lm_compare(cfg, ref, toks, kept, bf16: bool) -> dict:
    """Prefill's and every decode step's logits (``kept``) against the
    full forward's (``ref``), and the generated tokens against its argmax
    where its top-2 margin is wide: fp32 at the serve contract's atol =
    rtol, bf16 at LM_BF16_REL / LM_BF16_ATOL."""
    diff = (kept - ref).abs()
    rel = (torch.linalg.vector_norm(kept - ref, dim=-1)
           / torch.linalg.vector_norm(ref, dim=-1)).amax(dim=0)      # a step's worst row
    for t in range(LM_GEN):
        if bf16:
            bad = float(rel[t]) > LM_BF16_REL or float(diff[:, t].max()) > LM_BF16_ATOL
            what = f"relative L2 {LM_BF16_REL} and max abs {LM_BF16_ATOL}"
        else:
            tol = LM_PREFILL_TOL if t == 0 else LM_DECODE_TOL
            bad = bool((diff[:, t] > tol + tol * ref[:, t].abs()).any())
            what = f"atol = rtol = {tol}"
        if bad:
            raise AssertionError(f"lm {cfg.name}: step {t} logits differ from the full "
                                 f"forward by more than {what}")
    margin = 2 * LM_BF16_ATOL if bf16 else LM_MARGIN
    top2 = torch.topk(ref, 2, dim=-1).values
    wide = (top2[..., 0] - top2[..., 1]) > margin
    agree = toks[:LM_ROWS] == torch.argmax(ref, dim=-1).to(torch.int32)
    if not bool(agree[wide].all()):
        raise AssertionError(f"lm {cfg.name}: a generated token differs from the full "
                             f"forward's argmax where its margin exceeds {margin}")
    return dict(self_check='ok', self_max_abs=f"{float(diff.max()):.3g}",
                self_rel_l2=f"{float(rel.max()):.3g}", steps_below_margin=int((~wide).sum()))


def _no_drop_factor(cfg, rec, cf: float) -> float:
    """``cf``, raised to cover the largest expert load of every routing
    in ``rec`` (``moe_routing``'s) that dropped pairs."""
    E, K = cfg.num_experts, cfg.top_k
    return max([cf] + [(int(r[1]) + 0.5) * E / (r[0] * K) for r in rec if int(r[2])])


def _moe_self_check(cfg, params, batch, cf: float) -> dict:
    """The self-check of an MoE config on LM_ROWS rows, at a capacity
    factor at which neither the rows' prefill nor the forward over the
    prompt and its 64 generated tokens drops a pair: from ``cf``, raised
    after each try to cover the largest expert load it routed (a drop
    upstream changes what later layers route, so the last try must see
    none)."""
    S = batch['tokens'].shape[1]
    rows = {k: v[:LM_ROWS] for k, v in batch.items()}
    for _ in range(LM_NO_DROP_TRIES):
        c = dataclasses.replace(cfg, capacity_factor=cf)
        eng = ServeEngine(c, make_host_mesh(1, 1), params, batch=LM_ROWS, prompt_len=S,
                          max_len=S + LM_GEN)
        with moe_routing() as rec:
            toks, *_, kept, caches = _lm_generate(eng, rows, LM_ROWS)
            del caches
            ref = _lm_full(c, params, rows, toks)
        if sum(int(r[2]) for r in rec) == 0:
            out = _lm_compare(c, ref, toks, kept, bf16=False)
            return dict(out, self_capacity_factor=f"{cf:.6g}")
        cf = _no_drop_factor(cfg, rec, cf)
        del ref, kept
    raise AssertionError(f"lm {cfg.name}: pairs still drop at capacity factor {cf:.6g} "
                         f"after {LM_NO_DROP_TRIES} tries")


def _cpu_view(cfg, params):
    """(cfg, params, layers run) of the CPU check: the whole model, or
    where its weights pass LM_CPU_MAX_BYTES a view of its first whole
    periods, at least LM_CPU_LAYERS layers (the stacked leaves' first
    slices; no tail)."""
    nbytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    if nbytes <= LM_CPU_MAX_BYTES:
        return cfg, params, cfg.num_layers
    periods = -(-LM_CPU_LAYERS // len(cfg.block_pattern))
    view = {k: v for k, v in params.items() if k != 'tail'}
    view['blocks'] = tree_map(lambda t: t[:periods], params['blocks'])
    layers = periods * len(cfg.block_pattern)
    return dataclasses.replace(cfg, num_layers=layers), view, layers


def _lm_cpu_check(cfg, params) -> dict:
    """The same weights on the CPU (the port's plain path) against the
    card: prefill of a 16-token prompt and 4 teacher-forced decode steps
    (past LM_CPU_MAX_BYTES, of the first whole periods, ``_cpu_view``)."""
    cfg, params, layers = _cpu_view(cfg, params)
    prompt = lm_prompt(cfg, 2, LM_CPU_PROMPT, SEED + 1, device='cpu')
    steps_in = torch.as_tensor(np.random.default_rng(SEED + 1).integers(
        0, cfg.vocab_size, (2, LM_CPU_STEPS), dtype=np.int32))
    cap = LM_CPU_PROMPT + LM_CPU_STEPS
    out = []
    for p, dev in ((params, 'cuda'), (tree_map(lambda t: t.cpu(), params), 'cpu')):
        with torch.inference_mode():
            logits, caches = lm_model.prefill(p, cfg, {k: v.to(dev) for k, v in prompt.items()},
                                              cache_cap=cap)
            steps = [logits]
            for t in range(LM_CPU_STEPS):
                logits, caches = lm_model.decode_step(p, cfg, caches,
                                                      steps_in[:, t:t + 1].to(dev),
                                                      LM_CPU_PROMPT + t)
                steps.append(logits)
        out.append(torch.cat(steps, dim=1).cpu())
        del p, caches
    tol = LM_BF16_REL if next(iter(tree_leaves(params))).dtype == torch.bfloat16 else LM_CPU_REL
    rel = float(torch.linalg.vector_norm(out[0] - out[1]) / torch.linalg.vector_norm(out[1]))
    if not rel <= tol:
        raise AssertionError(f"lm {cfg.name}: card vs CPU logits rel L2 {rel:.3e} > {tol}")
    return dict(cpu_rel_l2=f"{rel:.3g}", cpu_tol=tol, cpu_layers=layers)


#: the config whose sharded steps run on a 1 x 1 mesh beside its engine
LM_SHARDED_ARCH = 'internlm2-1.8b'


def _greedy(prefill, decode, params, batch, S: int):
    """A greedy run through step functions under CUDA events: (tokens
    (B, LM_GEN), every step's logits, prefill ms, decode ms a token)."""
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    logits, caches = prefill(params, batch)
    ev[1].record()
    kept = [logits]
    tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
    toks = [tok]
    for pos in range(S, S + LM_GEN - 1):
        logits, caches = decode(params, caches, tok, pos)
        kept.append(logits)
        tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
        toks.append(tok)
    ev[2].record()
    torch.cuda.synchronize()
    return (torch.cat(toks, 1), kept, ev[0].elapsed_time(ev[1]),
            ev[1].elapsed_time(ev[2]) / (LM_GEN - 1))


def lm_sharded_1x1(cfg, params, batch) -> None:
    """``[lm] mesh=1x1 path=sharded``: the sharded server's steps under
    the serve rules on a 1 x 1 mesh (no process group: a collective would
    raise), on ``shard_params``'s tree of the same weights, against the
    one-rank model code without rules (``lm_model.prefill`` and
    ``decode_step`` on ``params``): the tokens and every step's logits
    bitwise equal."""
    mesh = make_host_mesh(1, 1)
    rules = make_rules(mesh, mode='serve')
    local = shard_params(params, cfg, rules, mesh)
    B, S = batch['tokens'].shape
    prefill, specs = make_prefill_step(cfg, mesh, {'tokens': (B, S)},
                                       {'tokens': ('batch', 'seq')}, cache_cap=S + LM_GEN)
    decode, _ = make_decode_step(cfg, mesh, batch=B, cache_cap=S + LM_GEN)
    toks, kept, pre_ms, dec_ms = _greedy(prefill, decode, local, batch, S)
    with torch.inference_mode():
        ptoks, pkept, *_ = _greedy(
            lambda p, b: lm_model.prefill(p, cfg, b, cache_cap=S + LM_GEN),
            lambda p, c, t, pos: lm_model.decode_step(p, cfg, c, t, pos), params, batch, S)
    same = torch.equal(toks, ptoks) and all(torch.equal(a, b) for a, b in zip(kept, pkept))
    if not same:
        raise AssertionError(f"lm {cfg.name}: the sharded steps on 1 x 1 differ from the "
                             "one-rank model code's")
    sharded = sum(any(ma is not None for ma in sh[1]) for sh in tree_leaves(specs['p_sh']))
    say('lm', mesh='1x1', path='sharded', arch=cfg.name, batch=B, prompt=S, gen=LM_GEN,
        bitwise_vs_one_rank='true', specs_naming_a_mesh_axis=sharded, process_group='none',
        prefill_ms=f"{pre_ms:.6g}", decode_ms_per_token=f"{dec_ms:.6g}")


def lm_serve(arch: str) -> list:
    """One config at full width (the depth LM_LAYERS cuts, in
    LM_DTYPE): serve, check the card against itself and against the CPU,
    profile one decode step, time the yardstick. Returns the first row's
    generated tokens."""
    cfg = get_config(arch)
    depth = f"{LM_LAYERS.get(arch, cfg.num_layers)}/{cfg.num_layers}"
    cfg = dataclasses.replace(cfg, num_layers=LM_LAYERS.get(arch, cfg.num_layers))
    dtype = LM_DTYPE.get(arch, torch.float32)
    B, S = LM_SHAPES[arch]
    base = torch.cuda.memory_allocated()     # what earlier phases still hold
    one = make_host_mesh(1, 1)               # the weights the launcher draws
    params = draw_params(SEED, cfg, dtype, make_rules(one, mode='serve'), one)
    n = sum(t.numel() for t in tree_leaves(params))
    if n != lm_model.param_count(cfg):
        raise AssertionError(f"lm {arch}: {n} parameters, the plan counts "
                             f"{lm_model.param_count(cfg)}")
    batch = lm_prompt(cfg, B, S, SEED)
    torch.cuda.reset_peak_memory_stats()
    eng = ServeEngine(cfg, make_host_mesh(1, 1), params, batch=B, prompt_len=S,
                      max_len=S + LM_GEN)
    with moe_routing() as rec:
        toks = eng.generate(batch, LM_GEN)
    if tuple(toks.shape) != (B, LM_GEN) or toks.dtype != torch.int32:
        raise AssertionError(f"lm {arch}: generate gave {tuple(toks.shape)} {toks.dtype}")
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != 'highest'):
        raise AssertionError("lm: fp32 products ran with TF32")
    moe = {}
    if cfg.moe:     # the prefill's routing (decode routes 1 token a row: it drops none)
        pre = [r for r in rec if r[0] == S]
        if len(pre) != cfg.num_layers:
            raise AssertionError(f"lm {arch}: {len(pre)} MoE layers routed the prefill")
        share = sum(int(r[2]) for r in pre) / sum(r[3] for r in pre)
        moe = dict(capacity_factor=cfg.capacity_factor, prefill_dropped_share=f"{share:.6g}")
        start = _no_drop_factor(cfg, pre, cfg.capacity_factor)   # the self-check's first try
    del rec
    runs, caches = [], None
    for _ in range(3):
        caches = None                       # one run's caches alive at a time
        *r, caches = _lm_generate(eng, batch, LM_ROWS)
        if not torch.equal(r[0], toks):
            raise AssertionError(f"lm {arch}: a timed run generated other tokens than "
                                 "ServeEngine.generate")
        runs.append(r)
    med = [sorted(r[i] for r in runs)[1] for i in (1, 2, 3)]
    peak = torch.cuda.max_memory_allocated()
    last = toks[:, -1:]
    prof = profile(lambda: eng.decode(caches, last, S + LM_GEN - 1))
    if arch == STATS_ARCH:
        lm_decode_stats(cfg, params, eng, caches, last, S + LM_GEN - 1, B)
    kept = runs[-1][4]
    del runs, caches
    say('lm', arch=arch, layers=depth, dtype=str(dtype).replace('torch.', ''), params=n,
        active_params=lm_model.active_param_count(cfg), batch=B, prompt=S, gen=LM_GEN,
        inputs='+'.join(batch), prefill_ms=f"{med[0]:.6g}", decode_ms_per_token=f"{med[1]:.6g}",
        tok_per_s=f"{B * LM_GEN / med[2]:.6g}", generate_s=f"{med[2]:.6g}",
        peak_gib=f"{peak / 2**30:.4g}", base_gib=f"{base / 2**30:.4g}",
        **_lm_bounds(cfg, params, B, S), **moe,
        first_row=json.dumps(toks[0, :8].tolist()))
    say('profile', path=f'lm_decode_{arch}', **prof)
    if cfg.moe:
        del kept
        checks = _moe_self_check(cfg, params, batch, start)
    else:
        checks = _lm_compare(cfg, _lm_full(cfg, params, batch, toks), toks, kept,
                             bf16=dtype == torch.bfloat16)
        del kept
    checks.update(_lm_cpu_check(cfg, params))
    if cfg.block_pattern == ('attn',) and 'tokens' in batch:
        checks.update(_lm_yardstick(cfg, params, batch))
    say('lm', arch=arch, **checks)
    if arch == LM_SHARDED_ARCH:
        lm_sharded_1x1(cfg, params, batch)
    return toks[0].tolist()


def _encode_flops(cfg, tokens: int, seq: int) -> float:
    """An encoder forward's operations: 2 flop a linear weight a token
    (the head's too: every frame's logits) and bidirectional attention's
    scores and values, 4 S^2 hd a head a sequence."""
    abstract = lm_model.abstract_params(cfg, torch.float32)
    n_linear = _linear_weights({k: v for k, v in abstract.items() if k != 'embed'})
    attn = 4.0 * seq * cfg.num_heads * cfg.head_dim * tokens * cfg.num_layers
    return 2.0 * n_linear * tokens + attn


def lm_encode() -> None:
    """``[lm]`` for the encoder: hubert-xlarge's forward over 8 x 2048
    frame embeddings at full width (its time, bound and peak memory,
    finite logits of the expected shape, one forward under the
    profiler), then the card against the CPU at smoke size."""
    from repro_torch.configs import smoke_config
    cfg = get_config(ENCODE_ARCH)
    base = torch.cuda.memory_allocated()
    params = lm_model.init_params(torch.Generator(device='cuda').manual_seed(SEED), cfg,
                                  torch.float32)
    n = sum(t.numel() for t in tree_leaves(params))
    batch = lm_prompt(cfg, ENCODE_BATCH, ENCODE_SEQ, SEED)
    torch.cuda.reset_peak_memory_stats()

    @torch.inference_mode()
    def encode():
        return lm_model.forward(params, cfg, batch)[0]
    logits = encode()
    if (tuple(logits.shape) != (ENCODE_BATCH, ENCODE_SEQ, cfg.vocab_size)
            or not bool(torch.isfinite(logits).all())):
        raise AssertionError(f"encode: logits {tuple(logits.shape)}, finite "
                             f"{bool(torch.isfinite(logits).all())}")
    del logits
    ms = time_ms(encode, 3, warmup=1)
    peak = torch.cuda.max_memory_allocated()
    prof = profile(encode)
    flops = _encode_flops(cfg, ENCODE_BATCH * ENCODE_SEQ, ENCODE_SEQ)
    del params, batch
    small = smoke_config(cfg)
    sp = lm_model.init_params(torch.Generator().manual_seed(SEED), small, torch.float32)
    sb = lm_prompt(small, 2, 64, SEED + 1, device='cpu')
    with torch.inference_mode():
        want = lm_model.forward(sp, small, sb)[0]
        got = lm_model.forward(tree_map(lambda t: t.cuda(), sp), small,
                               {k: v.cuda() for k, v in sb.items()})[0].cpu()
    rel = float(torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want))
    if not rel <= ENCODE_CPU_REL:
        raise AssertionError(f"encode: card vs CPU logits rel L2 {rel:.3e} > {ENCODE_CPU_REL}")
    say('lm', arch=ENCODE_ARCH, mode='encode', params=n, batch=ENCODE_BATCH, seq=ENCODE_SEQ,
        encode_ms=f"{ms:.6g}", tok_per_s=f"{ENCODE_BATCH * ENCODE_SEQ / ms * 1e3:.6g}",
        flop=f"{flops:.4g}", bound_ms=f"{flops / FP32_FLOP_PER_S * 1e3:.6g}",
        peak_gib=f"{peak / 2**30:.4g}", base_gib=f"{base / 2**30:.4g}",
        cpu_rel_l2=f"{rel:.3g}", cpu_tol=ENCODE_CPU_REL)
    say('profile', path=f'lm_encode_{ENCODE_ARCH}', **prof)


def phase_lm() -> None:
    """``[lm]``: the language-model server at full width on the card, then
    the launcher as a user runs it. The path runs plain PyTorch (its
    products are matrix products outside any TPU kernel), so it must
    launch none of the hand-written kernels."""
    t0 = time.perf_counter()
    kernels.reset_launch_counts()
    first_rows = {}
    for arch in LM_ARCHS:
        first_rows[arch] = lm_serve(arch)
        _free_card()                    # recurrentgemma-9b's parameters take 35 GiB
    lm_encode()
    _free_card()
    launched = {k: v for k, v in kernels.launch_counts().items() if v}
    if launched:
        raise AssertionError(f"lm: the LM path launched hand-written kernels {launched}")
    t1 = time.perf_counter()
    B, S = LM_SHAPES[LM_ARCHS[0]]
    cmd = [sys.executable, '-m', 'repro_torch.launch.serve', '--arch', LM_ARCHS[0],
           '--no-smoke', '--batch', str(B), '--prompt-len', str(S), '--gen', str(LM_GEN)]
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, 'src')))
    for line in proc.stdout.splitlines():
        print(line, flush=True)
    if proc.returncode != 0:
        raise AssertionError(f"lm: the launcher exited {proc.returncode}: "
                             f"{proc.stderr[-2000:]}")
    # the same seed, parameters and prompts: the same tokens
    if f"[serve] first row: {first_rows[LM_ARCHS[0]]}" not in proc.stdout.splitlines():
        raise AssertionError("lm: the launcher's first row differs from the phase's")
    say('lm', label='launcher', rc=proc.returncode, seconds=f"{time.perf_counter() - t1:.3g}",
        fft_kernel_launches=0, phase_seconds=f"{time.perf_counter() - t0:.3g}")


#: ``[train]``: internlm2-1.8b at its published widths in fp32 (remat on),
#: 8 x 2048 tokens in 2 microbatches, 4 steps of ``make_train_step``
TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICRO, TRAIN_STEPS = 'internlm2-1.8b', 8, 2048, 2, 4
#: the FFT-conv LM at mamba2-1.3b's widths (every block the FFT-conv
#: mixer, ``examples/fftconv_lm.py``'s model at full size): 4 x 2048
#: tokens, so a layer's conv is 8192 real signals of n = 4096
FFTCONV_BATCH, FFTCONV_STEPS = 4, 3
#: one rank-1 real operator apply at n = 4096 = 64 x 64 (four_step
#: factors): the r2c columns are complex pencils of 32, which 'auto'
#: gives the Stockham kernel, the rows 64, the four-step kernel; an apply
#: transforms two operands and inverts one: 3 of each kernel
FFTCONV_PER_APPLY = {'fft_pencil': 3, 'fft_matmul': 3}
#: applies a layer a training step: the forward, remat's second forward,
#: the backward's two correlation applies
FFTCONV_APPLIES = 4
#: the kernels at the train path's shapes, one layer's signal operand
#: (4 x 2048 signals of 4096 as 64 x 64 rows): the r2c columns' 32-point
#: complex pencils, 64 a signal, and the half plane's 33 rows of 64
TRAIN_KERNEL_SHAPES = {'fft_pencil': (FFTCONV_BATCH * 2048 * 64, 32),
                       'fft_matmul': (FFTCONV_BATCH * 2048 * 33, 64)}
#: the keys of each kernel's ``train`` record in the ``kernels`` JSON line
TRAIN_KEYS = ('n', 'pencils', 'variant') + JSON_KEYS
#: ``_FFTConv``'s gradients against autograd through the plain tier on
#: the same inputs, relative L2 (fp32 four-step products either way);
#: its forward against torch.fft.rfft/irfft
FFTCONV_GRAD_REL = 1e-5
#: one step on the card against one on the CPU at smoke size, the same
#: parameters and batch: ce, grad norm, the updated parameters and
#: moments, relative L2 (fp32 in another summation order; lr 2e-4, so
#: the first AdamW step's sign-like moves stay small)
TRAIN_CPU_REL = 1e-5
TRAIN_CPU_LR = dict(peak_lr=1e-3, warmup_steps=5, total_steps=100)
#: the depth of the bitwise check of the step on a 1 x 1 mesh (the train
#: rules) against the step without rules
TRAIN_BITWISE_LAYERS = 2


def kernels_train(gen) -> dict:
    """``fft_pencil`` and ``fft_matmul`` at the train path's shapes, each
    against its plain version, forward and inverse, with its time, the
    plain version's, ``torch.fft.fft``'s and the bound."""
    out = {}
    for name, (pencils, n) in TRAIN_KERNEL_SHAPES.items():
        module = fft_pencil if name == 'fft_pencil' else fft_matmul
        run, plain = getattr(module, name), getattr(module, f'{name}_plain')
        x = planar((pencils, n), gen)
        xc = torch.complex(*x)
        err = max(check(name, run(*x, inverse=inv), plain(*x, inverse=inv),
                        f"({pencils}, {n}) inverse={inv}") for inv in (False, True))
        b, by = bound(pencils * n, fft_flops(n, pencils))
        out[name] = dict(n=n, pencils=pencils, variant=module.variant(n), max_abs_err=err,
                         ms=time_ms(lambda: run(*x), 20), plain_ms=time_ms(lambda: plain(*x), 5),
                         library_ms=time_ms(lambda: torch.fft.fft(xc, dim=-1), 20),
                         bound_ms=b, bound_by=by)
        say('kernel', path='train', name=name, tol=KERNEL_RTOL,
            **{k: (f"{v:.6g}" if isinstance(v, float) else v) for k, v in out[name].items()})
        del x, xc
    return out


def _free_card() -> float:
    """Drop what earlier phases left in the allocator's cache; return what
    is still allocated, in GiB."""
    import gc
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated() / 2**30


def _linear_weights(tree) -> int:
    """The elements of every matrix product's weight (a linear layer's
    'w', the MLP's 'wi' and 'wo') in a tree of meta tensors."""
    return sum(_linear_weights(v) if isinstance(v, dict)
               else (v.numel() if k in ('w', 'wi', 'wo') else 0) for k, v in tree.items())


def _train_flops(cfg, tokens: int, seq: int) -> float:
    """A step's operations, the least the card must do: every linear
    weight of the layers' products 2 flop a token forward, 4 backward, 2
    more in remat's second forward; the head (tied or not, outside remat)
    6; attention's scores and values, 2 S^2 hd a head a sequence forward
    when causal and 4 S^2 hd when not (hubert-xlarge), times 4 (remat,
    backward twice); the FFT-conv mixer's transforms, 2.5 n log2 n a real
    signal of n = 2S, three an apply, four applies a step."""
    head = cfg.vocab_size * cfg.d_model
    abstract = lm_model.abstract_params(cfg, torch.float32)
    n_layer = _linear_weights({k: v for k, v in abstract.items() if k in ('blocks', 'tail')})
    flops = (8.0 * n_layer + 6.0 * head) * tokens
    layers = cfg.num_layers
    if 'attn' in cfg.block_pattern:
        flops += (4 * 2.0 * seq * cfg.num_heads * cfg.head_dim * tokens * layers
                  * (1 if cfg.causal else 2))
    if 'fftconv' in cfg.block_pattern:
        n = 2 * seq
        signals = tokens // seq * cfg.d_model
        flops += FFTCONV_APPLIES * 3 * signals * 2.5 * n * math.log2(n) * layers
    return flops


def _timed_steps(step, params, opt, batches) -> tuple:
    """Run the steps; each step's CUDA-event ms, its metrics (host
    floats) and its wall ms."""
    ms, mets, walls = [], [], []
    for b in batches:
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        e0.record()
        params, opt, m = step(params, opt, b)
        e1.record()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        ms.append(e0.elapsed_time(e1))
        mets.append({k: float(v) for k, v in m.items()})
    return params, opt, ms, mets, walls


def train_full(cfg, label: str, batch: int, micro: int, steps: int, mesh) -> dict:
    """One config at full width in fp32: ``make_train_step`` for ``steps``
    steps, then one more under the profiler. Returns the steps' kernel
    launches (all, and those on the mma and radix-8 bodies)."""
    from repro_torch.data import SyntheticLM, shard_batch
    from repro_torch.train.optim import adamw_init
    from repro_torch.train.trainstep import make_train_step
    base = _free_card()
    gen = torch.Generator(device='cuda').manual_seed(SEED)
    params = lm_model.init_params(gen, cfg, torch.float32)
    n = sum(t.numel() for t in tree_leaves(params))
    opt = adamw_init(params)
    data = SyntheticLM(cfg.vocab_size, TRAIN_SEQ, batch, seed=SEED, input_mode=cfg.input_mode,
                       d_model=cfg.d_model, mrope=cfg.pos_kind == 'mrope')
    batches = [shard_batch(data.batch_at(i), mesh) for i in range(steps + 1)]
    # the first steps of a run at the trainer's default schedule (peak 3e-4
    # after 100 warmup steps): a short warmup's sign-like first AdamW steps
    # of 3e-4 a weight throw a 2048-wide random model off (internlm2's ce
    # went 11.83 -> 13.86 at the third step with 2 warmup steps)
    step = make_train_step(cfg, mesh, microbatches=micro, param_dtype=torch.float32)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    params, opt, ms, mets, walls = _timed_steps(step, params, opt, batches[:steps])
    launches = kernels.launch_counts()
    mma, radix8 = fft_matmul.launches_mma, fft_pencil.launches_radix8
    peak = torch.cuda.max_memory_allocated()
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != 'highest'):
        raise AssertionError("train: fp32 products ran with TF32")
    for m in mets:
        if not (all(math.isfinite(v) for v in m.values()) and m['grad_norm'] > 0
                and 0 < m['ce'] < 2 * math.log(cfg.vocab_size)):
            raise AssertionError(f"train {label}: a step's metrics {m}")
    # the hand-written kernels' share: the radix-8 Stockham and tensor-core bodies
    prof = profile(lambda: step(params, opt, batches[steps]),
                   sums={'fft_kernels_ms': r'radix8_|_mma3?_kernel'})
    med = sorted(ms[1:])[len(ms[1:]) // 2]
    tokens = batch * TRAIN_SEQ
    flops = _train_flops(cfg, tokens, TRAIN_SEQ)
    out = dict(params=n, batch=batch, seq=TRAIN_SEQ, microbatches=micro, steps=steps,
               step_ms=f"{med:.6g}", step_wall_ms=f"{sorted(walls[1:])[len(walls[1:]) // 2]:.6g}",
               tok_per_s=f"{tokens / med * 1e3:.6g}", peak_gib=f"{peak / 2**30:.4g}",
               base_gib=f"{base:.4g}", flop=f"{flops:.4g}",
               bound_ms=f"{flops / FP32_FLOP_PER_S * 1e3:.6g}",
               ce=json.dumps([round(m['ce'], 4) for m in mets]),
               grad_norm=json.dumps([round(m['grad_norm'], 4) for m in mets]))
    say('train', model=label, **out)
    say('profile', path=f'train_{label}', **prof)
    del params, opt, batches, step
    return dict(launches=launches, mma=mma, radix8=radix8)


def _fftconv_cfg(cfg):
    return dataclasses.replace(cfg, block_pattern=('fftconv',), fftconv_len=1024)


def fftconv_grad_check(cfg, mesh) -> None:
    """One layer at the full-width shapes: ``_FFTConv`` (the kernels,
    forward and adjoint) against autograd through the plain tier
    (``kernel='reference'``) on the same hr and kr; its forward against
    ``torch.fft.rfft``/``irfft``."""
    S, n = TRAIN_SEQ, 2 * TRAIN_SEQ
    g = torch.Generator(device='cuda').manual_seed(SEED + 2)
    params = lm_model.init_params(g, cfg, torch.float32)
    p = lm_model._layer(params['blocks'], 0)['0_fftconv']['fftconv']
    klen = min(cfg.fftconv_len, S)
    decay = torch.exp(-torch.nn.functional.softplus(p['decay'])
                      * torch.arange(klen, device='cuda', dtype=torch.float32)[:, None])
    kr = torch.nn.functional.pad((p['kernel'][:klen] * decay).t(), (0, n - klen)).contiguous()
    hr = torch.nn.functional.pad(torch.randn((FFTCONV_BATCH, cfg.d_model, S), generator=g,
                                             device='cuda'), (0, n - S)).contiguous()
    w = torch.randn(hr.shape, generator=g, device='cuda')
    del params, p
    axes = lm_ssd._pick_axes(mesh, n)
    conv = lm_ssd._fftconv_runtime_plan(n, mesh, axes, False)
    adj = lm_ssd._fftconv_runtime_plan(n, mesh, axes, True)
    if conv.resolved_kernel != 'pallas':
        raise AssertionError(f"fftconv: the runtime plan resolved to {conv.resolved_kernel}")
    th, tk = hr.clone().requires_grad_(), kr.clone().requires_grad_()
    kernels.reset_launch_counts()
    y = lm_ssd._FFTConv.apply(th, tk, conv.apply, adj.apply)
    gh, gk = torch.autograd.grad((y * w).sum(), (th, tk))
    torch.cuda.synchronize()
    launched = kernels.launch_counts()
    want = {k: 3 * v for k, v in FFTCONV_PER_APPLY.items()}
    if {k: v for k, v in launched.items() if v} != want:
        raise AssertionError(f"fftconv: a forward and backward launched {launched}, not {want}")
    plain = fft.plan_op((n,), mesh, op=fft.spectral_mul, real=True, n_spectra=1,
                        mesh_axes=axes, kernel='reference')
    ph, pk = hr.clone().requires_grad_(), kr.clone().requires_grad_()
    yp = plain.apply(ph, pk)
    ah, ak = torch.autograd.grad((yp * w).sum(), (ph, pk))
    if kernels.launch_counts() != launched:
        raise AssertionError("fftconv: the plain tier launched a kernel")

    def rel(a, b):
        return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))
    lib = torch.fft.irfft(torch.fft.rfft(hr) * torch.fft.rfft(kr), n=n)
    y, yp = y.detach(), yp.detach()
    errs = dict(grad_hr_rel=rel(gh, ah), grad_kr_rel=rel(gk, ak), fwd_vs_plain_rel=rel(y, yp),
                fwd_vs_torch_fft_rel=rel(y, lib))
    if not all(v <= FFTCONV_GRAD_REL for v in errs.values()):
        raise AssertionError(f"fftconv: {errs} > {FFTCONV_GRAD_REL}")

    def kernel_fwd_bwd():
        yk = lm_ssd._FFTConv.apply(th, tk, conv.apply, adj.apply)
        torch.autograd.grad((yk * w).sum(), (th, tk))

    def plain_fwd_bwd():
        torch.autograd.grad((plain.apply(ph, pk) * w).sum(), (ph, pk))

    def library_fwd_bwd():
        lh, lk = hr.clone().requires_grad_(), kr.clone().requires_grad_()
        yl = torch.fft.irfft(torch.fft.rfft(lh) * torch.fft.rfft(lk), n=n)
        torch.autograd.grad((yl * w).sum(), (lh, lk))
    times = dict(fwd_bwd_ms=time_ms(kernel_fwd_bwd, 5), plain_ms=time_ms(plain_fwd_bwd, 3),
                 library_ms=time_ms(library_fwd_bwd, 5))
    out = {k: f"{v:.3g}" for k, v in errs.items()}
    out.update({k: f"{v:.6g}" for k, v in times.items()})
    say('train', check='fftconv_adjoint', signals=FFTCONV_BATCH * cfg.d_model, n=n,
        tol=FFTCONV_GRAD_REL, launches=json.dumps(want), **out)


def train_cpu_check(arch: str, seq: int) -> None:
    """One step at smoke size on the card and on the CPU from the same
    parameters and batch: ce, grad norm, the parameters and moments."""
    from repro_torch.configs import smoke_config
    from repro_torch.data import SyntheticLM, shard_batch
    from repro_torch.train.optim import adamw_init
    from repro_torch.train.trainstep import make_train_step
    cfg = smoke_config(get_config('mamba2-1.3b' if arch == 'fftconv' else arch))
    if arch == 'fftconv':
        cfg = _fftconv_cfg(cfg)
    params = lm_model.init_params(torch.Generator().manual_seed(SEED), cfg, torch.float32)
    batch = SyntheticLM(cfg.vocab_size, seq, 2, seed=SEED, input_mode=cfg.input_mode,
                        d_model=cfg.d_model, mrope=cfg.pos_kind == 'mrope').batch_at(0)
    res = []
    for dev in ('cuda', 'cpu'):
        mesh = make_host_mesh(1, 1, device=dev)
        p = tree_map(lambda t: t.to(dev, copy=True), params)
        o = adamw_init(p)
        step = make_train_step(cfg, mesh, param_dtype=torch.float32, **TRAIN_CPU_LR)
        kernels.reset_launch_counts()
        p, o, m = step(p, o, shard_batch(batch, mesh))
        res.append((p, o, {k: float(v) for k, v in m.items()}, kernels.launch_counts()))
    (pc, oc, mc, lc), (ph, oh, mh, _) = res
    if arch == 'fftconv' and not lc['fft_pencil']:
        raise AssertionError(f"train cpu check {arch}: no kernel launched on the card ({lc})")

    def rel(a, b):
        a, b = a.cpu().double(), b.double()
        return float(torch.linalg.vector_norm(a - b) / max(float(torch.linalg.vector_norm(b)),
                                                           1e-30))
    errs = dict(ce_rel=abs(mc['ce'] - mh['ce']) / abs(mh['ce']),
                grad_norm_rel=abs(mc['grad_norm'] - mh['grad_norm']) / mh['grad_norm'],
                params_rel=max(rel(a, b) for a, b in zip(tree_leaves(pc), tree_leaves(ph))),
                moments_rel=max(rel(a, b) for k in ('m', 'v')
                                for a, b in zip(tree_leaves(oc[k]), tree_leaves(oh[k]))))
    if not all(v <= TRAIN_CPU_REL for v in errs.values()):
        raise AssertionError(f"train cpu check {arch}: {errs} > {TRAIN_CPU_REL}")
    say('train', check='card_vs_cpu', model=arch, seq=seq, tol=TRAIN_CPU_REL,
        launches=json.dumps({k: v for k, v in lc.items() if v}),
        **{k: f"{v:.3g}" for k, v in errs.items()})


def train_sharded_1x1() -> None:
    """The sharded trainer's step on a 1 x 1 mesh (``make_train_step(cfg,
    make_host_mesh(1, 1))``, the train rules) against the step without
    rules (``mesh=None``): internlm2-1.8b at full width and
    ``TRAIN_BITWISE_LAYERS`` layers, two steps of the phase's batch in its
    microbatches from the same parameters; each step's loss and every
    parameter and moment after them must be bitwise equal."""
    from repro_torch.data import SyntheticLM, shard_batch
    from repro_torch.train.optim import adamw_init
    from repro_torch.train.trainstep import make_train_step
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), num_layers=TRAIN_BITWISE_LAYERS)
    data = SyntheticLM(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=SEED)
    t0 = time.perf_counter()
    runs = []
    for mesh in (make_host_mesh(1, 1), None):
        params = lm_model.init_params(torch.Generator(device='cuda').manual_seed(SEED), cfg,
                                      torch.float32)
        opt = adamw_init(params)
        step = make_train_step(cfg, mesh, microbatches=TRAIN_MICRO, param_dtype=torch.float32)
        losses = []
        for i in range(2):
            params, opt, m = step(params, opt, shard_batch(data.batch_at(i), 'cuda'))
            losses.append(m['loss'])
        runs.append((torch.stack(losses), params, opt))
        del params, opt
    (la, pa, oa), (lb, pb, ob) = runs
    same = bool(torch.equal(la, lb)) and all(
        torch.equal(a, b) for a, b in zip(tree_leaves({'p': pa, 'm': oa['m'], 'v': oa['v']}),
                                           tree_leaves({'p': pb, 'm': ob['m'], 'v': ob['v']})))
    if not same:
        raise AssertionError("train: the step on a 1x1 mesh differs from the step without "
                             "rules")
    say('train', mesh='1x1', path='sharded', bitwise_vs_one_rank=True,
        layers=cfg.num_layers, steps=2, loss=json.dumps([round(float(v), 6) for v in la]),
        seconds=f"{time.perf_counter() - t0:.3g}")
    del runs, pa, oa, pb, ob


def _run(cmd: list, timeout: int) -> subprocess.CompletedProcess:
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=timeout,
                          env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, 'src')))
    if proc.returncode != 0:
        raise AssertionError(f"{' '.join(cmd[1:4])} exited {proc.returncode}: "
                             f"{proc.stderr[-2000:]}")
    return proc


def train_launcher_restart() -> None:
    """The launcher as a subprocess, smoke mamba2-1.3b for 20 steps with a
    checkpoint every 5 and a failure at step 13, beside an uninterrupted
    run: restarts=1, and the two final checkpoints equal bit for bit."""
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        base = [sys.executable, '-m', 'repro_torch.launch.train', '--arch', 'mamba2-1.3b',
                '--steps', '20', '--ckpt-every', '5']
        t0 = time.perf_counter()
        ft = _run(base + ['--fail-at', '13', '--ckpt-dir', os.path.join(tmp, 'ft')], 300)
        ref = _run(base + ['--ckpt-dir', os.path.join(tmp, 'ref')], 300)
        last = ft.stdout.strip().splitlines()[-1]
        print(last, flush=True)
        if not (last.startswith('[train] arch=mamba2-1.3b steps=20 ') and 'restarts=1 ' in last):
            raise AssertionError(f"train launcher: {last!r}")
        ft_dir, ref_dir = (os.path.join(tmp, d, 'step_00000020') for d in ('ft', 'ref'))
        names = sorted(os.listdir(ft_dir))
        differ = [nm for nm in names if not filecmp.cmp(os.path.join(ft_dir, nm),
                                                        os.path.join(ref_dir, nm), shallow=False)]
        if differ:
            raise AssertionError(f"train launcher: the restarted run's final checkpoint "
                                 f"differs from the uninterrupted run's in {differ}")
    say('train', check='launcher_restart', restarts=1, bitwise=True, files=len(names),
        seconds=f"{time.perf_counter() - t0:.3g}")


def phase_train(gen) -> tuple:
    """``[train]``: the trainer at full width on the card; returns the
    FFT-conv LM's launch counts (its training steps are the train path's
    kernel launches) and the kernels' records at the path's shapes."""
    t0 = time.perf_counter()
    _free_card()
    rec = kernels_train(gen)
    mesh = make_host_mesh(1, 1)
    for arch in (TRAIN_ARCH, ENCODE_ARCH):
        run = train_full(get_config(arch), arch, TRAIN_BATCH, TRAIN_MICRO, TRAIN_STEPS, mesh)
        if any(run['launches'].values()):
            raise AssertionError(f"train: {arch} launched FFT kernels {run['launches']}")
        _free_card()
    cfg = _fftconv_cfg(get_config('mamba2-1.3b'))
    conv = train_full(cfg, 'fftconv_lm', FFTCONV_BATCH, 1, FFTCONV_STEPS, mesh)
    per_step = {k: v * FFTCONV_APPLIES * cfg.num_layers for k, v in FFTCONV_PER_APPLY.items()}
    got = {k: v for k, v in conv['launches'].items() if v}
    want = {k: v * FFTCONV_STEPS for k, v in per_step.items()}
    if got != want or conv['mma'] != want['fft_matmul'] or conv['radix8'] != want['fft_pencil']:
        raise AssertionError(f"train fftconv: launched {got} (mma {conv['mma']}, radix8 "
                             f"{conv['radix8']}), want {want}, all on the hand-written body")
    say('train', model='fftconv_lm', launches_per_step=json.dumps(per_step),
        launches_mma=conv['mma'], launches_radix8=conv['radix8'])
    _free_card()
    fftconv_grad_check(cfg, mesh)
    _free_card()
    for arch, seq in (('internlm2-1.8b', 64), ('mamba2-1.3b', 64), (ENCODE_ARCH, 64),
                      ('fftconv', TRAIN_SEQ)):
        train_cpu_check(arch, seq)
    _free_card()
    train_sharded_1x1()
    _free_card()
    train_launcher_restart()
    t1 = time.perf_counter()
    ex = _run([sys.executable, os.path.join('examples', 'torch_fftconv_lm.py')], 600)
    loss = [ln for ln in ex.stdout.splitlines() if ln.startswith('fftconv LM loss:')]
    first, last = (float(v) for v in re.findall(r'([\d.]+) -> ([\d.]+)', loss[0])[0])
    if not (first - last > 0.3 and 'torch_fftconv_lm OK' in ex.stdout):
        raise AssertionError(f"train: the fftconv example did not learn: {loss}")
    say('train', check='fftconv_example', loss_first=first, loss_last=last,
        seconds=f"{time.perf_counter() - t1:.3g}",
        phase_seconds=f"{time.perf_counter() - t0:.3g}")
    return conv['launches'], rec


#: ``[path] label=large1d_factor_order``: each (method, fused) with its
#: launches a direction of ``make_fft1d_large``'s default, the
#: factor-transposed D-form (the natural order's last swap and transpose
#: skipped): the mma body's two four-steps; the Stockham column superstep
#: fused with its twiddle planes (``fft_fused``) and the row DFT on
#: ``fft_pencil``; unfused, two ``fft_pencil`` and the twiddle a product
FACTOR_ORDER_CASES = (('four_step', True, {'fft_matmul': 2}),
                      ('four_step', False, {'fft_matmul': 2}),
                      ('stockham', True, {'fft_fused': 1, 'fft_pencil': 1}),
                      ('stockham', False, {'fft_pencil': 2}))
#: D against the natural-order result transposed, max |a - b| / max |b|:
#: the same kernels on the same pencils (bitwise), except that the
#: natural-order Stockham row DFT runs ``radix8_fused_kernel`` where the
#: D-form runs ``radix8_pencil_kernel``, as ``stockham_overlap``
FACTOR_ORDER_RTOL = 1e-6


def phase_factor_order(gen) -> dict:
    """``make_fft1d_large(natural_order=False)`` (the reference's default)
    on the 8 signals of 2^24 as (8, 4096, 4096) rows of A[k1, k2], for
    both ``fused`` values on the mma and radix-8 bodies: exact launches a
    direction (every one on the hand-written body), D against the
    natural-order result transposed (``FACTOR_ORDER_RTOL``) and against
    ``torch.fft.fft`` of each signal (``PATH_RTOL``). Returns the
    D-form runs' launch counts."""
    t0 = time.perf_counter()
    n1 = n2 = math.isqrt(LARGE1D[0])
    mesh = make_fft_mesh(1, 1)
    xr, xi = planar(LARGE1D_BATCH + (n1, n2), gen)
    ref = torch.fft.fft(torch.complex(xr, xi).reshape(LARGE1D_BATCH + LARGE1D))
    want = ref.reshape(LARGE1D_BATCH + (n2, n1)).transpose(1, 2)
    total = dict.fromkeys(kernels.launch_counts(), 0)
    gaps, rows = {}, []
    for method, fused, expect in FACTOR_ORDER_CASES:
        tag = f"{method}_{'fused' if fused else 'unfused'}"
        kw = dict(method=method, fused=fused)
        fn = fft_large1d.make_fft1d_large(n1, n2, mesh, ('x', 'y'), **kw)
        natural = fft_large1d.make_fft1d_large(n1, n2, mesh, ('x', 'y'), natural_order=True,
                                               **kw)
        kernels.reset_launch_counts()
        dr, di = fn(xr, xi)
        torch.cuda.synchronize()
        got = kernels.launch_counts()
        on_body = {'fft_matmul': fft_matmul.launches_mma, 'fft_pencil': fft_pencil.launches_radix8,
                   'fft_fused': fft_fused.launches_radix8}
        twiddled = fft_fused.launches_twiddle
        if {k: v for k, v in got.items() if v} != expect:
            raise AssertionError(f"large1d_factor_order {tag}: launches {got}, expected {expect}")
        if any(on_body[k] != v for k, v in expect.items()) or twiddled != expect.get('fft_fused', 0):
            raise AssertionError(f"large1d_factor_order {tag}: {on_body} on the hand-written "
                                 f"bodies, {twiddled} with twiddle planes, of {expect}")
        for k, v in got.items():
            total[k] += v
        nr, ni = natural(xr, xi)
        err, rel = max_err((dr, di), (nr.transpose(1, 2), ni.transpose(1, 2)))
        bitwise = torch.equal(dr, nr.transpose(1, 2)) and torch.equal(di, ni.transpose(1, 2))
        del nr, ni
        fwd = float((torch.linalg.vector_norm((torch.complex(dr, di) - want).flatten(1), dim=1)
                     / torch.linalg.vector_norm(want.flatten(1), dim=1)).max())
        if tuple(dr.shape) != LARGE1D_BATCH + (n1, n2) or rel > FACTOR_ORDER_RTOL:
            raise AssertionError(f"large1d_factor_order {tag}: D {tuple(dr.shape)} is "
                                 f"{rel:.3e} from the natural order transposed")
        if fwd > PATH_RTOL:
            raise AssertionError(f"large1d_factor_order {tag}: rel L2 {fwd:.3e} vs torch.fft.fft")
        gaps[tag] = rel
        rows.append(f"{tag}:{json.dumps(expect)}:bitwise={bitwise}:fwd_rel_l2={fwd:.3e}")
        del dr, di
    say('path', label='large1d_factor_order', shape=json.dumps(list(LARGE1D_BATCH + (n1, n2))),
        cases=' '.join(rows), vs_natural_transposed=json.dumps(
            {k: f"{v:.3e}" for k, v in gaps.items()}), tol=FACTOR_ORDER_RTOL,
        launches=json.dumps(total), seconds=f"{time.perf_counter() - t0:.3g}")
    return total


def check_matmul_factors(gen) -> None:
    """``fft_matmul(factors=)`` on the card: the split each body runs
    (``mma_factors(n)``: (32, 16) at 512, (16, 16, 16) at 4096) runs
    and equals the default call bitwise; any other split raises
    ``ValueError`` naming the body's and launches nothing."""
    x = planar((4096, 512), gen)
    before = fft_matmul.launches
    same = fft_matmul.fft_matmul(*x, factors=fft_block.mma_factors(512))
    if not all(torch.equal(a, b) for a, b in zip(same, fft_matmul.fft_matmul(*x))):
        raise AssertionError('fft_matmul(factors=(32, 16)) differs from the default call')
    refused = []
    for n, foreign in ((512, (16, 32)), (4096, (64, 64))):
        y = planar((64, n), gen)
        launched = fft_matmul.launches
        try:
            fft_matmul.fft_matmul(*y, factors=foreign)
        except ValueError as e:
            if str(fft_block.mma_factors(n)) not in str(e):
                raise AssertionError(f"fft_matmul refused {foreign} without naming "
                                     f"{fft_block.mma_factors(n)}: {e}")
            refused.append(f"{n}:{'x'.join(map(str, foreign))}")
        else:
            raise AssertionError(f"fft_matmul ran the foreign split {foreign} at n = {n}")
        if fft_matmul.launches != launched:
            raise AssertionError('fft_matmul launched on a refused split')
    say('kernel', check='fft_matmul_factors', body_split_bitwise=True,
        refused=','.join(refused), launches=fft_matmul.launches - before)


#: ``[dryrun]``: the cell the phase runs, and its collectives by the
#: port's serve rules on 16 x 16: two row-parallel sums a layer and the
#: embedding's; ``wk``, ``wv`` gathered at use a layer (8 kv heads, 16
#: ranks) and the logits gathered over 'model' and 'data'
DRYRUN_CELL = ('internlm2-1.8b', 'decode_32k')
#: ``[dryrun]``'s subprocess: the LM cell through ``dryrun.run_cell`` and
#: the FFT's n^3 through ``benchmarks/torch_roofline_fft.py``'s ``run``,
#: on one fake group of 256 ranks
DRYRUN_SCRIPT = """
import os, sys
sys.path.insert(0, os.path.join(os.getcwd(), 'benchmarks'))
import torch_roofline_fft as R
from repro_torch.launch import dryrun
arch, shape, n, out = sys.argv[1:]
dryrun.init_fake_world(256)
dryrun.run_cell(arch, shape, False, out_dir=out)
R.run(int(n), out_dir=out)
"""
DRYRUN_COUNTS = {'all-reduce': 2 * 24 + 1, 'all-gather': 2 * 24 + 2}


def phase_dryrun() -> str:
    """``[dryrun]``: ``launch.dryrun.run_cell`` on one production cell at
    full width on the 16 x 16 mesh, in a subprocess (its ``fake`` process
    group of 256 ranks cannot share this process): status ok, the hand
    count of collectives, the record's bytes and roofline (datasheet
    constants, not a measurement). Returns the records' directory."""
    t0 = time.perf_counter()
    arch, shape = DRYRUN_CELL
    out = os.path.join(ROOT, 'chiprun_out', 'dryrun')
    # the FFT's cell (phase_dryrun_fft reads it) in the same process: one start
    _run([sys.executable, '-c', DRYRUN_SCRIPT, arch, shape, str(N), out], 300)
    with open(os.path.join(out, f'pod_16x16__{arch}__{shape}.json')) as fh:
        rec = json.load(fh)
    if rec['status'] != 'ok' or rec['hlo']['collective_counts'] != DRYRUN_COUNTS:
        raise AssertionError(f"dryrun {arch} {shape}: {rec['status']} "
                             f"{rec.get('error') or rec['hlo']['collective_counts']}")
    mem, roof = rec['memory'], rec['roofline']
    say('dryrun', arch=arch, shape=shape, mesh=rec['mesh'], status=rec['status'],
        rank_gib=f"{(mem['argument_size_in_bytes'] + mem['temp_size_in_bytes']) / 2**30:.4g}",
        fits_80gib=mem['fits_80gib'], collectives=json.dumps(rec['hlo']['collective_counts']),
        dot_flops=f"{rec['hlo']['dot_flops']:.6g}", dominant=roof['dominant'],
        bound_ms=f"{roof['bound_s'] * 1e3:.6g}", constants='datasheet',
        step_s=rec['step_s'], seconds=f"{time.perf_counter() - t0:.3g}")
    return out


def check_kernel_stats(gen) -> dict:
    """``[path] check=kernel_stats``: ``hlostats.count()`` around one
    fwd+inv of the default 512^3 plan on the card. The counter's
    ``fft_matmul`` launches (reported by each launch, which no dispatch
    mode sees) must equal the module's counter, 6, all on the
    tensor-core body, each reading and writing 8 bytes an element (16 a
    launch) with 5 n log2 n flops a pencil. Returns the launch counts."""
    t0 = time.perf_counter()
    p = fft.plan((N, N, N), make_fft_mesh(1, 1))
    xr, xi = planar((N, N, N), gen)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    with hlostats.count() as st:
        p.inverse(p.forward((xr, xi)))
        torch.cuda.synchronize()
    total, mma = kernels.launch_counts(), fft_matmul.launches_mma
    k = st.analyze()['kernels']
    elems = N ** 3
    want = {'fft_matmul': {'launches': 6, 'launches_by_body': {'mma': 6},
                           'bytes_read': 6 * 8 * elems, 'bytes_written': 6 * 8 * elems,
                           'flops': 6 * 5.0 * elems * math.log2(N)}}
    if k != want or total['fft_matmul'] != 6 or mma != 6:
        raise AssertionError(f"kernel_stats: counted {k}, launched {total} ({mma} mma)")
    say('path', check='kernel_stats', counted=k['fft_matmul']['launches'],
        launched=total['fft_matmul'], launches_mma=mma,
        bytes_per_elem_launch=(k['fft_matmul']['bytes_read'] + k['fft_matmul']['bytes_written'])
        / (6 * elems), flops=f"{k['fft_matmul']['flops']:.6g}",
        seconds=f"{time.perf_counter() - t0:.3g}")
    return total


def phase_dryrun_fft(out: str) -> None:
    """``[dryrun] fft``: the record of ``benchmarks/torch_roofline_fft.py``'s
    512^3 on the 16 x 16 mesh that ``phase_dryrun``'s subprocess wrote
    (``fake`` group, ``meta``, no card): rank 0's fwd+inv of the paper's
    cell counted with the card's kernels (6 ``fft_matmul`` on the
    tensor-core body); its three roofline terms (datasheet constants,
    not a measurement) and the dominant one. ``out``: that subprocess's
    record directory."""
    with open(os.path.join(out, f'pod_16x16__wsfft__{N}__auto.json')) as fh:
        rec = json.load(fh)
    k = rec['kernels']
    if rec['status'] != 'ok' or k.get('fft_matmul', {}).get('launches_by_body') != {'mma': 6}:
        raise AssertionError(f"dryrun fft: {rec['status']} {k}")
    roof = rec['roofline']
    say('dryrun', cell='fft', n=N, mesh=rec['mesh'], comm=rec['comm'],
        compute_us=f"{roof['compute_s'] * 1e6:.6g}", memory_us=f"{roof['memory_s'] * 1e6:.6g}",
        collective_us=f"{roof['collective_s'] * 1e6:.6g}", dominant=roof['dominant'],
        launches=json.dumps({n: v['launches'] for n, v in k.items()}),
        transpose_bytes_min=f"{rec['transpose_bytes_min']:.6g}", constants='datasheet',
        step_s=rec['step_s'])


#: ``[lm] check=step_stats``: a real decode step's products counted by
#: ``launch.hlostats`` against the dense products' 2 N B (N the linear
#: weights and the tied head); attention over the 2112-slot cache adds
#: 4 B cap H hd a layer, about 12% for internlm2-1.8b at 8 x 2048
STATS_ARCH, STATS_FACTOR = 'internlm2-1.8b', 1.25


def lm_decode_stats(cfg, params, eng, caches, last, pos: int, B: int) -> None:
    """One decode step of ``eng`` on the card under ``hlostats.count``:
    its products must be the dense products' plus attention's over the
    cache, exactly, and within ``STATS_FACTOR`` of 2 N B."""
    with hlostats.count() as st:
        eng.decode(caches, last, pos)
        torch.cuda.synchronize()
    s = st.analyze()
    n = _linear_weights({k: v for k, v in params.items() if k != 'embed'})
    dense = 2.0 * (n + (cfg.vocab_size * cfg.d_model if cfg.tie_embeddings else 0)) * B
    cap = caches['blocks']['0_attn']['k'].shape[2]
    attn = 4.0 * B * cap * cfg.num_heads * cfg.head_dim * cfg.num_layers
    ratio = s['dot_flops'] / dense
    if s['dot_flops'] != dense + attn or not 1.0 <= ratio <= STATS_FACTOR:
        raise AssertionError(f"lm step stats: {s['dot_flops']:.6g} product flops, dense "
                             f"{dense:.6g} + attention {attn:.6g}")
    say('lm', arch=cfg.name, check='step_stats', dot_flops=f"{s['dot_flops']:.6g}",
        dense_2NB=f"{dense:.6g}", ratio=f"{ratio:.4g}", factor=STATS_FACTOR,
        by_dtype=json.dumps(s['dot_flops_by_dtype']), ops=s['ops'],
        hbm_bytes_proxy=f"{s['hbm_bytes_proxy']:.6g}", copies=json.dumps(s['copies']),
        collectives=json.dumps(s['collective_counts']))


def phase_cost() -> None:
    """The cost model on the host: reports and the selector's picks,
    each of which must plan."""
    t0 = time.perf_counter()
    for rows, cols in ((512, 512), (2, 2)):
        report = fft.plan((N, N, N), abstract_fft_mesh(rows, cols)).cost_report()
        for line in report.splitlines():
            print(f"[cost] {line}", flush=True)
    for (n, mesh), want in PICKS.items():
        am = abstract_fft_mesh(*mesh)
        for make, pick in zip((fft.plan, fft.rplan), want):
            real = make is fft.rplan
            sel = costlib.select((n,) * 3, ('x', 'y', None), am.shape, real=real,
                                 measured=None)
            if (sel.strategy, sel.overlap_chunks, sel.method) != pick:
                raise AssertionError(f"cost: {n}^3 on {mesh} real={real} picked "
                                     f"{sel.strategy}/{sel.overlap_chunks}/{sel.method}, "
                                     f"the reference picks {pick}")
            p = make((n,) * 3, am)
            if (p.comm, p.overlap_chunks, p.method) != pick:
                raise AssertionError(f"cost: {n}^3 on {mesh} real={real} planned "
                                     f"{p.comm}/{p.overlap_chunks}/{p.method}, not {pick}")
    for (n, mesh), want in PICKS_1D.items():
        am = abstract_fft_mesh(*mesh)
        for make, pick in zip((fft.plan, fft.rplan), want):
            p = make((n,), am)
            if (p.comm, p.overlap_chunks, p.method) != pick:
                raise AssertionError(f"cost: rank 1 n={n} on {mesh} real={p.real} planned "
                                     f"{p.comm}/{p.overlap_chunks}/{p.method}, the "
                                     f"reference picks {pick}")
    say('cost', picks=2 * (len(PICKS) + len(PICKS_1D)),
        ms=f"{(time.perf_counter() - t0) * 1e3:.3f}")


def main() -> None:
    t_start = time.perf_counter()
    card, ptxas = phase_card()
    gen = torch.Generator(device='cuda').manual_seed(SEED)
    rec = phase_kernels(gen, ptxas)
    phase_cost()
    # each path runs its own kernels and no other, so a kernel's count is
    # the one from the path that launched it
    paths = [
        phase_path('default', gen, 'four_step', {'fft_matmul': 3}),
        phase_path('stockham', gen, 'stockham', {'fft_fused': 2, 'fft_pencil': 1},
                   method='stockham'),
        phase_path('block', gen, 'block', {'fft_block': 3}, method='block'),
        phase_path('real', gen, 'four_step', {'fft_matmul': 3}, real=True),
        phase_path('real_block', gen, 'block', {'fft_block': 3}, real=True,
                   method='block'),
        # 8 chunks of each of two (fft, swap) pairs, then the last fft
        phase_path('overlap', gen, 'four_step', {'fft_matmul': 17}, chunks=8,
                   overlap_chunks=8),
        phase_path('stockham_overlap', gen, 'stockham', {'fft_pencil': 17}, chunks=8,
                   unchunked_rtol=STOCKHAM_OVERLAP_RTOL, method='stockham',
                   overlap_chunks=8),
        # r2c: 8 chunks; middle pair serial (257 bins); last fft; mirrored
        phase_path('real_overlap', gen, 'four_step', {'fft_matmul': 10}, real=True,
                   chunks=8, overlap_chunks=8),
        # rank 1, 4096 x 4096: columns (with the twiddle), then rows
        phase_path('large1d', gen, 'four_step', {'fft_matmul': 2}, shape=LARGE1D,
                   batch=LARGE1D_BATCH),
        phase_path('large1d_stockham', gen, 'stockham', {'fft_fused': 2}, shape=LARGE1D,
                   batch=LARGE1D_BATCH, twiddled=1, method='stockham'),
        # r2c columns at 2048, rows at 4096
        phase_path('rlarge1d', gen, 'four_step', {'fft_matmul': 2}, real=True,
                   shape=LARGE1D, batch=LARGE1D_BATCH),
    ]
    rec_long, long_paths, on_long = phase_long(gen, ptxas)
    paths += long_paths
    t_new = time.perf_counter()
    paths += [
        phase_unfused('default_unfused', gen, {'fft_matmul': 3}, 0.0),
        phase_unfused('stockham_unfused', gen, {'fft_pencil': 3}, STOCKHAM_OVERLAP_RTOL,
                      method='stockham'),
    ]
    with fuse_env('0'):
        # columns, then rows, each its own fft_pencil; the twiddle apart
        paths.append(phase_path('large1d_stockham_unfused', gen, 'stockham', {'fft_pencil': 2},
                                shape=LARGE1D, batch=LARGE1D_BATCH, method='stockham'))
    paths += [check_fft3d(gen), check_apply_block(gen), phase_factor_order(gen),
              check_kernel_stats(gen)]
    check_matmul_factors(gen)
    phase_dryrun_fft(phase_dryrun())
    phase_examples()
    phase_paper(card)
    phase_bench()
    say('new_phases', seconds=f"{time.perf_counter() - t_new:.3g}")
    paths += phase_op(gen)
    paths += phase_serve(gen)
    paths += phase_service(gen)
    phase_grad()
    phase_lm()
    train_launches, train_rec = phase_train(gen)
    paths.append(train_launches)
    for name, r in train_rec.items():
        rec[name]['train'] = r
    launches = {k: sum(t[k] for t in paths) for k in paths[0]}
    out = []
    for name, meta in KERNELS.items():
        n_launch = launches.get(COUNTER[name], 0)
        if n_launch == 0:
            raise AssertionError(f"{name} was not launched on the main path")
        out.append(dict(name=name, route='cuda', **meta, launches=n_launch,
                        **{k: rec[name][k] for k in JSON_KEYS}))
        if 'rank1' in rec[name]:
            out[-1]['rank1'] = [{k: r[k] for k in RANK1_KEYS} for r in rec[name]['rank1']]
        if 'train' in rec[name]:
            out[-1]['train'] = {k: rec[name]['train'][k] for k in TRAIN_KEYS}
        out[-1]['long'] = [{k: r[k] for k in LONG_KEYS} for r in rec_long[name]]
        out[-1]['launches_long'] = on_long[COUNTER[name]]
    say('total', seconds=f"{time.perf_counter() - t_start:.4g}")
    print(json.dumps({'kernels': out}), flush=True)
    print(card, flush=True)
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu',
                                             'kind': torch.cuda.get_device_name(0),
                                             'count': torch.cuda.device_count()}}),
          flush=True)


if __name__ == '__main__':
    main()
