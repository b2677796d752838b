"""Port parity for the paper side of ``repro_torch.core.wse_model``: every
name equal (``==``, the same float arithmetic) to ``repro.core.wse_model``'s
over the Table 1 sizes, 1024 where the reference defines it, FP16/FP32
and m in {1, 2, 4}; then the paper's own claims, as
``tests/test_wse_model.py`` checks them, run against the port's module.
These are cycles and rates of the CS-2 wafer, not of a GPU."""
import pytest

from repro.core import wse_model as rwm
from repro_torch.core import wse_model as twm

SIZES = tuple(rwm.TABLE1_CYCLES)
PRECS = ('fp16', 'fp32')
MS = (1, 2, 4)

CONSTANTS = ('WORD_BYTES', 'CLOCK_HZ', 'TABLE1_CYCLES', 'PAPER_512_FP32_US',
             'PAPER_512_TFLOPS', 'PAPER_1024_TFLOPS_EST', 'PAPER_PENCIL_FLOPS_PER_CYCLE',
             'PAPER_PENCIL_ASYMPTOTE', 'PAPER_BISECTION_TBS', 'PAPER_ROUTER_BW_PBS', 'TABLE2')


@pytest.mark.parametrize("name", CONSTANTS)
def test_constants_equal(name):
    assert getattr(twm, name) == getattr(rwm, name)


#: (function, argument tuples)
CALLS = (
    [('fft_flops_1d', (n,)) for n in SIZES + (1024, 4096)]
    + [('fft_flops_3d', (n,)) for n in SIZES + (1024,)]
    + [('pencil_flops_per_cycle', (n, p)) for n in (16,) + SIZES + (1024, 2048, 4096)
       for p in PRECS]
    + [('pencil_asymptote', (p,)) for p in PRECS]
    + [('measured_split', (n, p)) for n in SIZES for p in PRECS]
    + [('et_total_strong', (n, m, p)) for n in SIZES for m in MS for p in PRECS]
    + [('et_total_1024', (p,)) for p in PRECS]
    + [('et_total_1024_strong', (m, p)) for m in MS for p in PRECS]
    + [('tflops', (n, rwm.TABLE1_CYCLES[n][p])) for n in SIZES for p in PRECS]
    + [('tflops', (1024, rwm.et_total_1024(p))) for p in PRECS]
    + [('router_bytes_total', (n, p)) for n in SIZES + (1024,) for p in PRECS]
    + [('router_bw_pbs', (n, p)) for n in SIZES for p in PRECS]
    + [('bisection_bw_tbs', (n,)) for n in SIZES + (1024,)]
    + [('comm_lower_bound_2d', (n,)) for n in SIZES + (1024,)]
    + [('runtime_us', (rwm.TABLE1_CYCLES[n][p],)) for n in SIZES for p in PRECS]
    + [('total_cycles_model', (n, m, p)) for n in SIZES for m in MS for p in PRECS]
    + [('table1_report', ())]
)


@pytest.mark.parametrize("name, args", CALLS, ids=[f"{c[0]}{list(c[1])}" for c in CALLS])
def test_function_equal(name, args):
    assert getattr(twm, name)(*args) == getattr(rwm, name)(*args)


# ---------------------------------------------------------------------------
# The paper's claims, against the port's module
# ---------------------------------------------------------------------------

def test_headline_959us():
    """§9: 959 microseconds for the 512^3 FP32 FFT."""
    assert abs(twm.runtime_us(twm.TABLE1_CYCLES[512]['fp32']) - twm.PAPER_512_FP32_US) < 1.0


@pytest.mark.parametrize("prec", PRECS)
def test_headline_tflops(prec):
    """§5.3: 18.9 TF/s FP32 and 32.7 TF/s FP16 at n = 512."""
    assert abs(twm.tflops(512, twm.TABLE1_CYCLES[512][prec])
               - twm.PAPER_512_TFLOPS[prec]) < 0.1


def test_table2_dgx_claim():
    """§5.4: wsFFT 18% faster than the fastest DGX 512^3 FP32 result."""
    ours = twm.tflops(512, twm.TABLE1_CYCLES[512]['fp32'])
    assert abs((ours / 16.0 - 1) - 0.18) < 0.01


def test_model_tracks_table1():
    """The closed-form model within 30% of every measured count, below it."""
    for row in twm.table1_report():
        assert -0.30 < row['rel_err'] < 0.0, row


def test_pencil_endpoints_and_asymptotes():
    """Fig 3: 0.89 flops/cycle FP16 at 4096 and 0.57 FP32 at 2048 (model
    within 10%); §5.1 asymptotes 5/3 and 5/6.5, approached from below."""
    for prec in PRECS:
        n, v = twm.PAPER_PENCIL_FLOPS_PER_CYCLE[prec]
        assert abs(twm.pencil_flops_per_cycle(n, prec) - v) / v < 0.10
        assert abs(twm.pencil_asymptote(prec) - twm.PAPER_PENCIL_ASYMPTOTE[prec]) < 0.02
    prev = 0.0
    for lg in range(6, 23, 4):
        cur = twm.pencil_flops_per_cycle(1 << lg, 'fp16')
        assert prev < cur < twm.pencil_asymptote('fp16')
        prev = cur


def test_strong_scaling_speedups():
    """§5.3: 2.85x scaling 256^3 FP32 from 64x64 to 128x128, 2.54x on the
    next step (reconstruction within 5%)."""
    s1 = twm.et_total_strong(256, 4, 'fp32') / twm.et_total_strong(256, 2, 'fp32')
    s2 = twm.et_total_strong(256, 2, 'fp32') / twm.TABLE1_CYCLES[256]['fp32']
    assert abs(s1 - 2.85) / 2.85 < 0.05, s1
    assert abs(s2 - 2.54) / 2.54 < 0.05, s2


def test_1024_estimates():
    """Table 2's starred rows: 36.0 TF/s FP16 and 22.5 FP32 for 1024^3 on
    a 512 x 512 submesh (m = 2)."""
    fp16 = twm.tflops(1024, twm.et_total_1024_strong(2, 'fp16'))
    fp32 = twm.tflops(1024, twm.et_total_1024_strong(2, 'fp32'))
    assert abs(fp16 - 36.0) / 36.0 < 0.05, fp16
    assert abs(fp32 - 22.5) / 22.5 < 0.10, fp32


def test_bandwidths():
    """§6.2: 3.5 TB/s bisection of a 512 x 512 mesh; §5.3: 0.8 PB/s of
    router bandwidth at n = 512 FP32."""
    assert abs(twm.bisection_bw_tbs(512) - twm.PAPER_BISECTION_TBS) < 0.1
    assert abs(twm.router_bw_pbs(512, 'fp32') - twm.PAPER_ROUTER_BW_PBS) / 0.8 < 0.10


def test_comm_share_and_ratio():
    """§9: the transposes dominate (70-90% at 512 FP32); §5.3: FP32
    communication at 512 is about 1.8x FP16's."""
    _, c32 = twm.measured_split(512, 'fp32')
    _, c16 = twm.measured_split(512, 'fp16')
    assert 0.70 < c32 / twm.TABLE1_CYCLES[512]['fp32'] < 0.90
    assert abs(c32 / c16 - 1.8) < 0.15


def test_flop_count_definition():
    assert twm.fft_flops_1d(512) == 5 * 512 * 9
    assert twm.fft_flops_3d(512) == 3 * 512 ** 2 * 5 * 512 * 9
