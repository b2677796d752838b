"""Paper Table 2: wsFFT against the fastest FFTs the paper quotes
(Summit/HeFFTe, cuFFT on a DGX A100, the TPU-v3 DFT, Takahashi), from
the port's ``repro_torch.core.wse_model``.

The counterpart of ``benchmarks/paper_table2.py``, line for line. The
wsFFT rows follow from Table 1 and Eqs. 10/11, the others are the
paper's quoted numbers; the claim checked is wsFFT 512^3 FP32 at 18.9
TF/s, 18% over the DGX's 16 TF/s. These are the paper's machines, not
the port's GPU.

    python3 benchmarks/torch_paper_table2.py
"""
from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                'src'))

from repro_torch.core import wse_model as wm  # noqa: E402


def main() -> None:
    print("# paper_table2: cross-machine comparison (TF/s)")
    print("size,precision,system,tflops")
    for size, prec, system, tf in wm.TABLE2:
        print(f"{size}^3,{prec},{system},{tf}")
    ours = wm.tflops(512, wm.TABLE1_CYCLES[512]['fp32'])
    dgx = 16.0
    print(f"# claim: wsFFT 512^3 fp32 {ours:.1f} TF/s vs DGX {dgx} TF/s "
          f"-> {100 * (ours / dgx - 1):.0f}% faster (paper: 18%)")


if __name__ == "__main__":
    main()
