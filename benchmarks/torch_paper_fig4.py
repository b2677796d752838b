"""Paper Figure 4: the 3-D FFT's cycles split into communication and
computation, divided by n^2 (weak scaling, one pencil a PE), from the
port's ``repro_torch.core.wse_model``.

The counterpart of ``benchmarks/paper_fig4.py``, line for line:
compute is three times the pencil cycle model, communication the rest
of Table 1's total; comm/n^2 tends to 1 (FP16) and 2 (FP32) as n grows
(Eqs. 3-4). CS-2 cycles throughout.

    python3 benchmarks/torch_paper_fig4.py
"""
from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                'src'))

from repro_torch.core import wse_model as wm  # noqa: E402


def main() -> None:
    print("# paper_fig4: cycles/n^2 breakdown (reconstructed)")
    print("n,precision,compute_per_n2,comm_per_n2,total_per_n2,comm_share")
    for n in wm.TABLE1_CYCLES:
        for prec in ('fp16', 'fp32'):
            cmpt, comm = wm.measured_split(n, prec)
            tot = wm.TABLE1_CYCLES[n][prec]
            print(f"{n},{prec},{cmpt / n**2:.3f},{comm / n**2:.3f},"
                  f"{tot / n**2:.3f},{comm / tot:.2f}")
    # §9: the transposes dominate, up to 80% at the sizes of interest
    _, comm512 = wm.measured_split(512, 'fp32')
    print(f"# comm share at 512 fp32: {comm512 / wm.TABLE1_CYCLES[512]['fp32']:.2f} "
          "(paper: transposes dominate, up to 80%)")
    # §5.3: FP32 communication at n = 512 is 1.8x FP16's
    _, c16 = wm.measured_split(512, 'fp16')
    print(f"# fp32/fp16 comm ratio at 512: {comm512 / c16:.2f} (paper: 1.8x)")


if __name__ == "__main__":
    main()
