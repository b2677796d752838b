"""Paper Figures 5/6/7: weak scaling (TF/s), network bandwidth (TB/s)
and strong scaling, from the published Table 1 cycles and the paper's
Eqs. 8-12, through the port's ``repro_torch.core.wse_model``.

The counterpart of ``benchmarks/paper_fig567.py``, line for line:

* Fig 5: n^3 on n x n PEs, TF/s = 3 n^2 * 5 n log2 n / runtime;
* Fig 6: total router bandwidth under broadcast-and-filter hop counting;
* Fig 7: strong scaling, 256^3 on 64/128/256 meshes, 512^3 on 256/512,
  1024^3 on 512/1024; the m > 1 points estimated by Eq. 11, as the
  paper's starred points are.

Rates of the CS-2 wafer, not of the port's GPU.

    python3 benchmarks/torch_paper_fig567.py
"""
from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                'src'))

from repro_torch.core import wse_model as wm  # noqa: E402


def main() -> None:
    print("# paper_fig5: weak scaling TF/s (n^3 on n x n PEs)")
    print("n,fp16_tflops,fp32_tflops")
    for n in wm.TABLE1_CYCLES:
        print(f"{n},{wm.tflops(n, wm.TABLE1_CYCLES[n]['fp16']):.2f},"
              f"{wm.tflops(n, wm.TABLE1_CYCLES[n]['fp32']):.2f}")
    # the hypothetical n = 1024 machine (Eq. 10)
    print(f"1024,{wm.tflops(1024, wm.et_total_1024('fp16')):.2f},"
          f"{wm.tflops(1024, wm.et_total_1024('fp32')):.2f}  # Eq.10 estimate")

    print("# paper_fig6: router bandwidth TB/s")
    print("n,fp16_tbs,fp32_tbs")
    for n in wm.TABLE1_CYCLES:
        print(f"{n},{wm.router_bw_pbs(n, 'fp16') * 1e3:.1f},"
              f"{wm.router_bw_pbs(n, 'fp32') * 1e3:.1f}")
    print(f"# 512 fp32: {wm.router_bw_pbs(512, 'fp32'):.2f} PB/s (paper: 0.8)")

    print("# paper_fig7: strong scaling TF/s")
    print("problem,mesh,m,precision,tflops,estimated")
    for n in (256, 512):
        for prec in ('fp16', 'fp32'):
            p = n
            m = 1
            while p >= 64 and m <= 4:
                cyc = (wm.TABLE1_CYCLES[n][prec] if m == 1
                       else wm.et_total_strong(n, m, prec))
                print(f"{n}^3,{p}x{p},{m},{prec},{wm.tflops(n, cyc):.2f},"
                      f"{'no' if m == 1 else 'yes'}")
                p //= 2
                m *= 2
    for prec in ('fp16', 'fp32'):
        print(f"1024^3,1024x1024,1,{prec},"
              f"{wm.tflops(1024, wm.et_total_1024(prec)):.2f},yes")
        print(f"1024^3,512x512,2,{prec},"
              f"{wm.tflops(1024, wm.et_total_1024_strong(2, prec)):.2f},yes")
    # the paper's quoted speedups of 256^3 fp32 strong scaling
    s1 = wm.et_total_strong(256, 4, 'fp32') / wm.et_total_strong(256, 2, 'fp32')
    s2 = wm.et_total_strong(256, 2, 'fp32') / wm.TABLE1_CYCLES[256]['fp32']
    print(f"# 256^3 fp32 speedups: 64->128 mesh {s1:.2f}x (paper 2.85x), "
          f"128->256 mesh {s2:.2f}x (paper 2.54x) — reconstruction uses the "
          "modelled compute split; paper used its measured phase timers")


if __name__ == "__main__":
    main()
