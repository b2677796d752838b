"""Paper Table 1: the CS-2's measured cycles of 3-D FFTs, n = 32..512,
FP16/FP32, against the paper's closed-form model (Eqs. 1-4 and the
§5.1 pencil cycle model), from the port's ``repro_torch.core.wse_model``.

The counterpart of ``benchmarks/paper_table1.py``, line for line: the
model is a lower bound (it leaves out the task dispatch and queueing
the measurements include), and the headline numbers (959 us, 18.9/32.7
TF/s) follow exactly from the published cycle counts. Every number is a
cycle count, time or rate of the CS-2 wafer, not of a GPU.

    python3 benchmarks/torch_paper_table1.py
"""
from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                'src'))

from repro_torch.core import wse_model as wm  # noqa: E402


def emit(name: str, us_per_call: float, derived: str = "") -> None:
    print(f"{name},{us_per_call:.3f},{derived}")


def main() -> None:
    print("# paper_table1: measured vs model cycles")
    print("n,precision,measured_cycles,model_cycles,rel_err,us_measured,tflops")
    for row in wm.table1_report():
        print(f"{row['n']},{row['precision']},{row['measured']},{row['model']},"
              f"{row['rel_err']:+.3f},{row['us_measured']:.1f},"
              f"{row['tflops_measured']:.2f}")
    emit("table1/512_fp32_us", wm.runtime_us(wm.TABLE1_CYCLES[512]['fp32']),
         "paper=959us")
    emit("table1/512_fp32_tflops", 0.0,
         f"derived={wm.tflops(512, wm.TABLE1_CYCLES[512]['fp32']):.2f} paper=18.9")
    emit("table1/512_fp16_tflops", 0.0,
         f"derived={wm.tflops(512, wm.TABLE1_CYCLES[512]['fp16']):.2f} paper=32.7")


if __name__ == "__main__":
    main()
