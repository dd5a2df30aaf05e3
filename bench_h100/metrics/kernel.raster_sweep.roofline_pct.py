"""kernel.raster_sweep.roofline_pct: K1's (csrc/raster_sweep.cu) least
time on the traced steps' inputs (work.sweep_work: its function's bytes
at 3.35 TB/s or its operations at 67 TFLOP/s, whichever is longer) over
its device time on those steps, in %."""

from bench_h100.harness.placed import roofline_pct
from bench_h100.harness.work import sweep_work

KERNEL = "raster_sweep_kernel"


def read(readings):
    return roofline_pct(readings, KERNEL, sweep_work)
