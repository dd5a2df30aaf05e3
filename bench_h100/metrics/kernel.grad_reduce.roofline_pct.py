"""kernel.grad_reduce.roofline_pct: K3's (csrc/grad_reduce.cu) least time
on the traced steps' inputs (work.reduce_work: its function's bytes at
3.35 TB/s or its operations at 67 TFLOP/s, whichever is longer) over its
device time on those steps, in %."""

from bench_h100.harness.placed import roofline_pct
from bench_h100.harness.work import reduce_work

KERNEL = "grad_reduce_kernel"


def read(readings):
    return roofline_pct(readings, KERNEL, reduce_work)
