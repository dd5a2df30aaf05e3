"""setup_s: from the process's start to the window's first step: imports,
CUDA context, inputs, the kernel library (built in a fresh checkout) and
the warm-up steps, host clock."""


def read(readings):
    return readings.setup_s
