"""ops.dispatch.host_ms: host wall ms a traced step inside the port's
entry spans, dirt.forward and dirt.backward (rasterise_ops' autograd
Function): the port's own dispatch and launches, without the benchmark's
scene math and loss or the autograd engine around them; the device-only
profile's steps."""

from bench_h100.harness.stages import host_ms


def read(readings):
    return host_ms(readings, "dirt.forward", "dirt.backward")
