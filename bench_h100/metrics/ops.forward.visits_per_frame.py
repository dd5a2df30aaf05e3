"""ops.forward.visits_per_frame: the forward schedule's live tile-block
visits an image (the port's forward.visits counter, the CSR runs' counts
summed: K1's work), over the traced steps' images."""

from bench_h100.harness.stages import counted


def read(readings):
    visits = counted(readings, "forward.visits")
    if visits is None:
        return None
    return visits / (readings.trace.steps * readings.batch)
