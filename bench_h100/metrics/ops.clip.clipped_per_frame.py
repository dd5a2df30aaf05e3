"""ops.clip.clipped_per_frame: the faces an image whose pixel bbox came
from the near/far clip (a corner at w <= 0, a part left inside the
planes; the port's forward.clipped counter in the dirt.forward.table
span, which both passes' tables share), over the traced steps' images.
Nothing where the port counts none."""

from bench_h100.harness.stages import counted


def read(readings):
    faces = counted(readings, "forward.clipped")
    if faces is None:
        return None
    return faces / (readings.trace.steps * readings.batch)
