"""ops.clip.culled_per_frame: the faces an image that the near/far clip
left with nothing (the empty bbox: never drawn; the port's forward.culled
counter in the dirt.forward.table span, which both passes' tables
share), over the traced steps' images.  Nothing where the port counts
none."""

from bench_h100.harness.stages import counted


def read(readings):
    faces = counted(readings, "forward.culled")
    if faces is None:
        return None
    return faces / (readings.trace.steps * readings.batch)
