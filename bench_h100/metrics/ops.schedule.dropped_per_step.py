"""ops.schedule.dropped_per_step: tile-block visits a traced step that the
forward's and the gradient's schedules truncated at their slot budgets
(the port's forward.dropped and backward.dropped counters); 0 on a sound
run."""

from bench_h100.harness.stages import counted


def read(readings):
    dropped = counted(readings, "forward.dropped", "backward.dropped")
    if dropped is None:
        return None
    return dropped / readings.trace.steps
