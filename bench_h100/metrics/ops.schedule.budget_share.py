"""ops.schedule.budget_share: the fullest image's tile-block visits, kept
and dropped, over its static slot budget (%), the larger of the forward's
and the gradient's schedules over the traced steps.  The port's
forward.budget and backward.budget counters (in the dirt.<pass>.runs
spans) give each step's fullest image in parts per million of its
budget.  At 100% the schedule starts to drop visits.  Nothing where the
port counts none."""

from bench_h100.harness.stages import traced_records

NAMES = ("forward.budget", "backward.budget")
PARTS_PER_PERCENT = 10 ** 4


def read(readings):
    spans = traced_records(readings)
    if spans is None:
        return None
    shares = [r.counters[name] for r in spans for name in NAMES
              if name in r.counters]
    if not shares:
        return None
    return max(shares) / PARTS_PER_PERCENT
