"""The readers of the port's stage spans and schedule counters on
synthetic records: two device-only steps then two steps with the host's
activity, each a forward entry with its stages and a gradient entry with
its own; only the first two steps are read, and nothing where the port
recorded nothing or another count of entries."""

from types import SimpleNamespace

import pytest

from bench_h100.harness import spec
from dirt_tpu_torch.utils import profiling

STEPS = 2           # in each of the two profiles
BATCH = 4
# name: (host ns, stream ms) a step of the device-only profile; the
# profile with the host's activity reads ten times as much.
STAGES = {
    "dirt.forward": (9_000_000, 8.0),
    "dirt.forward.table": (1_000_000, 0.5),
    "dirt.forward.hits": (2_000_000, 4.0),
    "dirt.forward.runs": (1_000_000, 0.25),
    "dirt.forward.sweep": (1_000_000, 2.0),
    "dirt.forward.finalize": (1_000_000, 1.0),
    "dirt.backward": (12_000_000, 9.0),
    "dirt.backward.prepass": (1_000_000, 0.75),
    "dirt.backward.table": (1_000_000, 0.5),
    "dirt.backward.hits": (2_000_000, 5.0),
    "dirt.backward.runs": (1_000_000, 0.125),
    "dirt.backward.reduce": (1_000_000, 1.5),
    "dirt.backward.scatter": (1_000_000, 0.5),
}
COUNTERS = {"dirt.forward.runs": {"forward.visits": 800,
                                  "forward.dropped": 0},
            "dirt.backward.runs": {"backward.dropped": 3}}
EXPECTED = {
    "ops.forward.hits.stream_ms": 4.0,
    "ops.forward.pack.stream_ms": 0.75,
    "ops.forward.sweep.stream_ms": 3.0,
    "ops.backward.prepass.stream_ms": 0.75,
    "ops.backward.hits.stream_ms": 5.0,
    "ops.backward.pack.stream_ms": 0.625,
    "ops.backward.reduce.stream_ms": 2.0,
    "ops.dispatch.host_ms": 21.0,
    "ops.forward.visits_per_frame": 800 / BATCH,
    "ops.schedule.dropped_per_step": 3.0,
}


def synthetic(steps=2 * STEPS, entry_names=("dirt.forward",)):
    """The records of `steps` steps, out of order, the second profile's
    ten times the first's; each step's spans one after another from its
    start (a stand-in for the nesting, which the readers do not read)."""
    spans = []
    for k in range(steps):
        scale = 1 if k < STEPS else 10
        t = k * 10 ** 9
        for name, (ns, ms) in STAGES.items():
            if name == "dirt.forward" and name not in entry_names:
                continue
            counters = {c: v * scale
                        for c, v in COUNTERS.get(name, {}).items()}
            spans.append(SimpleNamespace(
                name=name, start_ns=t, end_ns=t + ns * scale,
                stream_ms=ms * scale, counters=counters))
            t += 1
    return spans[::-1]


def readings(trace=True):
    profile = lambda: SimpleNamespace(steps=STEPS)
    return SimpleNamespace(trace=profile() if trace else None,
                           span_trace=profile() if trace else None,
                           batch=BATCH)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_each_reader_reads_the_device_only_steps(name, monkeypatch):
    monkeypatch.setattr(profiling, "records", lambda: synthetic())
    value = spec.metric_reader(name)(readings())
    assert value == pytest.approx(EXPECTED[name])


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_each_reader_reads_nothing_without_its_records(name, monkeypatch):
    read = spec.metric_reader(name)
    monkeypatch.setattr(profiling, "records", lambda: [])
    assert read(readings()) is None
    # Another count of entry spans: a profile taken again, or none.
    for steps in (2 * STEPS - 1, 2 * STEPS + 1):
        monkeypatch.setattr(profiling, "records",
                            lambda: synthetic(steps))
        assert read(readings()) is None
    monkeypatch.setattr(profiling, "records",
                        lambda: synthetic(entry_names=()))
    assert read(readings()) is None
    monkeypatch.setattr(profiling, "records", lambda: synthetic())
    assert read(readings(trace=False)) is None
    # A port without the recorder, as ports before it were.
    monkeypatch.delattr(profiling, "records")
    assert read(readings()) is None


def test_stream_times_need_the_card(monkeypatch):
    def on_cpu():
        spans = synthetic()
        for r in spans:
            r.stream_ms = None
        return spans
    monkeypatch.setattr(profiling, "records", on_cpu)
    assert spec.metric_reader("ops.forward.hits.stream_ms")(
        readings()) is None
    assert spec.metric_reader("ops.dispatch.host_ms")(
        readings()) == pytest.approx(21.0)
