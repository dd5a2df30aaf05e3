"""The reader of K1's longest block, ops.forward.chain_visits, on
synthetic records: the largest forward.chain of the device-only
profile's steps, and nothing where the port counts none."""

from types import SimpleNamespace

import pytest

from bench_h100.harness import spec
from dirt_tpu_torch.utils import profiling

NAME = "ops.forward.chain_visits"


def step_spans(k, chain):
    """One step's records: the forward entry and its sweep span, with the
    chain counter where `chain` is not None."""
    t = 10 ** 9 * k
    counters = {} if chain is None else {"forward.chain": chain}
    span = lambda name, counters, dt: SimpleNamespace(
        name=name, start_ns=t + dt, end_ns=t + dt + 1, stream_ms=1.0,
        counters=counters)
    return [span("dirt.forward", {}, 0),
            span("dirt.forward.sweep", counters, 1)]


def readings(steps):
    profile = SimpleNamespace(steps=steps)
    return SimpleNamespace(trace=profile, span_trace=profile, batch=32)


def test_the_reader_reads_the_longest_block(monkeypatch):
    # Two device-only steps, then two with the host's activity (not read).
    spans = (step_spans(0, 96) + step_spans(1, 128) + step_spans(2, 700)
             + step_spans(3, 700))
    monkeypatch.setattr(profiling, "records", lambda: spans[::-1])
    assert spec.metric_reader(NAME)(readings(2)) == pytest.approx(128.0)


def test_the_reader_reads_nothing_without_the_counter(monkeypatch):
    # A port that counts no chain, as the port before K1's split.
    read = spec.metric_reader(NAME)
    spans = step_spans(0, None) + step_spans(1, None)
    monkeypatch.setattr(profiling, "records", lambda: spans)
    assert read(readings(1)) is None
    monkeypatch.setattr(profiling, "records", lambda: [])
    assert read(readings(1)) is None
    monkeypatch.delattr(profiling, "records")
    assert read(readings(1)) is None
