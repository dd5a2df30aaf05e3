"""A run with the timed path broken underneath comes out not correct.

The harness's look for a card is skipped: the rest of a run (set-up, the
window, the kept outputs, the reference and the comparison) is driven on
the CPU at a small size, with the port's entry point replaced by a broken
one, once for each fault these one-chip cells can have.  (They exchange
nothing between chips, so that fault has no place here.)"""

import pytest
import torch

import dirt_tpu_torch
from bench_h100.harness import runner

from .conftest import cell_from_files, tiny

DIRECT = dirt_tpu_torch.rasterise_batch
DEFERRED = dirt_tpu_torch.rasterise_batch_deferred


def _bump(pixels):
    bump = torch.zeros_like(pixels)
    bump[:, 0, 0, 0] = 0.01
    return pixels + bump


def _half(render, background, vertices, values, faces, *rest):
    half = background.shape[0] // 2
    pixels = render(background[:half], vertices[:half], values[:half],
                    faces[:half], *rest)
    return torch.cat([pixels, pixels], dim=0)


# Direct entry point (rasterise_batch) and deferred (..._deferred, with
# the shader): each fault once.
FAULTS = {
    # A step that returns its state unchanged: nothing rendered.
    "unchanged": (lambda bg, v, c, f, **kw: bg * 1.0,
                  lambda bg, v, a, f, shader, **kw: shader(bg * 1.0)),
    # Half of the batch left out: the first half stands in for the rest.
    "half_batch": (lambda *args, **kw: _half(DIRECT, *args),
                   lambda *args, **kw: _half(DEFERRED, *args)),
    # An answer altered where it is produced: a pixel of each image.
    "altered": (lambda *args, **kw: _bump(DIRECT(*args, **kw)),
                lambda *args, **kw: _bump(DEFERRED(*args, **kw))),
}
CELLS = {
    "cyl65536_b4_512.distant": lambda: tiny(cell_from_files(
        "cyl65536_b4_512", "distant", "cyl65536_b4_512.distant"),
        segments=16),
    "cyl65536_b4_512.deferred": lambda: tiny("cyl65536_b4_512.deferred",
                                             segments=16),
    "cyl512_b16_256.orbit": lambda: tiny(cell_from_files(
        "cyl512_b16_256", "orbit", "cyl512_b16_256.orbit"), segments=16),
}


def _run(cell):
    return runner.measure(cell, 2 ** 31 + 11, 0.2, 0, "cpu", 0.0)


@pytest.mark.parametrize("name", sorted(CELLS))
def test_a_sound_run_is_correct(name, blocks_on_cpu):
    result = _run(CELLS[name]())
    assert result.correct, result.numbers
    assert result.steps >= 1 and result.failed == 0


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", sorted(CELLS))
def test_a_broken_step_is_not_correct(name, fault, blocks_on_cpu,
                                      monkeypatch):
    direct, deferred = FAULTS[fault]
    monkeypatch.setattr(dirt_tpu_torch, "rasterise_batch", direct)
    monkeypatch.setattr(dirt_tpu_torch, "rasterise_batch_deferred", deferred)
    result = _run(CELLS[name]())
    assert not result.correct, (fault, result.numbers)
