"""dirt_tpu_torch's slot-schedule gradient (grad_blocks.FUSED off) against
dirt_tpu's, on the CPU.

Both packages start from dirt_tpu's reference forward residuals (numpy).
dirt_tpu runs its slot gradient (grad_blocks.FUSED off, Pallas interpret
mode) at its slot shapes, 16x128 tiles and 128-face blocks; the port runs
grad_blocks.rasterise_grad_batch with FUSED off at the same shapes, K6
slot_grad_reduce here in its plain version.  grad_background must be
equal, the vertex and colour gradients within max |a - b| / max(max |a|,
1) <= 3e-6 (tests/test_torch_backward.py's tolerance: dirt_tpu's slot
gradient takes its XLA pre-pass and sums in another order), for parts
"all", "position" and "color" and for a colour cotangent.  At the port's
GPU shapes the slot and fused schedules give the same gradients bit for
bit.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dirt_tpu.ops import backward as jbackward
from dirt_tpu.ops import dispatch as jdispatch
from dirt_tpu.ops import grad_blocks as jgrad_blocks
from dirt_tpu_torch.ops import forward_blocks, grad_blocks
from dirt_tpu_torch.ops.reference import RasterAux


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread for this file: the suite runs files in
    parallel processes, and a thread pool per core in each of them
    oversubscribes the cores (torch's small CPU ops then slow down many
    times over)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


SLOT_GRAD_TILE = dict(tile_h=16, tile_w=128, chunk=128)
TOL = 3e-6
CASES = ["all", "position", "color", "cotangent"]


class Case:
    """tests/test_fused_csr.py's gradient soup (300 faces, 48x128) with
    dirt_tpu's reference forward, on both sides."""

    def __init__(self):
        rng = np.random.RandomState(5)
        v = rng.randn(2, 150, 4).astype(np.float32)
        v[..., 3] = np.abs(v[..., 3]) + 0.5
        f = rng.randint(0, 150, size=(2, 300, 3)).astype(np.int32)
        c = rng.uniform(size=(2, 150, 3)).astype(np.float32)
        bg = rng.uniform(size=(2, 48, 128, 3)).astype(np.float32)
        rng = np.random.RandomState(3)
        self.jgp = rng.randn(2, 48, 128, 3).astype(np.float32)
        self.jcot = rng.randn(2, 48, 128, 5).astype(np.float32)
        self.jv, self.jf = v, f
        self.pixels, self.aux = jdispatch.forward_batch(bg, v, c, f,
                                                        "reference")
        t = lambda a: torch.as_tensor(np.array(a))
        self.v, self.f, self.gp, self.cot = t(v), t(f), t(self.jgp), t(
            self.jcot)
        self.tpixels = t(self.pixels)
        self.taux = RasterAux(*(t(x) for x in self.aux))

    def kwargs(self, case, jax):
        if case == "cotangent":
            return dict(color_cotangent=self.jcot if jax else self.cot)
        return dict(parts=case)


@pytest.fixture(scope="module")
def case():
    return Case()


@pytest.fixture(scope="module")
def jax_slot_grads(case):
    saved = jgrad_blocks.FUSED
    jgrad_blocks.FUSED = False
    try:
        return {name: jbackward.rasterise_grad_batch(
                    case.jv, case.jf, case.pixels, jnp.asarray(case.jgp),
                    case.aux, implementation="blocks",
                    **case.kwargs(name, jax=True))
                for name in CASES}
    finally:
        jgrad_blocks.FUSED = saved


def _triple(g):
    return g.grad_background, g.grad_vertices, g.grad_vertex_colors


@pytest.mark.parametrize("name", CASES)
def test_slot_grad_matches_jax(case, jax_slot_grads, monkeypatch, name):
    monkeypatch.setattr(grad_blocks, "FUSED", False)
    got = grad_blocks.rasterise_grad_batch(
        case.v, case.f, case.tpixels, case.gp, case.taux,
        **case.kwargs(name, jax=False), **SLOT_GRAD_TILE)
    want = jax_slot_grads[name]
    np.testing.assert_array_equal(np.asarray(want.grad_background),
                                  got.grad_background.numpy())
    for field, a, b in zip(("grad_vertices", "grad_vertex_colors"),
                           _triple(want)[1:], _triple(got)[1:]):
        a, b = np.asarray(a), b.numpy()
        scale = max(np.abs(a).max(), 1.0)
        np.testing.assert_allclose(a / scale, b / scale, atol=TOL,
                                   err_msg=field)
    np.testing.assert_array_equal(np.asarray(want.debug), got.debug.numpy())


@pytest.mark.parametrize("name", CASES)
def test_slot_grad_equals_fused_at_gpu_shapes(case, monkeypatch, name):
    args = (case.v, case.f, case.tpixels, case.gp, case.taux)
    fused = grad_blocks.rasterise_grad_batch(*args,
                                             **case.kwargs(name, jax=False))
    monkeypatch.setattr(grad_blocks, "FUSED", False)
    slots = grad_blocks.rasterise_grad_batch(*args,
                                             **case.kwargs(name, jax=False))
    for a, b in zip(fused, slots):
        assert torch.equal(a, b)


def test_slot_grad_reduce_cut_runs_are_zero(case, monkeypatch):
    # A truncating budget: the face blocks whose slots it cut reduce to
    # zero rows; the others equal the fused reduction's.
    from dirt_tpu_torch.ops import prepass_fused
    planes, _ = prepass_fused.plane_stack(case.tpixels, case.gp, case.taux,
                                          16, 16, 16)
    monkeypatch.setenv("DIRT_TPU_TORCH_SLOTS_PER_IMAGE", "6")
    table, slot_run, slot_item, slot_dma, _ = grad_blocks.pack(
        case.v, case.f, 48, 128, 16, 16, 32, slots=True)
    rows = grad_blocks.slot_grad_reduce(table, planes, slot_run, slot_item,
                                        slot_dma, 3, "all")
    live = torch.zeros(table.shape[0], dtype=torch.bool)
    live[slot_run[slot_item >= 0].long()] = True
    assert bool(live.any()) and not bool(live.all())
    assert torch.count_nonzero(rows[~live]) == 0
    assert torch.count_nonzero(rows[live]) > 0
    assert forward_blocks.slots_per_image(10, 24) == 6
