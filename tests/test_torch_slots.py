"""dirt_tpu_torch's slot schedule (forward_blocks.FUSED off) against
dirt_tpu's, on the CPU.

The slot schedule lists one slot per (tile, block) hit plus one mandatory
slot per tile (build_slots), and its sweep (K5b slot_sweep, here its plain
version) walks each tile's slots.  It must give:

  * build_slots' four outputs equal to dirt_tpu's bit for bit, per image,
    including the filler tail, slot_dma's forward fill and `dropped`;
  * at dirt_tpu's slot shapes (32x128 tiles, 128-face blocks), against
    dirt_tpu with its forward_blocks.FUSED off (Pallas interpret mode):
    winner map, vertex ids and dropped bitwise, pixels, barycentrics and
    clip w within atol=1e-4, rtol=1e-5 (tests/test_torch_forward.py's
    comparison), also under a truncating slot budget in both packages,
    where the cut tile is background;
  * at the port's GPU shapes, the same pixels and aux as the fused
    schedule, bit for bit (dirt_tpu's own invariant,
    tests/test_fused_csr.py).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dirt_tpu.ops import dispatch as jdispatch
from dirt_tpu.ops import forward_blocks as jforward_blocks
from dirt_tpu_torch.ops import forward_blocks
from dirt_tpu_torch.utils import convert


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


SLOT_TILE = dict(tile_h=32, tile_w=128, chunk=128)
TRUNCATED_SLOTS = "4"


def scene(seed, nf, h=64, w=128, batch=2):
    """tests/test_fused_csr.py's soup."""
    rng = np.random.RandomState(seed)
    nv = max(48, nf // 2)
    v = rng.randn(batch, nv, 4).astype(np.float32)
    v[..., 3] = np.abs(v[..., 3]) + 0.5
    f = rng.randint(0, nv, size=(batch, nf, 3)).astype(np.int32)
    c = rng.uniform(size=(batch, nv, 3)).astype(np.float32)
    bg = rng.uniform(size=(batch, h, w, 3)).astype(np.float32)
    return bg, v, c, f


SCENES = {"nf40": lambda: scene(7, 40), "nf600": lambda: scene(7, 600)}


def _torch(args):
    return [torch.as_tensor(a) for a in args]


@pytest.fixture(scope="module")
def jax_slots():
    """dirt_tpu's slot forward on each scene, and on nf600 under a
    truncating budget."""
    saved = jforward_blocks.FUSED
    jforward_blocks.FUSED = False
    try:
        out = {name: jdispatch.forward_batch(*make(), "blocks")
               for name, make in SCENES.items()}
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("DIRT_TPU_SLOTS_PER_IMAGE", TRUNCATED_SLOTS)
            out["truncated"] = jdispatch.forward_batch(*SCENES["nf600"](),
                                                       "blocks")
    finally:
        jforward_blocks.FUSED = saved
    return out


def _assert_forward_close(want, got):
    want_px, want_aux = want
    got_px, got_aux = got
    got_aux = convert.aux_to_numpy(got_aux)
    for name in ("face_index", "indices", "dropped"):
        np.testing.assert_array_equal(np.asarray(getattr(want_aux, name)),
                                      getattr(got_aux, name), err_msg=name)
    for name, a, b in (("pixels", want_px, got_px.numpy()),
                       ("barycentric", want_aux.barycentric,
                        got_aux.barycentric),
                       ("clip_w", want_aux.clip_w, got_aux.clip_w)):
        np.testing.assert_allclose(np.asarray(a), b, atol=1e-4, rtol=1e-5,
                                   err_msg=name)


def _assert_same_forward(a, b):
    assert torch.equal(a[0], b[0])
    for field in a[1]._fields:
        assert torch.equal(getattr(a[1], field), getattr(b[1], field)), field


# -- build_slots -----------------------------------------------------------

def _assert_slots_match_jax(hits, num_slots):
    got = forward_blocks.build_slots(torch.as_tensor(hits), num_slots)
    for b in range(hits.shape[0]):
        want = jforward_blocks.build_slots(jnp.asarray(hits[b]), num_slots)
        for name, w, g in zip(("slot_tile", "slot_block", "slot_dma",
                               "dropped"), want, got, strict=True):
            np.testing.assert_array_equal(np.asarray(w), g[b].numpy(),
                                          err_msg=name)


@pytest.mark.parametrize("seed", range(4))
def test_build_slots_matches_jax_bitwise(seed):
    # Random hit matrices with a zero-hit tile, and budgets that fit, that
    # leave a filler tail, and that truncate.
    rng = np.random.RandomState(seed)
    r, i = rng.randint(2, 30), rng.randint(2, 30)
    hits = rng.rand(3, r, i) < rng.uniform(0.05, 0.9)
    hits[:, rng.randint(r)] = False
    _assert_slots_match_jax(hits, int(rng.randint(1, r * i + 4)))


@pytest.mark.parametrize("num_slots", [3, 12, 40])
def test_build_slots_all_false_and_truncating(num_slots):
    # No hits: one no-op slot per run; a budget of 3 cuts five of them.
    hits = np.zeros((2, 8, 5), bool)
    hits[1, 2, [0, 3]] = True
    _assert_slots_match_jax(hits, num_slots)
    slot_tile, slot_block, _, dropped = forward_blocks.build_slots(
        torch.as_tensor(hits), num_slots)
    assert int(dropped[0]) == max(8 - num_slots, 0)
    assert int((slot_block[0] >= 0).sum()) == 0


def test_slot_runs_is_the_csr_of_the_live_slots():
    hit = torch.as_tensor(np.random.RandomState(5).rand(2, 6, 4) < 0.4)
    slot_run, slot_item, slot_dma, _ = forward_blocks.build_slots(hit, 40)
    starts, counts, ids, _ = forward_blocks.build_runs(hit, 40)
    boff = torch.arange(2, dtype=torch.int32)[:, None]
    got = forward_blocks.slot_runs(
        (slot_run + 6 * boff).reshape(-1), slot_item.reshape(-1),
        (slot_dma + 4 * boff).reshape(-1), 12)
    assert torch.equal(got[1], counts.reshape(-1))
    for r in range(12):
        b, s0, n = r // 6, int(starts.reshape(-1)[r]), int(got[1][r])
        want = ids[b, s0:s0 + n] + 4 * b
        assert torch.equal(got[2][int(got[0][r]):int(got[0][r]) + n], want)


# -- the slot forward ------------------------------------------------------

@pytest.mark.parametrize("name", sorted(SCENES))
def test_slot_forward_matches_jax(jax_slots, monkeypatch, name):
    monkeypatch.setattr(forward_blocks, "FUSED", False)
    got = forward_blocks.rasterise_batch(*_torch(SCENES[name]()),
                                         **SLOT_TILE)
    _assert_forward_close(jax_slots[name], got)
    assert int(got[1].dropped.max()) == 0


def test_slot_forward_truncated_matches_jax(jax_slots, monkeypatch):
    # 2 tiles x 5 blocks: the budget of 4 keeps four of tile 0's visits
    # and cuts tile 1 (its rows 32..63 are background in both packages).
    monkeypatch.setattr(forward_blocks, "FUSED", False)
    monkeypatch.setenv("DIRT_TPU_TORCH_SLOTS_PER_IMAGE", TRUNCATED_SLOTS)
    bg, v, c, f = _torch(SCENES["nf600"]())
    got = forward_blocks.rasterise_batch(bg, v, c, f, **SLOT_TILE)
    _assert_forward_close(jax_slots["truncated"], got)
    assert int(got[1].dropped.min()) > 0
    assert torch.equal(got[0][:, 32:], bg[:, 32:])
    assert int(got[1].face_index[:, 32:].max()) == -1
    assert int(got[1].face_index[:, :32].max()) >= 0


@pytest.mark.parametrize("name", sorted(SCENES))
def test_slot_forward_equals_fused_at_gpu_shapes(monkeypatch, name):
    args = _torch(SCENES[name]())
    fused = forward_blocks.rasterise_batch(*args)
    monkeypatch.setattr(forward_blocks, "FUSED", False)
    _assert_same_forward(fused, forward_blocks.rasterise_batch(*args))


def test_slot_sweep_plain_without_live_slots_is_background():
    bg, v, c, f = _torch(SCENES["nf40"]())
    table, slot_tile, slot_block, slot_dma, _ = forward_blocks.pack(
        v, c, f, 64, 128, 16, 16, 32, slots=True)
    state = forward_blocks.slot_sweep(
        table, slot_tile, torch.full_like(slot_block, -1), slot_dma, 2, 3,
        64, 128, 8, 32, 16, 16)
    want = forward_blocks.forward_dense.init_state(3, 256, (64,))
    assert torch.equal(state, want)
