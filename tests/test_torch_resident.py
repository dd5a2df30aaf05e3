"""dirt_tpu_torch's resident-table forward (forward_blocks.RESIDENT_MB)
against dirt_tpu's, on the CPU.

With the image's face table within the RESIDENT_MB budget, the fused
schedule's sweep is K5 resident_sweep (here its plain version, which reads
each visit's block from the image's own table by index) instead of K1.
The state must equal K1's bit for bit, as dirt_tpu pins its resident
kernel against its DMA one (tests/test_resident.py).  Against dirt_tpu
with RESIDENT_MB=1000 at its fused shapes (4x128 tiles, 64-face blocks):
winner map, vertex ids and dropped bitwise, pixels, barycentrics and clip
w within tests/test_torch_forward.py's atol=1e-4, rtol=1e-5.  The budget
rule: -1 never, 0 the device's opt-in shared memory per block (no bound
for CPU tensors), a positive MB value capped by it.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dirt_tpu.ops import dispatch as jdispatch
from dirt_tpu.ops import forward_blocks as jforward_blocks
from dirt_tpu.utils import meshes as jmeshes
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


JAX_TILE = dict(tile_h=4, tile_w=128, chunk=64)
H100_OPTIN = 232448     # the H100's opt-in shared memory per block


def _scene(segments=6):
    """tests/test_resident.py's scene: a 6-segment cylinder, two images."""
    rng = np.random.RandomState(0)
    verts, faces = jmeshes.make_cylinder(0.5, 1.0, 0.1, 0.2, segments)
    verts = np.concatenate(
        [verts, np.ones((verts.shape[0], 1), np.float32)], 1)
    view = np.eye(4, dtype=np.float32)
    view[3, 2] = -3.0
    clip = verts @ view
    clip[:, 2] = 0.5 * clip[:, 2] + 0.5 * clip[:, 3]
    colors = rng.uniform(size=(verts.shape[0], 3)).astype(np.float32)
    bg = rng.uniform(size=(2, 48, 128, 3)).astype(np.float32)
    return (bg, np.stack([clip, clip * np.float32(1.01)]),
            np.stack([colors, colors]), np.stack([faces, faces]))


def _same(a, b):
    assert torch.equal(a[0], b[0])
    for field in a[1]._fields:
        assert torch.equal(getattr(a[1], field), getattr(b[1], field)), field


class _Spy:
    def __init__(self, monkeypatch, name):
        self.calls = 0
        original = getattr(forward_blocks, name)

        def spy(*args):
            self.calls += 1
            return original(*args)
        monkeypatch.setattr(forward_blocks, name, spy)


def test_resident_matches_jax_resident(monkeypatch):
    saved = jforward_blocks.RESIDENT_MB
    jforward_blocks.RESIDENT_MB = 1000.0
    try:
        want_px, want_aux = jdispatch.forward_batch(
            *(jnp.asarray(a) for a in _scene()), "blocks")
    finally:
        jforward_blocks.RESIDENT_MB = saved
    monkeypatch.setattr(forward_blocks, "RESIDENT_MB", 1000.0)
    resident = _Spy(monkeypatch, "resident_sweep")
    got_px, got_aux = forward_blocks.rasterise_batch(
        *(torch.as_tensor(a) for a in _scene()), **JAX_TILE)
    assert resident.calls == 1
    got_aux = convert.aux_to_numpy(got_aux)
    for name in ("face_index", "indices", "dropped"):
        np.testing.assert_array_equal(np.asarray(getattr(want_aux, name)),
                                      getattr(got_aux, name), err_msg=name)
    assert int((got_aux.face_index >= 0).sum()) > 0
    for name, a, b in (("pixels", want_px, got_px.numpy()),
                       ("barycentric", want_aux.barycentric,
                        got_aux.barycentric),
                       ("clip_w", want_aux.clip_w, got_aux.clip_w)):
        np.testing.assert_allclose(np.asarray(a), b, atol=1e-4, rtol=1e-5,
                                   err_msg=name)


@pytest.mark.parametrize("shape", ["gpu", "jax"])
def test_resident_sweep_plain_equals_k1_plain(monkeypatch, shape):
    kw = JAX_TILE if shape == "jax" else {}
    args = [torch.as_tensor(a) for a in _scene(segments=24)]
    k1 = forward_blocks.rasterise_batch(*args, **kw)
    monkeypatch.setattr(forward_blocks, "RESIDENT_MB", 0.0)
    resident = _Spy(monkeypatch, "resident_sweep")
    _same(k1, forward_blocks.rasterise_batch(*args, **kw))
    assert resident.calls == 1
    # The state itself, on the same CSR runs.
    th, tw, chunk = (kw.get("tile_h", 16), kw.get("tile_w", 16),
                     kw.get("chunk", 32))
    table, starts, counts, ids, _ = forward_blocks.pack(
        args[1], args[2], args[3], 48, 128, th, tw, chunk)
    sweep = (table, starts, counts, ids, 3, 48, 128, -(-128 // tw),
             -(-48 // th) * -(-128 // tw), th, tw)
    assert torch.equal(forward_blocks.resident_sweep_plain(*sweep),
                       forward_blocks.raster_sweep_plain(*sweep))


@pytest.mark.parametrize("mb,limit,want", [
    (-1.0, H100_OPTIN, 0), (-1.0, None, 0),
    (0.0, H100_OPTIN, H100_OPTIN), (0.0, None, float("inf")),
    (0.1, H100_OPTIN, 104857), (1.0, H100_OPTIN, H100_OPTIN),
    (1000.0, None, 1000 * 1024 * 1024)])
def test_resident_budget(monkeypatch, mb, limit, want):
    monkeypatch.setattr(forward_blocks, "RESIDENT_MB", mb)
    assert forward_blocks.resident_budget_bytes(limit) == want


@pytest.mark.parametrize("mb,resident", [(-1.0, False), (0.0, True),
                                         (0.01, False), (0.1, True)])
def test_resident_selection_rule(monkeypatch, mb, resident):
    # The gpu-shape table of the 24-segment cylinder: 192 faces, 6 blocks
    # of 32 rows of 36 floats = 27,648 bytes (over 0.01 MB, under 0.1 MB).
    monkeypatch.setattr(forward_blocks, "RESIDENT_MB", mb)
    k5 = _Spy(monkeypatch, "resident_sweep")
    k1 = _Spy(monkeypatch, "raster_sweep")
    forward_blocks.rasterise_batch(
        *(torch.as_tensor(a) for a in _scene(segments=24)))
    assert (k5.calls, k1.calls) == ((1, 0) if resident else (0, 1))


@pytest.mark.parametrize("num_tiles,group", [(256, 8), (12, 4), (6, 2),
                                             (7, 1)])
def test_group_for(num_tiles, group):
    assert forward_blocks.group_for(num_tiles) == group
    assert jforward_blocks.group_for(num_tiles) == group
