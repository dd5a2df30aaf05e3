"""K9 dense_grad_reduce's windows and launch shape, on the CPU.

K9 adds each face slot's sums over its window only: the face's gradient
table bbox (grad_tables._grad_face_table, widened one pixel for the
dilation; the whole image for a face crossing the camera plane) clipped
to the slot's tile.  That is the plain version's sum only if no pixel
outside a face's bbox carries the face's id in the plain pre-pass's
face_d or face_pre; the premise is checked here on the dense tests'
scenes (tests/test_torch_dense.py's shapes), a camera-crossing soup and
with the diagonal dilation on.  A Python mirror of the kernel's direct
route (a window's pixels flattened row-major, pixel j to lane j % 32,
the 32 lanes combined by a butterfly) is held against
dense_grad_reduce_plain within the kernels' 1e-5 (normalised; the two
sum in different orders).  grad_dense.dense_shape, the launch shape, must
cover every list length in whole blocks, cover 1-30 colour channels and
mirror dense_grad.cu's layout.  The kernel itself runs on the card
(tests/test_torch_cuda.py).
"""

import pathlib

import numpy as np
import pytest
import torch

from dirt_tpu_torch.ops import (_cuda, backward, dispatch, grad_dense,
                                grad_tables, prepass_fused)
from dirt_tpu_torch.utils import convert

REPO = pathlib.Path(__file__).resolve().parents[1]
ROW_TOL = 1e-5


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


def soup(seed, batch=2, nv=60, nf=120, h=64, w=128, crossing=False):
    """tests/test_torch_dense.py's scenes."""
    rng = np.random.RandomState(seed)
    v = rng.randn(batch, nv, 4).astype(np.float32)
    v[..., 3] = (rng.uniform(-0.5, 1.5, size=(batch, nv)) if crossing
                 else np.abs(v[..., 3]) + 0.5)
    f = rng.randint(0, nv, size=(batch, nf, 3)).astype(np.int32)
    c = rng.uniform(size=(batch, nv, 3)).astype(np.float32)
    bg = rng.uniform(size=(batch, h, w, 3)).astype(np.float32)
    gp = rng.randn(batch, h, w, 3).astype(np.float32)
    return convert.scene_to_torch(dict(background=bg, vertices=v, colors=c,
                                       faces=f, grad=gp), "cpu")


SCENES = {
    "soup": lambda: soup(0),
    "crossing": lambda: soup(1, crossing=True),
    "unaligned48x80": lambda: soup(3, nf=90, h=48, w=80),
    "diagonal": lambda: soup(0),
}


@pytest.fixture(params=sorted(SCENES))
def scene(request, monkeypatch):
    """(name, scene tensors, the reference forward's pixels and aux); the
    "diagonal" scene turns the four diagonal dilation attempts on."""
    if request.param == "diagonal":
        monkeypatch.setattr(backward, "DIAGONAL", True)
    s = SCENES[request.param]()
    px, aux = dispatch.forward_batch(s["background"], s["vertices"],
                                     s["colors"], s["faces"], "reference")
    return request.param, s, px, aux


def test_face_ids_lie_inside_their_bboxes(scene):
    name, s, px, aux = scene
    v, f = s["vertices"], s["faces"]
    batch, height, width = px.shape[:3]
    pre = backward.grad_prepass(px, s["grad"], aux)
    table = grad_tables._grad_face_table(v, f, height, width, 0)
    rows = torch.arange(height)[None, :, None].expand(batch, height, width)
    cols = torch.arange(width)[None, None, :].expand(batch, height, width)
    b = torch.arange(batch)[:, None, None].expand(batch, height, width)
    for ids in (pre.face_d, pre.face_pre):
        hit = ids >= 0
        box = table[b[hit], ids[hit].long(), :4]
        r, c = rows[hit].float(), cols[hit].float()
        inside = ((box[:, 0] <= r) & (r <= box[:, 1])
                  & (box[:, 2] <= c) & (c <= box[:, 3]))
        assert int(hit.sum()) > 0 and bool(inside.all()), (
            name, int((~inside).sum()))
    if name == "crossing":
        # Some faces cross the camera plane: their bbox is the image.
        whole = ((table[..., 0] == 0) & (table[..., 1] == height - 1)
                 & (table[..., 2] == 0) & (table[..., 3] == width - 1))
        assert bool(whole.any())
    if name == "diagonal":
        assert int(pre.dilated.sum()) > 0


def windowed_rows(face_table, face_ids, counts, planes, channels, parts,
                  chunk, height, width, tile_h, tile_w):
    """K9's rows as its direct route adds them: each live slot's window
    (grad_dense.face_windows) flattened row-major, pixel j to lane j % 32,
    each lane's sums over its pixels (grad_dense._chunk_sums' arithmetic),
    then the lanes combined by a butterfly (xor 16, 8, 4, 2, 1); zeros for
    the slots of dead chunks and for empty windows."""
    runs, slots = face_ids.shape
    _, L = grad_dense.plane_layout(parts, channels)
    windows = grad_dense.face_windows(face_table, face_ids, height, width,
                                      tile_h, tile_w)
    live = (torch.arange(slots)[None] // chunk * chunk < counts[:, None])
    out = torch.zeros(runs, slots, grad_dense.d_out_for(parts, channels))
    pixels = grad_dense.window_pixels(windows)
    busy = live & (pixels > 0)
    run, slot = torch.nonzero(busy, as_tuple=True)
    w = windows[busy]                                     # [S, 4]
    width_w = w[:, 3] - w[:, 2] + 1
    steps = -(-int(pixels[busy].max()) // 32)
    j = torch.arange(steps)[:, None] * 32 + torch.arange(32)[None]
    j = j.T[None]                                         # [1, 32, steps]
    r = w[:, 0, None, None] + j // width_w[:, None, None]
    c = w[:, 2, None, None] + j % width_w[:, None, None]
    inside = j < pixels[busy][:, None, None]
    # Pixels past the window read a pad pixel that matches no face.
    pad = torch.zeros(runs, planes.shape[1], 1)
    for name in ("face_d", "face_pre"):
        if name in L:
            pad[:, L[name]] = -1.0
    padded = torch.cat([planes, pad], dim=-1)
    p = torch.where(inside, r * tile_w + c, planes.shape[-1])
    tile = padded[run]                                    # [S, NP, PIX + 1]
    plane = lambda i: torch.gather(tile[:, i], 1, p.reshape(len(run), -1)
                                   ).reshape(p.shape)     # [S, 32, steps]
    rows = face_table[face_ids[run, slot].long()]         # [S, _DF]
    col = lambda i: rows[:, i, None, None]                # [S, 1, 1]
    lanes = grad_dense._chunk_sums(col, plane, channels, parts)  # [S, 32, D]
    for m in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[:, torch.arange(32) ^ m]
    out[run, slot] = lanes[:, 0]
    return out


CASES = [("all", 3, False), ("position", 3, False), ("color", 3, False),
         ("all", 10, True)]


@pytest.mark.parametrize("parts,channels,cotangent", CASES)
def test_windowed_sums_equal_the_plain_rows(scene, parts, channels,
                                            cotangent):
    # The dense gradient's 32x128 tiles and 64-face chunks; ten cotangent
    # channels as the deferred step's G-buffer gives them.
    name, s, px, aux = scene
    v, f, gp = s["vertices"], s["faces"], s["grad"]
    batch, height, width = px.shape[:3]
    cot = (torch.as_tensor(np.random.RandomState(7).randn(
        batch, height, width, channels).astype(np.float32))
           if cotangent else None)
    planes, _, _ = prepass_fused.gradient_planes(px, gp, aux, parts, cot,
                                                 32, 128)
    table, face_ids, counts, _ = grad_dense.pack(v, f, height, width, 32,
                                                 128, 64)
    args = (table, face_ids, counts, planes, channels, parts, 64, height,
            width, 32, 128)
    want = grad_dense.dense_grad_reduce_plain(*args)
    got = windowed_rows(*args)
    scale = max(float(want.abs().max()), 1.0)
    assert float(want.abs().max()) > 0
    assert float((got - want).abs().max()) / scale <= ROW_TOL, name
    # Some windows are cut short of the tile (these soups' random
    # triangles are large; the bench cylinder's windows are ~67 pixels).
    live = torch.arange(face_ids.shape[1])[None] // 64 * 64 < counts[:, None]
    pixels = grad_dense.window_pixels(grad_dense.face_windows(
        table, face_ids, height, width, 32, 128))[live]
    assert bool(((pixels > 0) & (pixels < 32 * 128)).any())


# -- the launch shape --------------------------------------------------------

# (parts, channels) of every K9 launch: the direct step (3), the deferred
# G-buffer (10, fused and two-call), the card tests' 1-30.
LAUNCHES = [("all", c) for c in (1, 3, 4, 10, 12, 13, 30)] + [
    ("position", 3), ("color", 3), ("color", 10), ("color", 13)]


def _pow2(n):
    return n > 0 and n & (n - 1) == 0


@pytest.mark.parametrize("slots", [7, 12, 64, 448, 512])
@pytest.mark.parametrize("parts,channels", LAUNCHES)
def test_dense_shape_fits(slots, parts, channels):
    # A block takes warps x per_warp consecutive slots, both powers of two
    # and each the largest that divides the list (up to MAX_WARPS and
    # PER_WARP), so every list is whole blocks.
    s = grad_dense.dense_shape(slots, channels, parts != "position")
    per_block = s.warps * s.per_warp
    assert _pow2(s.warps) and _pow2(s.per_warp) and slots % per_block == 0
    assert s.warps <= grad_dense.MAX_WARPS
    assert s.per_warp <= grad_dense.PER_WARP
    assert s.warps == grad_dense.MAX_WARPS or slots % (2 * s.warps)
    assert (s.per_warp == grad_dense.PER_WARP
            or (slots // s.warps) % (2 * s.per_warp))
    assert s.group == _cuda.colour_group(channels, parts != "position")


@pytest.mark.parametrize("channels", range(1, 31))
def test_dense_shape_groups_cover_channels(channels):
    s = grad_dense.dense_shape(512, channels, True)
    passes = -(-channels // s.group)
    assert s.group in _cuda.GROUPS and s.group * passes >= channels
    assert s.group == next((g for g in (4, 8, 12) if g >= channels), 12)
    assert grad_dense.dense_shape(512, channels, False).group == 4


def test_dense_shape_at_the_bench_configuration():
    # A warp a slot, 8 a block, 4 slots a warp; the deferred step's ten
    # channels in one pass of 12.
    assert grad_dense.dense_shape(512, 3, True) == grad_dense.DenseShape(
        warps=8, per_warp=4, group=4)
    assert grad_dense.dense_shape(512, 10, True).group == 12


def test_dense_shape_odd_sizes_and_limits():
    # Slots not a multiple of 8 take fewer warps, and then fewer slots a
    # warp.
    assert grad_dense.dense_shape(12, 3, True)[:2] == (4, 1)
    assert grad_dense.dense_shape(7, 3, True)[:2] == (1, 1)
    assert grad_dense.dense_shape(8, 3, True)[:2] == (8, 1)
    assert grad_dense.dense_shape(1 << 20, 3, True)[:2] == (
        grad_dense.MAX_WARPS, grad_dense.PER_WARP)


def test_dense_layout_mirrors_the_kernel():
    # dense_shape's fields are the C entry point's last arguments, and
    # MAX_WARPS its kMaxWarps (its blocks' launch bound).
    text = (REPO / "dirt_tpu_torch" / "csrc" / "dense_grad.cu").read_text()
    assert f"constexpr int kMaxWarps = {grad_dense.MAX_WARPS};" in text
    assert ("int tiles, int group, int warps, int per_warp, cudaStream_t "
            "stream)") in text
    assert "kGroup" not in (REPO / "dirt_tpu_torch" / "csrc"
                            / "grad_math.cuh").read_text()
    assert grad_dense.DENSE_GRAD_REDUCE.argtypes.count(
        grad_dense._cuda.i32) == 25


def test_reduce_rejects_a_tile_grid_the_planes_do_not_have():
    # K9 places each run's tile in its image from height, width, tile_h
    # and tile_w; planes of other tiles, or runs short of whole images,
    # raise in the wrapper and in the plain version alike.
    s = soup(0, batch=1, nf=20, h=64, w=128)
    v, f = s["vertices"], s["faces"]
    table, face_ids, counts, _ = grad_dense.pack(v, f, 64, 128, 32, 128, 64)
    planes = torch.zeros(face_ids.shape[0], 16, 32 * 128)
    args = (table, face_ids, counts, planes, 3, "all", 64)
    assert grad_dense.dense_grad_reduce(*args, 64, 128, 32, 128).shape == (
        2, face_ids.shape[1], 18)
    with pytest.raises(ValueError, match="whole images"):
        grad_dense.dense_grad_reduce(*args, 64, 128, 16, 256)
    with pytest.raises(ValueError, match="whole images"):
        grad_dense.dense_grad_reduce_plain(*args, 96, 128, 32, 128)
