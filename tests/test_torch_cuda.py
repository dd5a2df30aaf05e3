"""The CUDA kernels against their plain versions, on the card.

Marked `cuda`: these need an NVIDIA Hopper GPU and nvcc, and skip
elsewhere.  On the card, run them without the JAX test configuration:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

The checks are chip_smoke.py's, at small shapes: the face tables (K13,
as bits, on a 4 x 512^2 65,536-face scene, edge rows at 3, 6 and 10
channels, camera-crossing soups and the 65,536-face cylinder with the
camera inside it, and the blocks step with them against the plain tables;
CPU models in tests/test_torch_face_table.py), the inside cylinder's
schedules dropping nothing, the hit plane, the CSR
runs (K12; tests/test_torch_build_runs.py holds it over densities,
orientations and budgets), the sweeps' states (the slot sweep K5b's and
the resident sweep K5's also
equal to K1's; K1 and K5b also on runs of 0, 1, 121 and more visits than
their visit list, K1 with its runs cut into pieces of SWEEP_PIECE, 1 and
2 visits on the 65,536-face cylinder at 32 x 512^2 from outside and inside
it and at 10 and 6 channels, on exact depth ties, each equal to itself in two
calls; K8 and K7 on lists of 0, 1, 301 and 3,728 faces, K5 with every
group empty, zoomed and at 1,536 faces; K4 on both packs' tables at
dilate 0 and 1 and a ragged cut), the fused sweep-and-shade outputs and
the plane stack
(also with the diagonal dilation) bitwise, the reductions' rows within
1e-5 (normalised; the slot reduction K6's equal to K3's; K9 also at
windows clipped by the tile edges, K10 over several chunks a band, each
equal to itself in two calls); the blocks,
dense and pallas paths against the native oracle, each other and the
plain gradient, the mxu gradient against the plain one, the deferred path
on both backends against the two-call form, the slot and resident
schedules against the blocks path, a truncating slot budget, and K11
against its plain version and the repro's numpy reference, with every
kernel of each path launched.
"""

import pathlib
import sys

import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("scene", ["bench", "unaligned", "crossing"])
def test_kernels_match_plain(device, scene):
    make = {
        "bench": lambda: chip_smoke.bench_scene(2, 64, 16, device),
        "unaligned": lambda: chip_smoke.bench_scene(2, 37, 16, device),
        "crossing": lambda: chip_smoke.crossing_scene(device, size=48,
                                                      num_faces=60),
    }[scene]
    errors, _, _ = chip_smoke.compare_kernels(scene, make())
    assert errors["hit_plane"] == errors["raster_sweep"] == 0.0
    assert errors["face_table"] == errors["build_runs"] == 0.0
    assert errors["dense_sweep"] == errors["grad_prepass"] == 0.0
    assert errors["pallas_raster"] == 0.0
    assert errors["slot_sweep"] == errors["resident_sweep"] == 0.0


def test_face_table(device):
    # K13's keys, order and rows == the plain path's bit for bit, sorted
    # and in face order, two launches a sorted table: on a 4 x 512^2
    # 65,536-face scene in both layouts and on the edge rows (near-zero
    # and non-positive w, NaN, degenerate and off-screen faces) at C = 3,
    # 6 and 10 and in the gradient's layout.
    checked = chip_smoke.check_tables(chip_smoke.table_cases(device, 4))
    assert len(checked) == 6


@pytest.mark.parametrize("scene", ["soup3", "soup4", "inside"])
def test_face_table_on_crossing_scenes(device, scene):
    # K13 == the plain path bit for bit where faces cross the camera plane
    # (their bboxes the near/far clip's): camera-crossing soups and the
    # 65,536-face cylinder with the camera inside it at 4 x 512^2, both
    # layouts, sorted and in face order.
    if scene == "inside":
        _, clip, colors, faces, _ = chip_smoke.bench_scene(
            4, 512, 8192, device, distance=chip_smoke.CROSSING_DISTANCE)
        size = 512
    else:
        _, clip, colors, faces, _ = chip_smoke.crossing_scene(
            device, batch=4, size=128, num_faces=2048, seed=int(scene[-1]))
        size = 128
    rows = faces.shape[1]
    checked = chip_smoke.check_tables({
        f"{scene} forward": (clip, faces, colors, size, size, rows),
        f"{scene} gradient": (clip, faces, None, size, size, rows)})
    assert len(checked) == 2


def test_inside_cylinder_schedules_drop_nothing(device):
    # The 65,536-face cylinder with the camera inside it at 4 x 512^2:
    # both schedules keep every visit, under their default budgets.
    scene = chip_smoke.bench_scene(4, 512, 8192, device,
                                   distance=chip_smoke.CROSSING_DISTANCE)
    for name, (dropped, share) in chip_smoke.budget_shares(scene).items():
        assert max(dropped) == 0 and share < 1.0, (name, dropped, share)


def test_blocks_step_with_plain_tables(device):
    # The blocks step with K13's tables and with the plain path's: equal
    # pixels, gradients within GRAD_TOL; 4 launches a step, 0 plain.
    chip_smoke.check_table_path(chip_smoke.bench_scene(4, 512, 8192, device),
                                "4x512^2x65536f")


@pytest.mark.parametrize("backend", ["blocks", "dense", "pallas"])
def test_main_path(device, backend):
    launches = chip_smoke.check_main_path(
        chip_smoke.bench_scene(2, 64, 16, device), backend)
    assert sorted(launches) == sorted(chip_smoke.PATH_KERNELS[backend])
    assert all(n > 0 for n in launches.values())


@pytest.mark.parametrize("backend", ["blocks", "dense"])
def test_deferred_path(device, backend):
    scene = chip_smoke.bench_scene(2, 64, 16, device)
    launches = chip_smoke.check_deferred_path(
        chip_smoke.deferred_scene(scene), backend)
    assert all(n > 0 for n in launches.values())


def test_mxu_path(device):
    scene = chip_smoke.bench_scene(2, 64, 16, device)
    launches = chip_smoke.check_mxu_path(scene,
                                         chip_smoke.deferred_scene(scene))
    assert sorted(launches) == sorted(chip_smoke.PATH_KERNELS["mxu"])
    assert all(n > 0 for n in launches.values())


def _soup(device, channels, seed=0, batch=2, size=40, num_faces=70):
    gen = torch.Generator().manual_seed(seed)
    v = torch.randn(batch, 50, 4, generator=gen)
    v[..., 3] = v[..., 3].abs() + 0.5
    f = torch.randint(0, 50, (batch, num_faces, 3), generator=gen,
                      dtype=torch.int32)
    c = torch.rand(batch, 50, channels, generator=gen)
    bg = torch.rand(batch, size, size + 8, channels, generator=gen)
    gp = torch.randn(batch, size, size + 8, channels, generator=gen)
    return [t.to(device) for t in (bg, v, c, f, gp)]


@pytest.mark.parametrize("channels", [1, 4])
def test_sweep_any_channel_count(device, channels):
    from dirt_tpu_torch.ops import dispatch, forward_blocks
    bg, v, c, f, _ = _soup(device, channels)
    h, w = bg.shape[1:3]
    tiles_y, tiles_x = -(-h // 16), -(-w // 16)
    table, starts, counts, ids, _ = forward_blocks.pack(v, c, f, h, w, 16,
                                                        16, 32)
    args = (table, starts, counts, ids, channels, h, w, tiles_x,
            tiles_y * tiles_x, 16, 16)
    assert torch.equal(forward_blocks.raster_sweep(*args),
                       forward_blocks.raster_sweep_plain(*args))
    px_b, aux_b = dispatch.forward_batch(bg, v, c, f, "blocks")
    px_r, aux_r = dispatch.forward_batch(bg, v, c, f, "reference")
    assert torch.equal(aux_b.face_index, aux_r.face_index)
    torch.testing.assert_close(px_b, px_r, atol=1e-4, rtol=1e-5)


def _check_face_major_reductions(device, monkeypatch, parts, channels,
                                 cotangent, tile=(16, 16), chunk=32,
                                 truncate=False):
    """K3 and K6 on a soup: each within 1e-5 (normalised) of its plain
    version and deterministic (two calls ==); K6 == K3 bit for bit, or,
    under a truncating slot budget (half the slots the emptier image
    needs), zero rows for the face blocks it cut.  `channels` colour
    channels come from the cotangent when `cotangent`, else from the
    scene; `tile` (pixels (h, w)) and `chunk` (faces a block) set the
    launch shape, which it returns."""
    from dirt_tpu_torch.ops import dispatch, grad_blocks, prepass_fused
    bg, v, c, f, gp = _soup(device, 3 if cotangent else channels,
                            num_faces=300 if chunk > 32 else 70)
    px, aux = dispatch.forward_batch(bg, v, c, f, "blocks")
    cot = (torch.randn(*gp.shape[:3], channels, device=device)
           if cotangent else None)
    planes, _, _ = prepass_fused.gradient_planes(px, gp, aux, parts, cot,
                                                 *tile)
    if parts != "color":
        plain, _ = prepass_fused.plane_stack_plain(
            px, gp, aux, *tile, planes.shape[1], parts=parts,
            color_cotangent=cot)
        assert torch.equal(planes, plain)
    h, w = bg.shape[1:3]
    schedule = (v, f, h, w, *tile, chunk)
    table, starts, counts, tile_ids, _ = grad_blocks.pack(*schedule)
    if truncate:
        need = counts.clamp(min=1).reshape(bg.shape[0], -1).sum(-1)
        monkeypatch.setenv("DIRT_TPU_TORCH_SLOTS_PER_IMAGE",
                           str(int(need.min()) // 2))
    _, slot_run, slot_item, slot_dma, _ = grad_blocks.pack(*schedule,
                                                           slots=True)
    k3_args = (table, planes, starts, counts, tile_ids, channels, parts)
    k6_args = (table, planes, slot_run, slot_item, slot_dma, channels, parts)
    rows = {}
    for name, args in (("grad_reduce", k3_args),
                       ("slot_grad_reduce", k6_args)):
        got = getattr(grad_blocks, name)(*args)
        assert torch.equal(got, getattr(grad_blocks, name)(*args)), name
        want = getattr(grad_blocks, name + "_plain")(*args)
        assert float(want.abs().max()) > 0
        scale = max(float(want.abs().max()), 1.0)
        assert float((got - want).abs().max()) / scale <= 1e-5, name
        rows[name] = got
    if truncate:
        live = torch.zeros(table.shape[0], dtype=torch.bool, device=device)
        live[slot_run[slot_item >= 0].long()] = True
        assert bool(live.any()) and not bool(live.all())
        assert not bool(rows["slot_grad_reduce"][~live].any())
    else:
        assert torch.equal(rows["slot_grad_reduce"], rows["grad_reduce"])
    shape = grad_blocks.launch_shape(table, planes, channels, parts)
    assert shape.lanes * chunk <= 1024
    return shape


@pytest.mark.parametrize("parts,channels,cotangent", [
    ("all", 1, False), ("all", 3, False), ("all", 4, False),
    ("all", 5, False), ("all", 10, False), ("all", 12, False),
    ("all", 13, False), ("all", 5, True), ("all", 10, True),
    ("all", 13, True), ("position", 3, False), ("position", 13, False),
    ("color", 3, False), ("color", 10, False), ("color", 13, False)])
def test_grad_reduce_parts_and_wide_cotangent(device, monkeypatch, parts,
                                              channels, cotangent):
    # Colour channels reduce in groups of 4, 8 or 12 a pass: 13 take two.
    _check_face_major_reductions(device, monkeypatch, parts, channels,
                                 cotangent)


def _dense_inputs(device, parts, channels, crossing=False):
    """K9's arguments on a 72 x 80 soup (a camera-crossing one when
    `crossing`): 32x128 tiles of 64-face chunks, `channels` colour
    channels from a cotangent for parts "all", else from the scene."""
    from dirt_tpu_torch.ops import dispatch, grad_dense, prepass_fused
    bg, v, c, f, gp = _soup(device, 3 if parts == "all" else channels,
                            size=72)
    if crossing:
        v[..., 3] = torch.linspace(-0.5, 1.5, v.shape[1], device=device)
    px, aux = dispatch.forward_batch(bg, v, c, f, "dense")
    cot = (torch.randn(*gp.shape[:3], channels, device=device)
           if parts == "all" else None)
    planes, _, _ = prepass_fused.gradient_planes(px, gp, aux, parts, cot,
                                                 32, 128)
    h, w = bg.shape[1:3]
    table, face_ids, counts, _ = grad_dense.pack(v, f, h, w, 32, 128, 64)
    return (table, face_ids, counts, planes, channels, parts, 64, h, w, 32,
            128)


def _check_dense(args):
    """K9 on `args`: within 1e-5 (normalised) of its plain version,
    non-zero, and equal to itself in a second call."""
    from dirt_tpu_torch.ops import grad_dense
    rows = grad_dense.dense_grad_reduce(*args)
    assert torch.equal(rows, grad_dense.dense_grad_reduce(*args))
    want = grad_dense.dense_grad_reduce_plain(*args)
    assert float(want.abs().max()) > 0
    scale = max(float(want.abs().max()), 1.0)
    assert float((rows - want).abs().max()) / scale <= 1e-5


@pytest.mark.parametrize("parts,cot_channels", [
    ("all", 10), ("position", 3), ("color", 3), ("all", 1), ("all", 3),
    ("all", 4), ("all", 12), ("all", 13), ("all", 30), ("color", 10),
    ("color", 13)])
def test_dense_grad_reduce_parts_and_pieces(device, parts, cot_channels):
    # Colour channels in groups of 4, 8 or 12 a pass: 13 and 30 take
    # several.
    _check_dense(_dense_inputs(device, parts, cot_channels))


def test_dense_grad_reduce_windows_at_edges(device):
    # A camera-crossing soup: unbounded faces (bbox: the whole image)
    # keep the whole tile within the image, the others' windows are
    # clipped by the tile edges.
    from dirt_tpu_torch.ops import grad_dense
    args = _dense_inputs(device, "all", 3, crossing=True)
    table, face_ids, counts = args[:3]
    h, w = args[7:9]
    windows = grad_dense.face_windows(table, face_ids, *args[7:])
    live = (torch.arange(face_ids.shape[1], device=device)[None] // 64 * 64
            < counts[:, None])
    pixels = grad_dense.window_pixels(windows)[live]
    box = table[face_ids.long(), :4][live]
    whole = box == torch.tensor([0., h - 1, 0., w - 1], device=device)
    assert bool(whole.all(-1).any()) and bool((pixels[whole.all(-1)]
                                               > 0).all())
    area = (box[:, 1] - box[:, 0] + 1) * (box[:, 3] - box[:, 2] + 1)
    assert bool(((pixels > 0) & (pixels < area)).any())
    _check_dense(args)


@pytest.mark.parametrize("channels", [1, 10])
def test_dense_sweep_any_channel_count(device, channels):
    from dirt_tpu_torch.ops import dispatch, forward_dense
    bg, v, c, f, _ = _soup(device, channels)
    h, w = bg.shape[1:3]
    table, face_ids, counts, _ = forward_dense.pack(v, c, f, h, w, 16, 16,
                                                    64)
    args = (table, face_ids, counts, channels, h, w, -(-w // 16),
            -(-h // 16) * -(-w // 16), 16, 16, 64)
    assert torch.equal(forward_dense.dense_sweep(*args),
                       forward_dense.dense_sweep_plain(*args))
    _, aux_d = dispatch.forward_batch(bg, v, c, f, "dense")
    _, aux_r = dispatch.forward_batch(bg, v, c, f, "reference")
    assert torch.equal(aux_d.face_index, aux_r.face_index)


def test_numpy_inputs_run_on_the_card(device):
    import dirt_tpu_torch
    from dirt_tpu_torch import matrices
    bg, v, c, f, _ = (t.cpu().numpy() for t in _soup(device, 3))
    pixels = dirt_tpu_torch.rasterise_batch(bg, v, c, f)
    assert pixels.device.type == "cuda"
    assert matrices.perspective_projection(0.1, 20., 0.25, 1.).is_cuda
    assert dirt_tpu_torch.rasterise(bg[0], v[0], c[0], f[0],
                                    device="cpu").device.type == "cpu"


@pytest.mark.parametrize("channels", [1, 10])
def test_pallas_raster_any_channel_count(device, channels):
    from dirt_tpu_torch.ops import dispatch, forward_dense, forward_pallas
    bg, v, c, f, _ = _soup(device, channels, size=37)
    h, w = bg.shape[1:3]
    table, face_ids, counts, _ = forward_dense.pack(v, c, f, h, w, 16, 16,
                                                    64)
    args = (table, face_ids, counts, bg, -(-w // 16),
            -(-h // 16) * -(-w // 16), 16, 16, 64)
    for got, want in zip(forward_pallas.pallas_raster(*args),
                         forward_pallas.pallas_raster_plain(*args)):
        assert torch.equal(got, want)
    px_p, aux_p = dispatch.forward_batch(bg, v, c, f, "pallas")
    px_d, aux_d = dispatch.forward_batch(bg, v, c, f, "dense")
    assert torch.equal(px_p, px_d)
    for field in aux_p._fields:
        assert torch.equal(getattr(aux_p, field), getattr(aux_d, field))


@pytest.mark.parametrize("channels,chunk,num_faces", [
    (1, 16, 70), (3, 128, 70), (16, 64, 70), (2, 32, 70), (5, 16, 70),
    (10, 48, 70), (3, 128, 600)])
def test_mxu_grad_columns_and_chunks(device, monkeypatch, channels, chunk,
                                     num_faces):
    # 18 + 3C columns: 21, 27, 66 (three passes of at most 32), 24, 33
    # and 48, in n8 tiles; 37-pixel rows leave a ragged last stage; 70
    # faces take several chunks a band, all in one block, the band's
    # pixels split over a cluster of two; 600 faces in 128-face chunks
    # take five chunks a band, two groups of chunks (four a block) where a
    # band's list is long.  Each call equals itself.
    from dirt_tpu_torch.ops import dispatch, grad_mxu
    monkeypatch.setattr(grad_mxu, "CHUNK", chunk)
    bg, v, c, f, gp = _soup(device, channels, size=37, num_faces=num_faces)
    px, aux = dispatch.forward_batch(bg, v, c, f, "blocks")
    h, w = bg.shape[1:3]
    ids, values, _ = grad_mxu.band_planes(px, gp, aux)
    face_ids, counts, _ = grad_mxu._pack_grad_bands(
        v, f, h, w, -(-f.shape[1] // chunk), -(-h // 16))
    args = (face_ids, counts, ids, grad_mxu.split_bf16(values), chunk)
    want = grad_mxu.mxu_grad_plain(*args)
    scale = max(float(want.abs().max()), 1.0)
    assert float(want.abs().max()) > 0
    rows = grad_mxu.mxu_grad(*args)
    assert torch.equal(rows, grad_mxu.mxu_grad(*args))
    assert float((rows - want).abs().max()) / scale <= 1e-5
    live_chunks = int((counts + chunk - 1).div(chunk, rounding_mode="floor")
                      .max())
    if chunk <= 32:
        assert live_chunks > 1
    if num_faces > 512:
        assert live_chunks > grad_mxu.mxu_shape(
            chunk, face_ids.shape[-1] // chunk, 232448).chunks


def test_diagonal_dilation_kernel(device):
    from dirt_tpu_torch.ops import dispatch, prepass_fused
    bg, v, c, f, gp = _soup(device, 3)
    px, aux = dispatch.forward_batch(bg, v, c, f, "blocks")
    with chip_smoke.diagonal_dilation():
        planes, dilated = prepass_fused.plane_stack(px, gp, aux, 16, 16, 16)
        want, want_dilated = prepass_fused.plane_stack_plain(px, gp, aux, 16,
                                                             16, 16)
    assert torch.equal(planes, want) and torch.equal(dilated, want_dilated)


def test_slots_path(device):
    scene = chip_smoke.bench_scene(2, 64, 16, device)
    launches = chip_smoke.check_slots_path(scene,
                                           chip_smoke.deferred_scene(scene))
    assert sorted(launches) == sorted(chip_smoke.PATH_KERNELS["slots"])
    assert all(n > 0 for n in launches.values())


def test_resident_path(device):
    # 2048 faces: a 294,912-byte table, over a block's shared memory.
    launches = chip_smoke.check_resident_path(
        chip_smoke.bench_scene(2, 64, 16, device),
        chip_smoke.bench_scene(1, 64, 256, device))
    assert sorted(launches) == sorted(chip_smoke.PATH_KERNELS["resident"])
    assert all(n > 0 for n in launches.values())


def test_truncated_slot_budget(device):
    chip_smoke.check_truncated("crossing", chip_smoke.crossing_scene(
        device, size=48, num_faces=60))


def test_scalar_accum(device):
    launches, _, err, _, _ = chip_smoke.check_repro(device)
    assert launches == {"scalar_accum": 2}
    assert err <= 1e-4


@pytest.mark.parametrize("channels", [1, 4])
def test_slot_and_resident_sweeps_equal_k1(device, channels):
    from dirt_tpu_torch.ops import forward_blocks
    bg, v, c, f, _ = _soup(device, channels, size=37)
    h, w = bg.shape[1:3]
    tiles_x, num_tiles = -(-w // 16), -(-h // 16) * -(-w // 16)
    table, starts, counts, ids, _ = forward_blocks.pack(v, c, f, h, w, 16,
                                                        16, 32)
    args = (table, starts, counts, ids, channels, h, w, tiles_x, num_tiles,
            16, 16)
    k1 = forward_blocks.raster_sweep(*args)
    assert torch.equal(forward_blocks.resident_sweep(*args), k1)
    assert torch.equal(forward_blocks.resident_sweep_plain(*args), k1)
    slots = forward_blocks.pack(v, c, f, h, w, 16, 16, 32, slots=True)
    slot_args = (*slots[:4], 2, channels, h, w, tiles_x, num_tiles, 16, 16)
    assert torch.equal(forward_blocks.slot_sweep(*slot_args), k1)
    assert torch.equal(forward_blocks.slot_sweep_plain(*slot_args), k1)


def test_pallas_raster_edge_lists(device):
    # K8 and K7 on the run walk: lists of 0, 1, 301 and 3,728 faces (more
    # than the visit list and the staging area hold) on a 4,096-face
    # image; each == its plain version bit for bit and in two calls, K7's
    # pixels == K8's.
    listed = chip_smoke.check_list_walk(
        "edge", chip_smoke.bench_scene(1, 64, 512, device))
    assert listed == [3728, 301, 1]


def test_hit_plane_tile_loop(device):
    # K4's warp votes over tile windows on the forward and the gradient
    # packs' tables (dilate 0 and 1, with and without the edge cull, at
    # chunks 8, 32, 64 and 128), on rows with degenerate bboxes, on a
    # ragged cut (3 images, 300 faces, 7 x 7 tiles) and on 70,000 images
    # of 5 faces (past a grid's 65,535 in y or z): block hits and window
    # counts == its plain version's bit for bit.
    chip_smoke.check_hit_plane(
        {"bench": chip_smoke.bench_scene(2, 64, 16, device),
         "crossing": chip_smoke.crossing_scene(device, size=100)},
        chip_smoke.bench_scene(4, 100, 64, device))


def test_resident_walk(device):
    # K5 on the run walk: every group empty, busy tiles side by side
    # (zoomed), and a 1,536-face table (147,456 bytes staged): == its
    # plain version and K1 bit for bit, == in two calls.
    chip_smoke.check_resident_walk({
        "bench": chip_smoke.bench_scene(2, 64, 16, device),
        "zoom": chip_smoke.bench_scene(2, 64, 16, device, right=0.05),
        "1536 faces": chip_smoke.bench_scene(2, 64, 192, device)})


def test_sweep_edge_runs(device):
    # Runs of 1, 121 (more than the staging area holds) and list + 100
    # visits (more than the visit list holds) and of none: K1 and K5b ==
    # their plain versions, K5b == K1.
    scene = chip_smoke.bench_scene(2, 64, 16, device)
    _, info = chip_smoke.kernel_inputs(scene)
    chip_smoke.check_sweep_walk("edge", info)


@pytest.mark.parametrize("scene", ["ties", "crossing", "bench"])
def test_sweeps_twice_and_against_each_other(device, scene):
    # Exact depth ties (every face twice, the lower index wins), the
    # camera-crossing soup and the bench cylinder: K1, K5b and K5 each ==
    # the plain state, == K1, and == themselves in a second call.
    from dirt_tpu_torch.ops import forward_blocks
    bg, v, c, f = {
        "ties": lambda: chip_smoke.tie_scene(device),
        "crossing": lambda: chip_smoke.crossing_scene(device, size=48,
                                                      num_faces=60)[:4],
        "bench": lambda: chip_smoke.bench_scene(4, 64, 16, device)[:4],
    }[scene]()
    batch, h, w, channels = bg.shape
    tiles_x, num_tiles = -(-w // 16), -(-h // 16) * -(-w // 16)
    table, starts, counts, ids, _ = forward_blocks.pack(v, c, f, h, w, 16,
                                                        16, 32)
    args = (table, starts, counts, ids, channels, h, w, tiles_x, num_tiles,
            16, 16)
    slot_args = (*forward_blocks.pack(v, c, f, h, w, 16, 16, 32,
                                      slots=True)[:4],
                 batch, channels, h, w, tiles_x, num_tiles, 16, 16)
    want = forward_blocks.raster_sweep_plain(*args)
    assert bool((want[:, -1] >= 0).any())
    for run in (lambda: forward_blocks.raster_sweep(*args),
                lambda: forward_blocks.slot_sweep(*slot_args),
                lambda: forward_blocks.resident_sweep(*args)):
        first, second = run(), run()
        assert torch.equal(first, want)
        assert torch.equal(second, first)


def _cylinder_sweep(device, batch, distance, channels=3):
    """raster_sweep's arguments on the benchmark's mesh (the 65,536-face
    cylinder at 512^2, chip_smoke.bench_scene) at `batch` views from
    `distance`, with `channels` vertex attributes (the colours, repeated
    and scaled past 3)."""
    from dirt_tpu_torch.ops import forward_blocks
    _, clip, colors, faces, _ = chip_smoke.bench_scene(
        batch, 512, 8192, device, distance=distance)
    attrs = torch.cat([colors * (1.0 + k) for k in range(-(-channels // 3))],
                      dim=-1)[..., :channels].contiguous()
    tiles_x = 512 // 16
    table, starts, counts, ids, dropped = forward_blocks.pack(
        clip, attrs, faces, 512, 512, 16, 16, 32)
    assert int(dropped.sum()) == 0
    return (table, starts, counts, ids, channels, 512, 512, tiles_x,
            tiles_x * tiles_x, 16, 16)


def _check_split(args, pieces):
    """K1 with its runs cut into pieces of each of `pieces` visits ==
    raster_sweep_plain bit for bit, in two calls on the same tensors (the
    run's tickets start from zero again)."""
    from dirt_tpu_torch.ops import forward_blocks
    want = forward_blocks.raster_sweep_plain(*args)
    assert bool((want[:, -1] >= 0).any())
    for piece in pieces:
        first = forward_blocks.raster_sweep(*args, piece=piece)
        second = forward_blocks.raster_sweep(*args, piece=piece)
        torch.cuda.synchronize()
        assert torch.equal(first, want), piece
        assert torch.equal(second, want), piece


@pytest.mark.parametrize("distance", [3.0, 0.3], ids=["distant", "inside"])
def test_k1_splits_long_runs_at_the_benchmark_shape(device, distance):
    # 32 x 512^2 and 65,536 faces from the distant camera (cell F: runs of
    # up to ~740 visits on the few tiles the cylinder covers) and from
    # inside the cylinder (cell H: every pixel covered): K1 cuts every run
    # longer than SWEEP_PIECE, or than 1 or 2 visits, into pieces and
    # merges them; the state == the plain version's bit for bit.
    from dirt_tpu_torch.ops import forward_blocks
    args = _cylinder_sweep(device, 32, distance)
    assert int(args[2].max()) > forward_blocks.SWEEP_PIECE
    _check_split(args, (forward_blocks.SWEEP_PIECE, 1, 2))


@pytest.mark.parametrize("channels,batch", [(10, 4), (6, 32)])
def test_k1_splits_at_other_channel_counts(device, channels, batch):
    # Cell E's 10 attribute channels at its 4 views, and cell G's 6 at
    # its 32: the partial winners sit in the state slice's first and last
    # two rows, whatever the channels.
    from dirt_tpu_torch.ops import forward_blocks
    _check_split(_cylinder_sweep(device, batch, 3.0, channels),
                 (forward_blocks.SWEEP_PIECE, 1, 2))


@pytest.mark.parametrize("tile,chunk", [
    ((16, 16), 32), ((16, 16), 128), ((8, 128), 32), ((8, 128), 128),
    ((16, 128), 128), ((5, 7), 32)])
@pytest.mark.parametrize("parts,channels,cotangent,truncate", [
    ("all", 3, False, False), ("all", 13, True, False),
    ("color", 10, False, False), ("position", 3, False, False),
    ("all", 3, False, True)])
def test_slot_grad_reduce_equals_k3(device, monkeypatch, tile, chunk, parts,
                                    channels, cotangent, truncate):
    # 256- and 1024-pixel tiles, 32- and 128-face blocks (256 and 1024
    # threads); 2048-pixel stacks of 14 or more planes take a ring of one
    # slot, 35-pixel stacks of an odd plane count 4-byte copies (the
    # 8 position planes stay 16-byte aligned); a truncating budget zeroes
    # the face blocks it cuts.
    shape = _check_face_major_reductions(device, monkeypatch, parts,
                                         channels, cotangent, tile, chunk,
                                         truncate)
    wide = parts != "position"
    assert shape.depth == (1 if tile == (16, 128) and wide else 2)
    assert (shape.staged % 4 != 0) == (tile == (5, 7) and wide)


def test_face_major_edge_runs(device):
    # Runs of 0, 1, 37 and more visits than a block's visit list.
    scene = chip_smoke.bench_scene(2, 64, 16, device)
    calls, info = chip_smoke.kernel_inputs(scene)
    chip_smoke.check_reduce_walk("edge", calls, info)
