"""The CUDA kernels against their plain versions, on the card.

Marked `cuda`: these need an NVIDIA Hopper GPU and nvcc, and skip
elsewhere.  On the card, run them without the JAX test configuration:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

The checks are chip_smoke.py's, at small shapes: the hit plane, the sweep
state and the plane stack bitwise, the gradient rows within 1e-5
(normalised), and the main path against the native oracle, the reference
backend and the plain gradient, with every kernel launched.
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
    errors, _ = chip_smoke.compare_kernels(scene, make())
    assert errors["hit_plane"] == errors["raster_sweep"] == 0.0
    assert errors["grad_prepass"] == 0.0


def test_main_path(device):
    launches = chip_smoke.check_main_path(
        chip_smoke.bench_scene(2, 64, 16, device))
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


@pytest.mark.parametrize("parts,cot_channels", [
    ("all", 5), ("position", 3), ("color", 3)])
def test_grad_reduce_parts_and_wide_cotangent(device, parts, cot_channels):
    # Colour channels reduce in passes of four: five exercise two passes.
    from dirt_tpu_torch.ops import (dispatch, grad_blocks, grad_dense,
                                    prepass_fused)
    bg, v, c, f, gp = _soup(device, 3)
    px, aux = dispatch.forward_batch(bg, v, c, f, "blocks")
    cot = (torch.randn(*gp.shape[:3], cot_channels, device=device)
           if parts == "all" else None)
    channels = cot_channels
    n = grad_dense.plane_layout(parts, channels)[0]
    np_dma = -(-n // 8) * 8
    if parts == "color":
        planes, _, _ = grad_dense.prepass_and_planes(px, gp, aux, parts)
        planes = prepass_fused.tile_planes(planes, 16, 16, np_dma)
    else:
        planes, _ = prepass_fused.plane_stack(px, gp, aux, 16, 16, np_dma,
                                              parts=parts,
                                              color_cotangent=cot)
        plain, _ = prepass_fused.plane_stack_plain(
            px, gp, aux, 16, 16, np_dma, parts=parts, color_cotangent=cot)
        assert torch.equal(planes, plain)
    table, starts, counts, tile_ids, _ = grad_blocks.pack(
        v, f, bg.shape[1], bg.shape[2], 16, 16, 32)
    args = (table, planes, starts, counts, tile_ids, channels, parts)
    rows = grad_blocks.grad_reduce(*args)
    want = grad_blocks.grad_reduce_plain(*args)
    scale = max(float(want.abs().max()), 1.0)
    assert float((rows - want).abs().max()) / scale <= 1e-5
