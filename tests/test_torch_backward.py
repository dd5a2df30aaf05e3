"""dirt_tpu_torch's gradient assembly against dirt_tpu's on the CPU.

Both packages start from the same forward residuals (dirt_tpu's reference
forward, handed across as numpy).  Gradients are compared as
tests/test_grad_kernels.py compares dirt_tpu's own backends:
grad_background exactly, the vertex and colour gradients within
max |a - b| / max(max |a|, 1) <= 3e-6, since the implementations sum in
different orders.  The block-binned path runs here with the plain versions
of its kernels (K2 plane_stack, K3 grad_reduce; chip_smoke.py holds the
CUDA kernels against those on the card).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dirt_tpu.ops import backward as jbackward
from dirt_tpu.ops import dispatch as jdispatch
from dirt_tpu.ops import grad_blocks as jgrad_blocks
from dirt_tpu.ops import prepass_fused as jprepass_fused
from dirt_tpu_torch.ops import (backward, grad_blocks, grad_dense,
                                prepass_fused)
from dirt_tpu_torch.ops.reference import RasterAux
from dirt_tpu_torch.utils import convert, meshes

JAX_GRAD_TILE = dict(tile_h=8, tile_w=128, chunk=128)
TOL = 3e-6


def soup(seed, batch=2, nv=60, nf=120, h=64, w=128, c=3, crossing=False):
    rng = np.random.RandomState(seed)
    v = rng.randn(batch, nv, 4).astype(np.float32)
    v[..., 3] = (rng.uniform(-0.5, 1.5, size=(batch, nv)) if crossing
                 else np.abs(v[..., 3]) + 0.5)
    f = rng.randint(0, nv, size=(batch, nf, 3)).astype(np.int32)
    col = rng.uniform(size=(batch, nv, c)).astype(np.float32)
    bg = rng.uniform(size=(batch, h, w, c)).astype(np.float32)
    gp = rng.randn(batch, h, w, c).astype(np.float32)
    return v, f, col, bg, gp


def occlusion(h=32, w=48):
    """Two overlapping squares: boundary gradients must flow to the
    occluder through the dilation."""
    rng = np.random.RandomState(0)
    verts, faces, _, _ = meshes.two_squares(
        front_depth=0.0, back_depth=0.5, size=0.8, back_size=0.9)
    v = np.stack([verts, verts + [0.05, 0., 0., 0.]]).astype(np.float32)
    f = np.stack([faces, faces])
    col = rng.uniform(size=(2, 8, 3)).astype(np.float32)
    bg = rng.uniform(size=(2, h, w, 3)).astype(np.float32)
    gp = rng.randn(2, h, w, 3).astype(np.float32)
    return v, f, col, bg, gp


SCENES = {
    "soup": lambda: soup(0),
    "crossing": lambda: soup(1, crossing=True),
    "occlusion": occlusion,
    "unaligned48x80": lambda: soup(3, nf=90, h=48, w=80),
}


class Case:
    """A scene with dirt_tpu's reference forward, on both sides."""

    def __init__(self, v, f, col, bg, gp):
        self.jv, self.jf, self.jgp = v, f, gp
        self.pixels, self.aux = jdispatch.forward_batch(bg, v, col, f,
                                                        "reference")
        t = lambda a: torch.as_tensor(np.array(a))
        self.v, self.f, self.gp = t(v), t(f), t(gp)
        self.tpixels = t(self.pixels)
        self.taux = RasterAux(*(t(x) for x in self.aux))


@pytest.fixture(scope="module")
def cases():
    return {name: Case(*make()) for name, make in SCENES.items()}


def assert_grads_close(want, got):
    """want/got: (grad_background, grad_vertices, grad_vertex_colors)."""
    np.testing.assert_array_equal(np.asarray(want[0]), got[0].numpy())
    for name, a, b in zip(("grad_vertices", "grad_vertex_colors"),
                          want[1:], got[1:]):
        a, b = np.asarray(a), b.numpy()
        scale = max(np.abs(a).max(), 1.0)
        np.testing.assert_allclose(a / scale, b / scale, atol=TOL,
                                   err_msg=name)


def _triple(g):
    return g.grad_background, g.grad_vertices, g.grad_vertex_colors


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_xla_matches_jax_xla(cases, scene):
    c = cases[scene]
    want = jbackward.rasterise_grad_batch(c.jv, c.jf, c.pixels, c.jgp, c.aux,
                                          implementation="xla")
    got = backward.rasterise_grad_batch(c.v, c.f, c.tpixels, c.gp, c.taux,
                                        implementation="xla")
    assert_grads_close(_triple(want), _triple(got))
    np.testing.assert_array_equal(np.asarray(want.debug),
                                  convert.grads_to_numpy(got).debug)


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_blocks_gpu_shape_matches_xla(cases, scene):
    c = cases[scene]
    want = backward.rasterise_grad_batch(c.v, c.f, c.tpixels, c.gp, c.taux,
                                         implementation="xla")
    got = backward.rasterise_grad_batch(c.v, c.f, c.tpixels, c.gp, c.taux,
                                        implementation="blocks")
    assert_grads_close(tuple(x.numpy() for x in _triple(want)), _triple(got))
    assert torch.equal(want.debug, got.debug)


@pytest.mark.parametrize("scene", ["soup", "occlusion"])
def test_blocks_matches_jax_blocks(cases, scene):
    # dirt_tpu's production gradient (Pallas interpret mode), at its tile
    # shape (8x128 tiles, 128-face blocks).
    c = cases[scene]
    want = jgrad_blocks.rasterise_grad_batch(c.jv, c.jf, c.pixels, c.jgp,
                                             c.aux, interpret=True)
    got = grad_blocks.rasterise_grad_batch(c.v, c.f, c.tpixels, c.gp, c.taux,
                                           **JAX_GRAD_TILE)
    assert_grads_close(_triple(want), _triple(got))


def _jax_xla_planes(c, tile_h, tile_w, np_dma):
    """The stack exactly as dirt_tpu's grad_blocks XLA fallback builds it."""
    pre = jbackward.grad_prepass(c.pixels, jnp.asarray(c.jgp), c.aux)
    batch, height, width, channels = c.pixels.shape
    f32 = lambda a: a.astype(jnp.float32)
    planes = jnp.concatenate([
        jnp.stack([pre.ax, pre.ay, pre.px_t, pre.py_t], axis=1),
        jnp.moveaxis(pre.bary_d, -1, 1), f32(pre.face_d)[:, None],
        jnp.moveaxis(pre.bary_pre, -1, 1), f32(pre.face_pre)[:, None],
        jnp.moveaxis(jnp.asarray(c.jgp), -1, 1)], axis=1)
    ty, tx = height // tile_h, width // tile_w
    planes = planes.reshape(batch, -1, ty, tile_h, tx, tile_w).transpose(
        0, 2, 4, 1, 3, 5).reshape(batch * ty * tx, -1, tile_h * tile_w)
    n = planes.shape[1]
    return np.asarray(jnp.pad(planes, ((0, 0), (0, np_dma - n), (0, 0)))), \
        np.asarray(pre.dilated)


@pytest.mark.parametrize("scene", ["soup", "occlusion"])
def test_plane_stack_matches_jax(cases, scene):
    # occlusion is 32x48: at 8x16 tiles it also checks the tile layout.
    c = cases[scene]
    tile_h, tile_w, np_dma = 8, 16, 16
    if scene == "soup":
        tile_w = 128     # dirt_tpu's shape; few tiles keep its kernel cheap
    got, got_dil = prepass_fused.plane_stack(c.tpixels, c.gp, c.taux, tile_h,
                                             tile_w, np_dma)
    got = got.numpy()
    # Bitwise against the XLA pre-pass dirt_tpu falls back to.
    want, want_dil = _jax_xla_planes(c, tile_h, tile_w, np_dma)
    np.testing.assert_array_equal(want, got)
    np.testing.assert_array_equal(want_dil, got_dil.numpy())
    # Against dirt_tpu's fused pre-pass kernel: decision and pass-through
    # planes and the dilation mask bitwise; the four magnitude planes within
    # the 1e-5 that dirt_tpu's tests/test_prepass_fused.py allows its kernel
    # against its own XLA pre-pass (XLA contracts products in interpret
    # mode; the port rounds each, as the XLA pre-pass does here).
    kern, kern_dil = jprepass_fused.plane_stack(
        jnp.asarray(c.pixels), jnp.asarray(c.jgp), c.aux, tile_h, tile_w,
        np_dma, interpret=True)
    kern = np.asarray(kern)
    np.testing.assert_array_equal(np.asarray(kern_dil), got_dil.numpy())
    np.testing.assert_array_equal(kern[:, 4:], got[:, 4:])
    scale = max(np.abs(kern[:, :4]).max(), 1.0)
    np.testing.assert_allclose(kern[:, :4] / scale, got[:, :4] / scale,
                               atol=1e-5)


def test_plane_stack_pads_unaligned_images_with_zeros(cases):
    c = cases["unaligned48x80"]
    planes, _ = prepass_fused.plane_stack(c.tpixels, c.gp, c.taux, 16, 16,
                                          16)
    # 48x80 at 16x16 tiles is exact; at 32x32 the last tile row/column pad.
    padded, _ = prepass_fused.plane_stack(c.tpixels, c.gp, c.taux, 32, 32,
                                          16)
    padded = padded.reshape(2, 2, 3, 16, 32, 32)
    assert torch.count_nonzero(padded[:, 1, :, :, 16:, :]) == 0
    assert torch.count_nonzero(padded[:, :, 2, :, :, 16:]) == 0
    assert torch.count_nonzero(planes[:, 15]) == 0          # the pad plane


@pytest.mark.parametrize("parts", ["position", "color"])
def test_parts_rows_bitwise_equal_all(cases, parts):
    c = cases["soup"]
    full = grad_blocks.rasterise_grad_batch(c.v, c.f, c.tpixels, c.gp,
                                            c.taux)
    sub = grad_blocks.rasterise_grad_batch(c.v, c.f, c.tpixels, c.gp,
                                           c.taux, parts=parts)
    if parts == "position":
        assert torch.equal(sub.grad_vertices, full.grad_vertices)
        assert torch.count_nonzero(sub.grad_vertex_colors) == 0
    else:
        assert torch.equal(sub.grad_vertex_colors, full.grad_vertex_colors)
        assert torch.count_nonzero(sub.grad_vertices) == 0
    assert torch.equal(sub.grad_background, full.grad_background)


def test_parts_rows_match_jax_xla(cases):
    c = cases["occlusion"]
    for parts in ("position", "color"):
        want = jbackward.rasterise_grad_batch(
            c.jv, c.jf, c.pixels, c.jgp, c.aux, implementation="xla",
            parts=parts)
        got = backward.rasterise_grad_batch(
            c.v, c.f, c.tpixels, c.gp, c.taux, implementation="blocks",
            parts=parts)
        assert_grads_close(_triple(want), _triple(got))


def test_color_cotangent_rows_bitwise(cases):
    # The fused form: colour/background rows from the cotangent, position
    # rows from pixels/grad_pixels -- each the same rows as a one-part call.
    c = cases["soup"]
    cot = torch.as_tensor(np.random.RandomState(9).randn(
        *c.gp.shape[:3], 5).astype(np.float32))
    fused = grad_blocks.rasterise_grad_batch(c.v, c.f, c.tpixels, c.gp,
                                             c.taux, color_cotangent=cot)
    pos = grad_blocks.rasterise_grad_batch(c.v, c.f, c.tpixels, c.gp, c.taux,
                                           parts="position")
    col = grad_blocks.rasterise_grad_batch(c.v, c.f, cot, cot, c.taux,
                                           parts="color")
    assert torch.equal(fused.grad_vertices, pos.grad_vertices)
    assert torch.equal(fused.grad_vertex_colors, col.grad_vertex_colors)
    assert torch.equal(fused.grad_background, col.grad_background)
    want = jbackward.rasterise_grad_batch(
        c.jv, c.jf, c.pixels, c.jgp, c.aux, implementation="xla",
        color_cotangent=cot.numpy())
    assert_grads_close(_triple(want), _triple(fused))


@pytest.mark.parametrize("implementation", ["xla", "blocks"])
def test_channel_grouping_c4(implementation):
    # C=4 groups as 3+1: one full call carrying every colour channel plus a
    # position-only call, summed -- against dirt_tpu's grouping.
    case = Case(*soup(4, c=4, h=32, w=64, nf=60))
    want = jbackward.rasterise_grad_grouped(
        case.jv, case.jf, case.pixels, case.jgp, case.aux,
        implementation="xla")
    got = backward.rasterise_grad_grouped(
        case.v, case.f, case.tpixels, case.gp, case.taux,
        implementation=implementation)
    assert_grads_close(want, got)


def test_zero_faces_passthrough():
    rng = np.random.RandomState(5)
    v = torch.as_tensor(rng.randn(1, 7, 4).astype(np.float32))
    f = torch.zeros(1, 0, 3, dtype=torch.int32)
    px = torch.as_tensor(rng.uniform(size=(1, 16, 32, 3)).astype(np.float32))
    gp = torch.as_tensor(rng.randn(1, 16, 32, 3).astype(np.float32))
    aux = RasterAux(torch.full((1, 16, 32), -1, dtype=torch.int32),
                    torch.full((1, 16, 32, 3), -1, dtype=torch.int32),
                    torch.full((1, 16, 32, 3), -1.0),
                    torch.full((1, 16, 32), torch.inf))
    for impl in ("xla", "blocks"):
        g = backward.rasterise_grad_batch(v, f, px, gp, aux,
                                          implementation=impl)
        assert torch.equal(g.grad_background, gp)
        assert torch.count_nonzero(g.grad_vertices) == 0
        assert torch.count_nonzero(g.grad_vertex_colors) == 0


def test_grad_reduce_honours_truncated_runs(cases):
    # The plain reduction walks exactly the CSR visits it is given: with
    # counts cut to zero a run reduces nothing.
    c = cases["soup"]
    table, starts, counts, tile_ids, _ = grad_blocks.pack(
        c.v, c.f, 64, 128, 16, 16, 32)
    planes, _ = prepass_fused.plane_stack(c.tpixels, c.gp, c.taux, 16, 16,
                                          16)
    rows = grad_blocks.grad_reduce(table, planes, starts, counts, tile_ids,
                                   3, "all")
    assert torch.count_nonzero(rows) > 0
    none = grad_blocks.grad_reduce(table, planes, starts,
                                   torch.zeros_like(counts), tile_ids, 3,
                                   "all")
    assert torch.count_nonzero(none) == 0
    assert rows.shape[-1] == grad_dense.d_out_for("all", 3)


def test_unknown_names_raise(cases):
    c = cases["soup"]
    with pytest.raises(ValueError):
        backward.rasterise_grad_batch(c.v, c.f, c.tpixels, c.gp, c.taux,
                                      implementation="dense")
    with pytest.raises(ValueError):
        backward.rasterise_grad_batch(c.v, c.f, c.tpixels, c.gp, c.taux,
                                      parts="colour")
    with pytest.raises(ValueError):
        backward.rasterise_grad_batch(c.v, c.f, c.tpixels, c.gp, c.taux,
                                      parts="color", color_cotangent=c.gp)
