"""The "mxu" gradient of dirt_tpu_torch against dirt_tpu's, on the CPU.

Both packages start from the same forward residuals (dirt_tpu's reference
forward, handed across as numpy).  The band packing (_pack_grad_bands)
and the bf16 hi/mid/lo value planes must equal dirt_tpu's bit for bit
(dirt_tpu pads each band to 128 lanes; the real pixels are compared);
on the camera-crossing scene, where the port clips the bboxes of faces
with a corner at w <= 0 and dirt_tpu gives them the screen, the bands
are dirt_tpu's hits-first packing (grad_tables._pack_grad_faces, a tile
a band) of the port's gradient table, whose rows equal dirt_tpu's on
every other face and hold what those faces cover (tests/clip_bbox.py).
The gradients (kernel K10's plain version: three f32 matmuls per band
and chunk) are held against dirt_tpu's grad_mxu in Pallas interpret mode
within max |a - b| / max(max |a|, 1) <= 3e-6 (tests/test_grad_kernels.py's
bound: the two sum in different orders), with grad_background and the
debug image exactly equal.  Also here: the opt-in diagonal dilation of
the pre-pass against dirt_tpu's, bitwise.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dirt_tpu.ops import backward as jbackward
from dirt_tpu.ops import dispatch as jdispatch
from dirt_tpu.ops import grad_mxu as jgrad_mxu
from dirt_tpu.ops import grad_tables as jgrad_tables
import dirt_tpu_torch
from dirt_tpu_torch.ops import (backward, dispatch, grad_mxu, grad_tables,
                                prepass_fused)
from dirt_tpu_torch.ops.reference import RasterAux
from dirt_tpu_torch.utils import meshes

import clip_bbox


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


TOL = 3e-6


def soup(seed, batch=2, nv=60, nf=120, h=64, w=128, crossing=False):
    rng = np.random.RandomState(seed)
    v = rng.randn(batch, nv, 4).astype(np.float32)
    v[..., 3] = (rng.uniform(-0.5, 1.5, size=(batch, nv)) if crossing
                 else np.abs(v[..., 3]) + 0.5)
    f = rng.randint(0, nv, size=(batch, nf, 3)).astype(np.int32)
    col = rng.uniform(size=(batch, nv, 3)).astype(np.float32)
    bg = rng.uniform(size=(batch, h, w, 3)).astype(np.float32)
    gp = rng.randn(batch, h, w, 3).astype(np.float32)
    return v, f, col, bg, gp


def occlusion(h=32, w=48):
    """Two overlapping squares: gradients flow to the occluder through the
    dilation."""
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
    "unaligned48x80": lambda: soup(3, nf=90, h=48, w=80),
}


class Case:
    """A scene with dirt_tpu's reference forward, on both sides."""

    def __init__(self, v, f, col, bg, gp):
        self.jv, self.jf, self.jgp, self.jbg, self.jcol = v, f, gp, bg, col
        self.pixels, self.aux = jdispatch.forward_batch(bg, v, col, f,
                                                        "reference")
        t = lambda a: torch.as_tensor(np.array(a))
        self.v, self.f, self.gp = t(v), t(f), t(gp)
        self.tpixels = t(self.pixels)
        self.taux = RasterAux(*(t(x) for x in self.aux))

    def port(self, implementation="mxu", **kw):
        return backward.rasterise_grad_batch(
            self.v, self.f, self.tpixels, self.gp, self.taux,
            implementation=implementation, **kw)


@pytest.fixture(scope="module")
def cases():
    return {name: Case(*make()) for name, make in SCENES.items()}


def _close(a, b, name):
    a, b = np.asarray(a), np.asarray(b)
    scale = max(np.abs(a).max(), 1.0)
    np.testing.assert_allclose(b / scale, a / scale, atol=TOL, err_msg=name)


def _assert_grads(want, got):
    np.testing.assert_array_equal(np.asarray(want.grad_background),
                                  got.grad_background.numpy())
    np.testing.assert_array_equal(np.asarray(want.debug), got.debug.numpy())
    _close(want.grad_vertices, got.grad_vertices, "vertices")
    _close(want.grad_vertex_colors, got.grad_vertex_colors, "colours")
    assert float(got.grad_vertices.abs().max()) > 0


def _cdiv(a, b):
    return -(-a // b)


# -- the band packing and the value planes ----------------------------------

@pytest.mark.parametrize("cut", [False, True])
@pytest.mark.parametrize("scene", sorted(SCENES))
def test_pack_grad_bands_matches_jax(cases, monkeypatch, scene, cut):
    # 64-face chunks in both packages; cut: one chunk, fewer slots than
    # the hits of the busiest bands.
    monkeypatch.setattr(jgrad_mxu, "CHUNK", 64)
    monkeypatch.setattr(grad_mxu, "CHUNK", 64)
    c = cases[scene]
    batch, h, w, _ = c.pixels.shape
    nc = 1 if cut else _cdiv(c.jf.shape[1], 64)
    bands = _cdiv(h, 16)
    face_ids, counts, sorted_orig = grad_mxu._pack_grad_bands(
        c.v, c.f, h, w, nc, bands)
    crossing = clip_bbox.unbounded(c.v, c.f)
    if crossing.any():
        # The port's gradient table: its rows are the bands' row bounds.
        nf = c.f.shape[1]
        table = grad_tables._grad_face_table(c.v, c.f, h, w,
                                             max(nc * 64, nf) - nf)
        want_rows = np.asarray(jax.vmap(functools.partial(
            jgrad_tables._grad_face_table, height=h, width=w,
            pad_rows=0))(c.jv, c.jf))[..., :2]
        rows = table[:, :nf, :2].numpy()
        np.testing.assert_array_equal(rows[~crossing], want_rows[~crossing])
        clip_bbox.assert_contained(
            c.v, c.f, [table[:, :nf, col] for col in grad_tables._BBOX], h,
            w, dilate=1, only=crossing)
        # dirt_tpu's hits-first packing of that table into bands: tiles a
        # band high and the image wide.
        pack = functools.partial(
            jgrad_tables._pack_grad_faces, height=h, width=w, num_chunks=nc,
            tiles_y=bands, tiles_x=1, chunk=64, tile_h=16, tile_w=w)
        band_rows, band_counts, band_orig = clip_bbox.packed_on(
            table, jgrad_tables, "_grad_face_table", pack, c.jv, c.jf,
            monkeypatch=monkeypatch)
        face_col = np.asarray(band_rows)[..., 4]
        want = (np.where(face_col < 0, -3, face_col), band_counts,
                band_orig)
    else:
        want = jax.vmap(functools.partial(
            jgrad_mxu._pack_grad_bands, height=h, width=w, num_chunks=nc,
            num_bands=bands))(c.jv, c.jf)
    np.testing.assert_array_equal(
        np.asarray(want[0]).reshape(face_ids.shape), face_ids.numpy())
    np.testing.assert_array_equal(np.asarray(want[1]).reshape(batch, -1),
                                  counts.numpy())
    np.testing.assert_array_equal(np.asarray(want[2]), sorted_orig.numpy())
    assert (int(counts.max()) == 64) == cut


def _jax_split_planes(c):
    """dirt_tpu's ids and bf16 split groups (grad_mxu.py:192-251), each
    band cut back from its 128-lane padding to the image width."""
    pre = jbackward.grad_prepass(jnp.asarray(c.pixels), jnp.asarray(c.jgp),
                                 c.aux)
    b = [pre.bary_d[..., k] for k in range(3)]
    channels = c.jgp.shape[-1]
    planes = ([b[k] * pre.ax for k in range(3)]
              + [b[k] * pre.ay for k in range(3)]
              + [b[k] * b[m] * pre.px_t for k, m in jgrad_mxu._QPAIRS]
              + [b[k] * b[m] * pre.py_t for k, m in jgrad_mxu._QPAIRS]
              + [pre.bary_pre[..., k] * c.jgp[..., ch]
                 for k in range(3) for ch in range(channels)])
    hi = [p.astype(jnp.bfloat16) for p in planes]
    res = [p - h.astype(jnp.float32) for p, h in zip(planes, hi)]
    mid = [r.astype(jnp.bfloat16) for r in res]
    lo = [(r - m.astype(jnp.float32)).astype(jnp.bfloat16)
          for r, m in zip(res, mid)]
    batch, height, width, _ = c.pixels.shape
    bands = _cdiv(height, 16)

    def to_bands(stack, fill):                   # [B, H, W, P]
        stack = jnp.pad(stack, ((0, 0), (0, bands * 16 - height), (0, 0),
                                (0, 0)), constant_values=fill)
        return np.asarray(stack.astype(jnp.float32)).reshape(
            batch, bands, 16 * width, -1)
    ids = to_bands(jnp.stack([pre.face_d.astype(jnp.float32),
                              pre.face_pre.astype(jnp.float32)], -1), -2.0)
    groups = np.stack([to_bands(jnp.stack(g, -1), 0.0)
                       for g in (hi, mid, lo)], axis=2)
    return np.moveaxis(ids, -1, 2), groups


@pytest.mark.parametrize("scene", ["soup", "unaligned40x72"])
def test_split_planes_match_jax(cases, scene):
    # 40 rows: the last band's 8 rows past the image get ids -2.
    c = (cases[scene] if scene in cases
         else Case(*soup(7, nf=60, h=40, w=72)))
    want_ids, want_groups = _jax_split_planes(c)
    ids, values, dilated = grad_mxu.band_planes(c.tpixels, c.gp, c.taux)
    groups = grad_mxu.split_bf16(values)
    assert groups.dtype == torch.bfloat16
    assert groups.shape[-2] == 18 + 9          # plane-major [.., 3, P, PIX]
    np.testing.assert_array_equal(want_ids, ids.numpy())
    np.testing.assert_array_equal(want_groups,
                                  groups.float().transpose(-1, -2).numpy())
    # hi + mid + lo gives back the f32 value to ~2^-24 relative.
    back = groups.float().sum(dim=2)
    scale = values.abs().amax().clamp(min=1.0)
    assert float((back - values).abs().max() / scale) < 2.0 ** -22
    assert int(dilated.sum()) > 0


# -- the gradient -----------------------------------------------------------

@pytest.mark.parametrize("scene", sorted(SCENES))
def test_mxu_grad_matches_jax(cases, scene):
    c = cases[scene]
    want = jgrad_mxu.rasterise_grad_batch(c.jv, c.jf, c.pixels, c.jgp, c.aux,
                                          interpret=True)
    _assert_grads(want, c.port())


def test_mxu_grad_several_chunks_match_jax(monkeypatch):
    # 64-face chunks: the soup's 120 faces take two per band.
    monkeypatch.setattr(jgrad_mxu, "CHUNK", 64)
    monkeypatch.setattr(grad_mxu, "CHUNK", 64)
    c = Case(*occlusion(h=32, w=48))
    soup_case = Case(*soup(2))
    for case in (c, soup_case):
        want = jgrad_mxu.rasterise_grad_batch(case.jv, case.jf, case.pixels,
                                              case.jgp, case.aux,
                                              interpret=True)
        _assert_grads(want, case.port())


def test_mxu_grad_plain_dead_chunks_are_zero(cases):
    c = cases["soup"]
    h, w = c.pixels.shape[1:3]
    ids, values, _ = grad_mxu.band_planes(c.tpixels, c.gp, c.taux)
    k = grad_mxu.CHUNK            # two chunks per band, the second dead
    face_ids, counts, _ = grad_mxu._pack_grad_bands(c.v, c.f, h, w, 2, 4)
    rows = grad_mxu.mxu_grad(face_ids, counts, ids,
                             grad_mxu.split_bf16(values), k)
    assert rows.shape == (2, 4 * 2, 2 * k, 27)
    live = (torch.arange(2) * k)[None, None] < counts[..., None]
    live = live.reshape(2, -1)
    assert bool((rows[~live] == 0).all())
    assert bool(live.any()) and not bool(live.all())
    assert float(rows[live].abs().max()) > 0


@pytest.mark.parametrize("part", ["position", "color"])
def test_mxu_parts_compute_and_mask(cases, part):
    c = cases["soup"]
    full = c.port()
    one = c.port(parts=part)
    assert torch.equal(one.grad_background, full.grad_background)
    if part == "position":
        assert torch.equal(one.grad_vertices, full.grad_vertices)
        assert int(torch.count_nonzero(one.grad_vertex_colors)) == 0
    else:
        assert torch.equal(one.grad_vertex_colors, full.grad_vertex_colors)
        assert int(torch.count_nonzero(one.grad_vertices)) == 0


def test_mxu_raises_where_dirt_tpu_does(cases):
    # color_cotangent, and so the grouped parts="all" call of more than
    # three channels (its first group carries every channel's cotangent),
    # raise in both packages.
    c = cases["soup"]
    wide = np.concatenate([c.jgp, c.jgp[..., :1]], axis=-1)
    with pytest.raises(ValueError, match="color_cotangent"):
        jbackward.rasterise_grad_batch(c.jv, c.jf, c.pixels, c.jgp, c.aux,
                                       implementation="mxu",
                                       color_cotangent=c.jgp)
    with pytest.raises(ValueError, match="color_cotangent"):
        c.port(color_cotangent=c.gp)
    with pytest.raises(ValueError, match="color_cotangent"):
        jbackward.rasterise_grad_grouped(c.jv, c.jf, wide, wide, c.aux,
                                         implementation="mxu")
    with pytest.raises(ValueError, match="color_cotangent"):
        backward.rasterise_grad_grouped(c.v, c.f, torch.as_tensor(wide),
                                        torch.as_tensor(wide), c.taux,
                                        implementation="mxu")
    # Wide images still work per part: position groups, one colour call.
    _, gv, gc = backward.rasterise_grad_grouped(
        c.v, c.f, torch.as_tensor(wide), torch.as_tensor(wide), c.taux,
        parts="position", implementation="mxu")
    assert float(gv.abs().max()) > 0 and int(torch.count_nonzero(gc)) == 0


def test_mxu_deferred_takes_the_two_call_fallback(cases):
    c = cases["soup"]
    rng = np.random.RandomState(8)
    gbuffer = torch.as_tensor(rng.randn(*c.pixels.shape[:3], 5).astype(
        np.float32))
    grad_gbuffer = torch.as_tensor(rng.randn(*gbuffer.shape).astype(
        np.float32))
    got = backward.rasterise_grad_deferred(c.v, c.f, c.tpixels, c.gp, gbuffer,
                                           grad_gbuffer, c.taux,
                                           implementation="mxu")
    _, want_v, _ = backward.rasterise_grad_grouped(
        c.v, c.f, c.tpixels, c.gp, c.taux, parts="position",
        implementation="mxu")
    want_bg, _, want_a = backward.rasterise_grad_grouped(
        c.v, c.f, gbuffer, grad_gbuffer, c.taux, parts="color",
        implementation="mxu")
    for want, g in zip((want_bg, want_v, want_a), got):
        assert torch.equal(want, g)
    # The same three gradients as dirt_tpu's fused deferred backward.
    jax_want = jbackward.rasterise_grad_deferred(
        c.jv, c.jf, c.pixels, c.jgp, gbuffer.numpy(), grad_gbuffer.numpy(),
        c.aux, implementation="xla")
    np.testing.assert_array_equal(np.asarray(jax_want[0]), got[0].numpy())
    _close(jax_want[1], got[1], "vertices")
    _close(jax_want[2], got[2], "attributes")


def test_env_reaches_mxu_through_autograd(monkeypatch):
    # DIRT_TPU_TORCH_GRAD_BACKEND=mxu overrides the blocks backend's
    # pairing in rasterise_batch's backward.
    v, f, col, bg, gp = soup(5, nv=48, nf=80, h=32, w=64)
    calls = []
    original = grad_mxu.rasterise_grad_batch

    def counting(*args):
        calls.append(1)
        return original(*args)
    monkeypatch.setattr(grad_mxu, "rasterise_grad_batch", counting)
    grads = {}
    for env in ("mxu", "auto"):
        monkeypatch.setenv("DIRT_TPU_TORCH_GRAD_BACKEND", env)
        leaves = [torch.tensor(a, requires_grad=True) for a in (bg, v, col)]
        px = dirt_tpu_torch.rasterise_batch(*leaves, f, backend="blocks")
        (px * torch.as_tensor(gp)).sum().backward()
        grads[env] = [x.grad for x in leaves]
    assert len(calls) == 1
    assert torch.equal(grads["mxu"][0], grads["auto"][0])
    for a, b in zip(grads["auto"][1:], grads["mxu"][1:]):
        _close(a.numpy(), b.numpy(), "gradients")
    monkeypatch.setenv("DIRT_TPU_TORCH_GRAD_BACKEND", "mxu")
    assert backward.resolve_implementation(None, "cpu") == "mxu"
    assert dispatch.grad_for_backend("dense") == "mxu"


def test_grad_debug_mxu_equals_xla(cases):
    c = cases["unaligned48x80"]
    args = (c.jbg[0], c.jv[0], c.jcol[0], c.jf[0], c.jgp[0])
    xla, xla_debug = dirt_tpu_torch.rasterise_grad_debug(
        *args, grad_implementation="xla", device="cpu")
    mxu, mxu_debug = dirt_tpu_torch.rasterise_grad_debug(
        *args, grad_implementation="mxu", device="cpu")
    assert torch.equal(xla_debug, mxu_debug)
    assert float(mxu_debug[..., 0].max()) == pytest.approx(1e-2)
    assert torch.equal(xla.grad_background, mxu.grad_background)
    _close(xla.grad_vertices.numpy(), mxu.grad_vertices, "vertices")
    _close(xla.grad_vertex_colors.numpy(), mxu.grad_vertex_colors, "colours")


def test_zero_faces_pass_through():
    v, f, col, bg, gp = soup(6, nf=1, h=16, w=32)
    f = f[:, :0]
    px, aux = dispatch.forward_batch(*(torch.as_tensor(a)
                                       for a in (bg, v, col, f)), "reference")
    g = backward.rasterise_grad_batch(torch.as_tensor(v), torch.as_tensor(f),
                                      px, torch.as_tensor(gp), aux,
                                      implementation="mxu")
    assert torch.equal(g.grad_background, torch.as_tensor(gp))
    assert int(torch.count_nonzero(g.grad_vertices)) == 0


# -- the opt-in diagonal dilation -------------------------------------------

@pytest.mark.parametrize("scene", ["occlusion", "soup"])
def test_diagonal_dilation_matches_jax(monkeypatch, scene):
    c = Case(*(occlusion() if scene == "occlusion" else soup(0)))
    plain = backward.grad_prepass(c.tpixels, c.gp, c.taux)
    monkeypatch.setattr(jbackward, "DIAGONAL", True)
    monkeypatch.setattr(backward, "DIAGONAL", True)
    want = jbackward.grad_prepass(jnp.asarray(c.pixels), jnp.asarray(c.jgp),
                                  c.aux)
    got = backward.grad_prepass(c.tpixels, c.gp, c.taux)
    for name in want._fields:
        np.testing.assert_array_equal(np.asarray(getattr(want, name)),
                                      getattr(got, name).numpy(),
                                      err_msg=name)
    # The diagonal attempts adopt where the axial ones did not.
    assert int(got.dilated.sum()) > int(plain.dilated.sum())
    # K2's plain version (the stack it writes) follows the switch too.
    planes, dilated = prepass_fused.plane_stack(c.tpixels, c.gp, c.taux,
                                                16, 16, 16)
    assert torch.equal(dilated, got.dilated)
    monkeypatch.setattr(backward, "DIAGONAL", False)
    axial, _ = prepass_fused.plane_stack(c.tpixels, c.gp, c.taux, 16, 16, 16)
    assert not torch.equal(planes, axial)
