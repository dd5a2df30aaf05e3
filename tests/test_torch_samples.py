"""dirt_tpu_torch.samples (the port's sample programs) against the
repository's samples/, on the CPU.

Each port sample's `render` must give the JAX sample's own `render`
(imported from samples/) at 160x120 within 1e-4 (the scene math rounds
in another order), and the deferred and textured fits' first gradients
(to the light, to the texture) within 1e-4 of max |grad|.  At 640x480 the
port's renders, quantised as the samples' save_ppm does, must be within
one level of the checked-in samples/simple.ppm and samples/deferred.ppm
(and samples/textured.ppm, whose texture PIL reads) on at most 1% of
values.  Each fit's loss must fall, and the samples write their images
into --out, never over samples/*.ppm.
"""

import importlib
import os
import pathlib
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dirt_tpu_torch.samples import common, deferred, simple, textured

REPO = pathlib.Path(__file__).resolve().parents[1]
SAMPLES = REPO / "samples"
FIT_W, FIT_H = 160, 120


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


@pytest.fixture(scope="module")
def jax_samples():
    """The repository's samples/ modules (they import `common` from their
    own directory)."""
    sys.path.insert(0, str(SAMPLES))
    try:
        yield {name: importlib.import_module(name)
               for name in ("simple", "deferred", "textured")}
    finally:
        sys.path.remove(str(SAMPLES))
        for name in ("simple", "deferred", "textured", "common"):
            sys.modules.pop(name, None)


def _close(got, want, tol=1e-4):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= tol


def _close_grad(got, want):
    got, want = got.detach().numpy(), np.asarray(want)
    scale = float(np.abs(want).max())
    assert scale > 0 and np.isfinite(got).all()
    assert float(np.abs(got - want).max()) / scale <= 1e-4


def _read_ppm(path):
    with open(path, "rb") as f:
        magic, size, levels, data = f.read().split(b"\n", 3)
    assert magic == b"P6" and levels == b"255"
    w, h = map(int, size.split())
    return np.frombuffer(data, np.uint8).reshape(h, w, 3)


def _levels_close(got, path):
    """`got` (pixels, or uint8 levels) within one level of the image at
    `path` on at most 1% of values."""
    want = _read_ppm(path).astype(np.int64)
    if not (isinstance(got, np.ndarray) and got.dtype == np.uint8):
        got = common.to_levels(got)
    got = got.astype(np.int64)
    assert got.shape == want.shape
    diff = np.abs(got - want)
    assert int(diff.max()) <= 1
    assert np.count_nonzero(diff) <= 0.01 * diff.size


def test_simple_render(jax_samples):
    rotation = np.array([0., 0.5, 0.], np.float32)
    _close(simple.render(torch.as_tensor(rotation), FIT_W, FIT_H),
           jax_samples["simple"].render(jnp.asarray(rotation), FIT_W, FIT_H))


def test_deferred_render_and_light_gradient(jax_samples):
    jdeferred = jax_samples["deferred"]
    unit = lambda v: v / jnp.linalg.norm(v)
    target = np.asarray(jdeferred.render(
        unit(jnp.asarray(deferred.TRUE_LIGHT)), FIT_W, FIT_H))
    light = np.array(deferred.START_LIGHT, np.float32)
    _close(deferred.render(deferred.unit(torch.as_tensor(light)), FIT_W,
                           FIT_H),
           jdeferred.render(unit(jnp.asarray(light)), FIT_W, FIT_H))
    want = jax.grad(lambda l: jnp.mean(
        (jdeferred.render(unit(l), FIT_W, FIT_H) - target) ** 2))(
        jnp.asarray(light))
    leaf = torch.tensor(light, requires_grad=True)
    torch.mean((deferred.render(deferred.unit(leaf), FIT_W, FIT_H)
                - torch.as_tensor(target)) ** 2).backward()
    _close_grad(leaf.grad, want)


def test_textured_render_and_texture_gradient(jax_samples):
    jtextured = jax_samples["textured"]
    texture = textured.stripes_texture()
    np.testing.assert_array_equal(texture, jtextured.stripes_texture())
    grey = np.full_like(texture, 0.5)
    _close(textured.render(torch.as_tensor(texture), FIT_W, FIT_H),
           jtextured.render(jnp.asarray(texture), FIT_W, FIT_H))
    target = np.asarray(jtextured.render(jnp.asarray(texture), FIT_W,
                                         FIT_H))
    want = jax.grad(lambda t: jnp.mean(
        (jtextured.render(t, FIT_W, FIT_H) - target) ** 2))(
        jnp.asarray(grey))
    leaf = torch.tensor(grey, requires_grad=True)
    torch.mean((textured.render(leaf, FIT_W, FIT_H)
                - torch.as_tensor(target)) ** 2).backward()
    _close_grad(leaf.grad, want)


def test_full_size_renders_match_the_checked_in_images():
    with torch.no_grad():
        _levels_close(simple.render([0., 0.5, 0.], device="cpu"),
                      SAMPLES / "simple.ppm")
        light = deferred.unit(torch.tensor(deferred.TRUE_LIGHT))
        _levels_close(deferred.render(light), SAMPLES / "deferred.ppm")


def test_full_size_textured_render_matches_the_checked_in_image():
    pytest.importorskip("PIL")
    with torch.no_grad():
        _levels_close(textured.render(textured.photo_texture(),
                                      device="cpu"),
                      SAMPLES / "textured.ppm")


@pytest.mark.parametrize("name", ["simple", "deferred", "textured"])
def test_fit_loss_falls(name):
    module = {"simple": simple, "deferred": deferred,
              "textured": textured}[name]
    args = (textured.stripes_texture(),) if name == "textured" else ()
    losses, _ = module.fit(*args, device="cpu", log=lambda *_: None)
    assert len(losses) == module.STEPS
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


def test_sample_writes_into_out_not_over_samples(tmp_path):
    before = (SAMPLES / "simple.ppm").read_bytes()
    # One torch thread in the sample's process too (one_torch_thread's
    # reason): beside the suite's workers a thread a core made its fit
    # take over 300 s where it takes a few alone.
    subprocess.run([sys.executable, "-m", "dirt_tpu_torch.samples.simple",
                    "--device", "cpu", "--out", str(tmp_path)], cwd=REPO,
                   check=True, capture_output=True, timeout=300,
                   env=dict(os.environ, OMP_NUM_THREADS="1"))
    _levels_close(_read_ppm(tmp_path / "simple.ppm"),
                  SAMPLES / "simple.ppm")
    assert (SAMPLES / "simple.ppm").read_bytes() == before
    assert common.OUT_DIR != str(SAMPLES)
