"""ops.hits.window_share: the share (%) of an image's (tile, block) pairs
that K4's tile windows hold, both packs, over the traced steps' images.

The port's forward.hit_window and backward.hit_window counters (in the
dirt.forward.hits and dirt.backward.hits spans) sum the tiles of each
(image, block) window, the pairs on which K4 runs its faces' exact test;
each pack that counted adds T x NB pairs an image to the denominator, at
its module's tile and block shape (forward_blocks, grad_blocks).  Nothing
where the port counts no windows."""

import importlib

from bench_h100.harness.stages import counted

PACKS = (("forward.hit_window", "forward_blocks"),
         ("backward.hit_window", "grad_blocks"))


def _cdiv(a, b):
    return -(-a // b)


def read(readings):
    tiles = pairs = 0
    for name, module in PACKS:
        value = counted(readings, name)
        if value is None:
            continue
        pack = importlib.import_module(f"dirt_tpu_torch.ops.{module}")
        tiles += value
        pairs += (_cdiv(readings.height, pack.TILE_H)
                  * _cdiv(readings.width, pack.TILE_W)
                  * _cdiv(readings.num_faces, pack.CHUNK))
    if not pairs:
        return None
    return 100.0 * tiles / (pairs * readings.trace.steps * readings.batch)
