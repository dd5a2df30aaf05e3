"""Renderer model families: the reference's canonical pipelines as modules
(PyTorch port of dirt_tpu/models/).

  * GouraudRenderer  -- direct per-vertex lighting (samples/simple.py)
  * DeferredPhongRenderer -- G-buffer + per-pixel ambient/diffuse/specular
    (samples/deferred.py)
  * TexturedRenderer -- UV G-buffer + bilinear texture sampling + diffuse
    (samples/textured.py)
"""

from .renderers import (Camera, DeferredPhongRenderer, GouraudRenderer,
                        TexturedRenderer)

__all__ = ["Camera", "GouraudRenderer", "DeferredPhongRenderer",
           "TexturedRenderer"]
