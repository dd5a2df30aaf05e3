"""Scene helpers for the PyTorch port: procedural meshes, the native C++
oracle binding and numpy <-> torch conversion."""
