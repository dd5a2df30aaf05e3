"""Kernels that pin patterns on the GPU rather than serve the renderer."""
