"""Rasterisation backends and gradient assembly for the PyTorch port."""
