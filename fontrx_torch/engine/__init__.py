"""Raster engine and atlas batching on PyTorch tensors."""
