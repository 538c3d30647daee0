"""fontrx_torch: the fontrx glyph rasterizer on PyTorch and CUDA.

A port of ``fontrx`` (JAX/Pallas on a TPU) to PyTorch with hand-written
CUDA kernels for NVIDIA Hopper. The host front end (font parsing, segment
packing, the NumPy oracle, raster grids, QOI) is imported from ``fontrx``,
whose modules for it import no JAX. This package never imports JAX.

- ``device``          toolchain probe and ``require_cuda``
- ``kernels.winding`` the CUDA winding kernel, and ``kernels.winding_ref``
  its plain PyTorch version
- ``engine.raster``   ``RasterEngine``: batched winding maps and fills
- ``engine.atlas``    character-set packing and atlas rendering
- ``convert``         host batches and grids to tensors on a device
- ``entry``           ``entry()``: the raster step and an example batch
"""
