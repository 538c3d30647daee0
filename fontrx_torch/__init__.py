"""fontrx_torch: the fontrx glyph rasterizer on PyTorch and CUDA.

A port of ``fontrx`` (JAX/Pallas on a TPU) to PyTorch with hand-written
CUDA kernels for NVIDIA Hopper. It owns its host front end: NumPy copies of
the parts of ``fontrx`` that its paths read (the TrueType ``glyf`` reader,
segment packing, raster grids, the NumPy oracle, QOI, the glyph
triangulation, the view transform and the plain text layout), each held
equal to its original by a test. It imports neither JAX nor anything of
``fontrx``.

- ``device``              toolchain probe and ``require_cuda``
- ``font``                the TrueType ``glyf`` front end (``Font``)
- ``pack.segments``       glyph outlines -> padded segment arrays
- ``io.qoi``              QOI encoder and decoder
- ``geometry``            glyph outlines -> classified triangle meshes
- ``kernels.grid``        ``RasterGrid``: the pixel -> em-space mapping
- ``kernels.oracle``      the NumPy winding oracle
- ``kernels.winding``     the CUDA winding kernel, and
  ``kernels.winding_ref`` its plain PyTorch version
- ``kernels.coverage``    the CUDA k x k coverage kernel, and
  ``kernels.coverage_ref`` its plain PyTorch version
- ``kernels.sdf``         the CUDA SDF kernel, and ``kernels.sdf_ref`` its
  plain PyTorch version
- ``kernels.loopblinn``   the CUDA Loop-Blinn triangle kernel and
  ``loopblinn_fill``, and ``kernels.loopblinn_ref`` its plain PyTorch
  version
- ``kernels.page``        the CUDA page kernel, and ``kernels.page_ref``
  its plain PyTorch version
- ``engine.raster``       ``RasterEngine``: batched winding maps, fills,
  coverage and SDF atlases
- ``engine.atlas``        character-set packing and atlas rendering
- ``engine.sharding``     meshes of devices and every family sharded over
  them (glyphs, glyphs x row bands, a page's row bands)
- ``scene.transform``     the view transform (zoom, pan)
- ``scene.layout``        text -> glyph instances (the plain path)
- ``scene.page``          ``PageRenderer.render_direct``: a whole page in
  one kernel launch
- ``convert``             host batches and grids to tensors on a device
- ``entry``               ``entry()``: the raster step and an example batch;
  ``dryrun_multichip`` and ``dryrun_multihost``, the multi-device dry runs
"""
