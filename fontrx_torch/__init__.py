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
- ``cli``                 the command line, ``python -m fontrx_torch``
  (``cli.config`` the flags, ``cli.main`` the modes and the ``-i`` loop)
- ``render_text``         one call from text to an RGB image, through the
  command line's modes
"""


def render_text(font, text, *, size=256, mode="fill", engine=None, **options):
    """One-call rendering: ``text`` -> uint8 RGB image array ``[H, W, 3]``
    on the host.

    ``font`` is a path, raw bytes, or an opened ``Font``; ``mode`` and
    ``options`` are the command line's flags (``samples=3``,
    ``mode="sdf"``, ``backend="cpu"``, ...), rendered by the same dispatch
    as ``python -m fontrx_torch``. ``engine=None`` makes a ``RasterEngine``
    on the device that ``backend`` names (default: the first CUDA device);
    pass one to choose the device. An option the command line does not
    have is a ``TypeError``; ``fallback``, ``variation`` and a layout
    option away from its default raise ``NotImplementedError``, as their
    flags do.

    >>> img = render_text("DejaVuSans.ttf", "Hello", size=64)
    >>> img.shape   # (H, W, 3) uint8
    """
    import dataclasses

    from fontrx_torch.cli.config import Config
    from fontrx_torch.cli.main import _render, check_options, engine_for
    from fontrx_torch.font.font import Font

    if isinstance(font, str):
        font = Font.open(font)
    elif isinstance(font, (bytes, bytearray)):
        font = Font(bytes(font))

    valid = {f.name for f in dataclasses.fields(Config)}
    cli_only = {"interactive", "output", "serve", "font_file", "text", "cache"}
    unknown = set(options) - (valid - cli_only)
    if unknown:
        raise TypeError(f"unknown render options: {sorted(unknown)}")
    cfg = Config(font_file="<memory>", text=text, size=size, mode=mode, **options)
    check_options(cfg)
    if engine is None:
        engine = engine_for(cfg.backend)
    return _render(font, text, cfg, engine)
