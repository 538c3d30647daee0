"""The port's TrueType ``glyf`` front end: a copy of the parts of
``fontrx.font`` that the raster paths read (see ``font.py``)."""
