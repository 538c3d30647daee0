"""Glyph outlines -> padded quadratic-segment arrays (see ``segments.py``)."""
