"""Host geometry: glyph triangulation into curve and interior triangles.

A copy of ``fontrx/geometry``: each quadratic segment classifies as a
concave or convex curve triangle or a straight line, curve triangles carry
the implicit-quadratic texcoords, and the interior is ear-clipped with hole
bridging into solid triangles, ordered ``[concave][convex][solid]``. The
Loop-Blinn fill (``fontrx_torch.kernels.loopblinn``) rasterizes the mesh.
"""

from fontrx_torch.geometry.triangulated_glyph import TriangulatedGlyph  # noqa: F401
from fontrx_torch.geometry.triangulate import triangulate_polygon  # noqa: F401
