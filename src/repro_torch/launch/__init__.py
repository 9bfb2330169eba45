"""Launching the port on a mesh: :func:`make_serve_mesh` and
:func:`make_host_mesh` build a ``data x model`` :class:`ServeMesh` over
``torch.distributed`` (one process per mesh position)."""
from .mesh import ServeMesh, make_host_mesh, make_serve_mesh

__all__ = ["ServeMesh", "make_host_mesh", "make_serve_mesh"]
