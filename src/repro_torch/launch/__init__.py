"""Launching the port on a mesh: :func:`make_serve_mesh` and
:func:`make_host_mesh` build a ``data x model`` :class:`ServeMesh` over
``torch.distributed`` (one process per mesh position);
:func:`make_production_mesh` is the 256- or 512-card production mesh as
a :class:`RecordingMesh` for the dry run (:mod:`.dryrun`) over the
(architecture x shape) grid of :mod:`.shapes`."""
from .mesh import (RecordingMesh, ServeMesh, make_host_mesh,
                   make_production_mesh, make_serve_mesh)

__all__ = ["RecordingMesh", "ServeMesh", "make_host_mesh",
           "make_production_mesh", "make_serve_mesh"]
