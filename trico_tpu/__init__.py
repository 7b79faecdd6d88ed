"""trico-tpu: a lossless mesh / point-cloud compression framework in JAX.

Drop-in capability parity with the trico C library (archive format, codecs,
mesh I/O, CLI tools), re-designed for a data-parallel device (a CUDA GPU):

* :mod:`trico_tpu.archive` — the trico container (reference-compatible v0 and
  chunk-parallel v1 archives): :class:`ArchiveWriter`, :class:`ArchiveReader`.
* :mod:`trico_tpu.codec` — codecs: NumPy oracle (``fp_ref``), device
  chunk-parallel JAX codecs (``fp_jax``, ``replay_triton``), LZ4 fallback (``lz4_ref``),
  transposes.
* :mod:`trico_tpu.native` — C++ host runtime (scalar FP codec, LZ4 block
  codec, pack/parse marshalling), built on demand.
* :mod:`trico_tpu.chunked` — the chunked substream container (v1 extension).
* :mod:`trico_tpu.parallel` — multi-chip sharded encode/decode over a device
  mesh.
* :mod:`trico_tpu.io` — vectorized STL / PLY readers and writers.
* :mod:`trico_tpu.cli` — ``trico_encoder`` / ``trico_decoder`` tools.

Quick start::

    from trico_tpu import ArchiveWriter, ArchiveReader, read_stl

    verts, tris = read_stl("bunny.stl")
    w = ArchiveWriter()            # reference-compatible archive
    w.write_vertices(verts)
    w.write_triangles(tris)
    open("bunny.trc", "wb").write(w.tobytes())

    r = ArchiveReader(open("bunny.trc", "rb").read())
    verts2 = r.read_vertices()     # bit-exact
"""

from .archive import ArchiveReader, ArchiveWriter, StreamType
from .io.ply import PlyMesh, read_ply, write_ply
from .io.stl import compute_triangle_normals, read_stl, write_stl

__version__ = "0.1.0"

__all__ = [
    "ArchiveReader",
    "ArchiveWriter",
    "StreamType",
    "PlyMesh",
    "read_ply",
    "write_ply",
    "read_stl",
    "write_stl",
    "compute_triangle_normals",
    "__version__",
]
