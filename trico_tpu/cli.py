"""Command-line encoder/decoder, feature parity with the reference tools
(``tools/trico_encoder/main.c``, ``tools/trico_decoder/main.c``).

Flags:
  encoder: -i <input.stl|.ply> [-o out.trc] [-stladd normal|uint16]
           [-plyskip normal|tex_coord|color]
  decoder: -i <input.trc> [-o out.stl|.ply]

Deliberate fix of reference quirk #3 (SURVEY.md): ``-stladd`` options control
the STL attributes and ``-plyskip`` the PLY attributes (the reference
cross-wires them, trico_encoder/main.c:144-191).
"""

from __future__ import annotations

import argparse
import contextlib
import sys
from pathlib import Path

import numpy as np

from .archive import ArchiveReader, ArchiveWriter, StreamType
from .compile_cache import enable_compile_cache
from .io import ply, stl
from .profiling import StageTimer


def _stager(enabled: bool):
    """Return (timer, stage) where stage(name, nbytes) is a context manager;
    a no-op when profiling is off."""
    if not enabled:
        return None, lambda name, nbytes=0: contextlib.nullcontext()
    prof = StageTimer()
    return prof, prof.stage


def _default_output(path: Path, ext: str) -> Path:
    return path.with_suffix(ext)


def encoder_main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="trico_encoder",
        description="Compress a binary STL or PLY mesh into a trico archive.",
    )
    ap.add_argument("-i", dest="input", required=True, help="input .stl or .ply file")
    ap.add_argument("-o", dest="output", help="output file name (default: input with .trc)")
    ap.add_argument("-stladd", action="append", default=[], choices=["normal", "uint16"],
                    help="also store the given STL attribute")
    ap.add_argument("-plyskip", action="append", default=[], choices=["normal", "tex_coord", "color"],
                    help="skip the given PLY attribute")
    ap.add_argument("--backend", default="auto", choices=["auto", "native", "numpy", "jax"],
                    help="codec backend (default auto: native, falling back to numpy)")
    ap.add_argument("--chunked", nargs="?", const=4096, type=int, default=None,
                    metavar="CHUNK_LEN",
                    help="write a version-1 chunk-parallel archive (adaptive "
                         "exponents + BP32 pick-best integers; not readable "
                         "by the reference library). Default chunk: 4096")
    ap.add_argument("--keep-doubles", action="store_true",
                    help="preserve float64 PLY vertex coordinates as a "
                         "vertex_double stream (the reference tools truncate "
                         "doubles to float)")
    ap.add_argument("--fast", action="store_true",
                    help="throughput profile: skip the adaptive exponent "
                         "search (v0: reference default exponents; v1 "
                         "--chunked: small-table candidate set only, every "
                         "chunk device-decodable, a few %% larger output)")
    ap.add_argument("--profile", action="store_true",
                    help="print per-stage timing/GB/s report to stderr")
    args = ap.parse_args(argv)
    enable_compile_cache()

    inp = Path(args.input)
    out = Path(args.output) if args.output else _default_output(inp, ".trc")
    ext = inp.suffix.lower()
    if ext not in (".stl", ".ply"):
        print("I expect the input file to be of type stl or ply.", file=sys.stderr)
        return 1

    prof, stage = _stager(args.profile)
    use_native = args.backend in ("auto", "native")
    opt = "fast" if args.fast else True
    if args.backend == "jax" or args.chunked:
        # device chunk-parallel path → version-1 chunked archive
        w = ArchiveWriter(chunk_len=args.chunked or 4096, optimize=opt)
    else:
        w = ArchiveWriter(use_native=use_native, optimize=opt)
    if ext == ".stl":
        full = bool(args.stladd)
        with stage("read_stl", inp.stat().st_size):
            if full:
                verts, tris, tri_normals, attrs = stl.read_stl(inp, full=True)
            else:
                verts, tris = stl.read_stl(inp)
                tri_normals = attrs = None
        if len(verts):
            with stage("encode_vertices", verts.nbytes):
                w.write_vertices(verts)
        if len(tris):
            with stage("encode_triangles", tris.nbytes):
                w.write_triangles(tris)
        if "normal" in args.stladd and tri_normals is not None and len(tris):
            with stage("encode_tri_normals", tri_normals.nbytes):
                w.write_triangle_normals(tri_normals)
        if "uint16" in args.stladd and attrs is not None and len(tris):
            with stage("encode_attrs_u16", attrs.nbytes):
                w.write_attributes_uint16(attrs)
    else:
        with stage("read_ply", inp.stat().st_size):
            mesh = ply.read_ply(inp, keep_doubles=args.keep_doubles)
        if mesh.vertices is not None and len(mesh.vertices):
            with stage("encode_vertices", mesh.vertices.nbytes):
                if mesh.vertices.dtype == np.float64:
                    w.write_vertices_double(mesh.vertices)
                else:
                    w.write_vertices(mesh.vertices)
        if mesh.triangles is not None and len(mesh.triangles):
            with stage("encode_triangles", mesh.triangles.nbytes):
                w.write_triangles(mesh.triangles)
        if "normal" not in args.plyskip and mesh.vertex_normals is not None:
            with stage("encode_normals", mesh.vertex_normals.nbytes):
                w.write_vertex_normals(mesh.vertex_normals)
        if "color" not in args.plyskip and mesh.vertex_colors is not None:
            with stage("encode_colors", mesh.vertex_colors.nbytes):
                w.write_vertex_colors(mesh.vertex_colors)
        if "tex_coord" not in args.plyskip and mesh.texcoords is not None:
            with stage("encode_uvs", mesh.texcoords.nbytes):
                w.write_uv_per_triangle(mesh.texcoords)
    with stage("write_archive"):
        w.save(out)
    if prof:
        print(prof.report(), file=sys.stderr)
    return 0


def decoder_main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="trico_decoder",
        description="Decompress a trico archive back to STL or PLY.",
    )
    ap.add_argument("-i", dest="input", required=True, help="input .trc file")
    ap.add_argument("-o", dest="output", help="output .stl or .ply (default: by content)")
    ap.add_argument("--ply-storage", default="binary_le",
                    choices=["binary_le", "binary_be", "ascii"],
                    help="PLY output storage mode (default binary_le)")
    ap.add_argument("--profile", action="store_true",
                    help="print per-stage timing/GB/s report to stderr")
    args = ap.parse_args(argv)
    enable_compile_cache()

    prof, stage = _stager(args.profile)
    data = Path(args.input).read_bytes()
    r = ArchiveReader(data)
    verts = tris = tri_normals = vert_normals = colors = uvs = attrs16 = None
    while r.next_stream_type != StreamType.empty:
        st_name = r.next_stream_type.name
        with stage(f"decode_{st_name}"):
            st, arr = r.read_stream()
        if prof:
            prof.stages[f"decode_{st_name}"].nbytes += arr.nbytes
        if st in (StreamType.vertex_float, StreamType.vertex_double):
            verts = arr  # f64 stays f64 into PLY output (double properties)
        elif st == StreamType.triangle_uint32:
            tris = arr
        elif st == StreamType.triangle_normal_float:
            tri_normals = arr
        elif st == StreamType.vertex_normal_float:
            vert_normals = arr
        elif st == StreamType.vertex_color:
            colors = arr
        elif st == StreamType.uv_per_triangle_float:
            uvs = arr.reshape(-1, 6)
        elif st == StreamType.attribute_uint16:
            attrs16 = arr
        # other stream kinds are skipped, like the reference decoder

    if verts is None:
        print("Archive contains no vertices.", file=sys.stderr)
        return 1

    if args.output:
        out = Path(args.output)
        want_ply = out.suffix.lower() == ".ply"
    else:
        # content-based choice (trico_decoder/main.c:414-437); f64 vertices
        # pick PLY so the doubles survive (STL is float32-only)
        want_ply = (colors is not None or uvs is not None
                    or vert_normals is not None
                    or verts.dtype == np.float64)
        out = _default_output(Path(args.input), ".ply" if want_ply else ".stl")

    with stage("write_mesh"):
        if want_ply:
            ply.write_ply(out, verts, vert_normals, colors, tris, uvs,
                          storage=args.ply_storage)
        else:
            if tris is None:
                tris = np.zeros((0, 3), np.uint32)
            if tri_normals is None and len(tris):
                tri_normals = stl.compute_triangle_normals(verts, tris)
            stl.write_stl(out, verts, tris, tri_normals, attrs16)
    if prof:
        print(prof.report(), file=sys.stderr)
    return 0


def main(argv=None) -> int:
    """``python -m trico_tpu.cli {encode|decode} ...`` dispatcher."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: python -m trico_tpu.cli {encode|decode} [options]\n"
              "       encode -i mesh.{stl,ply} [-o out.trc] [-stladd ...] [-plyskip ...]\n"
              "       decode -i in.trc [-o out.{stl,ply}]",
              file=sys.stderr if argv else sys.stdout)
        return 1 if argv else 0
    cmd, rest = argv[0], argv[1:]
    if cmd == "encode":
        return encoder_main(rest)
    if cmd == "decode":
        return decoder_main(rest)
    print(f"unknown command {cmd!r} (want encode or decode)", file=sys.stderr)
    return 1


if __name__ == "__main__":
    raise SystemExit(main())
