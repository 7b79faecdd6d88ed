"""Corpus size gate: our archives vs the compiled reference on ≥6 mesh classes.

Encodes every corpus mesh (tests/corpus.py) three ways —

* ``ref``: the compiled reference C library (tests/ref_oracle.ref_archive),
* ``v0``:  our reference-compatible archive (ArchiveWriter, adaptive
           whole-plane exponents — still reference-decodable),
* ``v1``:  our chunked archive (ArchiveWriter(chunk_len=4096), the
           parallel-codec product path)

— verifies our round-trips bit-exactly, and writes ``CORPUS.json`` with the
size table. The gate target (VERDICT r4 #1 / BASELINE.md): v0 ≤ ref and
v1 ≤ ref on every mesh class, not just the bunny.

Usage: JAX_PLATFORMS=cpu python scripts/corpus_gate.py [--json CORPUS.json]
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tests"))

# force the CPU backend: this gate is a host-side size measurement and must
# not depend on (or wait for) an accelerator.
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")


def our_archive(mesh: dict, chunk_len=None, optimize=True) -> bytes:
    from trico_tpu.archive import ArchiveWriter

    w = ArchiveWriter(chunk_len=chunk_len, optimize=optimize)
    verts = np.ascontiguousarray(mesh["vertices"])
    if verts.dtype == np.float64:
        w.write_vertices_double(verts)
    else:
        w.write_vertices(verts)
    tris = mesh.get("triangles")
    if tris is not None:
        if np.asarray(tris).dtype == np.uint64:
            w.write_triangles_long(tris)
        else:
            w.write_triangles(tris)
    if "vertex_normals" in mesh:
        w.write_vertex_normals(mesh["vertex_normals"])
    if "vertex_colors" in mesh:
        w.write_vertex_colors(mesh["vertex_colors"])
    if "uv_per_vertex" in mesh:
        w.write_uv_per_vertex(mesh["uv_per_vertex"])
    return w.tobytes()


def roundtrip_check(blob: bytes, mesh: dict) -> None:
    from trico_tpu.archive import ArchiveReader, StreamType

    r = ArchiveReader(blob)
    got = {}
    while r.next_stream_type != StreamType.empty:
        st, arr = r.read_stream()
        got[st.name] = arr
    verts = np.ascontiguousarray(mesh["vertices"])
    key = "vertex_double" if verts.dtype == np.float64 else "vertex_float"
    dt = np.uint64 if verts.dtype == np.float64 else np.uint32
    assert np.array_equal(got[key].view(dt), verts.view(dt)), "vertices"
    tris = mesh.get("triangles")
    if tris is not None:
        tkey = ("triangle_uint64" if np.asarray(tris).dtype == np.uint64
                else "triangle_uint32")
        assert np.array_equal(got[tkey], tris), "triangles"


def main() -> int:
    import corpus as corpus_mod
    import ref_oracle

    out_path = "CORPUS.json"
    if "--json" in sys.argv:
        out_path = sys.argv[sys.argv.index("--json") + 1]
    meshes = corpus_mod.build_corpus()
    rows = {}
    fails = []
    for name, mesh in meshes.items():
        raw_bytes = sum(np.ascontiguousarray(v).nbytes for v in mesh.values())
        t0 = time.perf_counter()
        ref = ref_oracle.ref_archive(mesh)
        t_ref = time.perf_counter() - t0
        t0 = time.perf_counter()
        v0 = our_archive(mesh)
        t_v0 = time.perf_counter() - t0
        t0 = time.perf_counter()
        v1 = our_archive(mesh, chunk_len=4096)
        t_v1 = time.perf_counter() - t0
        roundtrip_check(v0, mesh)
        roundtrip_check(v1, mesh)
        row = {
            "raw_bytes": int(raw_bytes),
            "ref_bytes": len(ref) if ref else None,
            "v0_bytes": len(v0),
            "v1_bytes": len(v1),
            "ref_ratio": round(raw_bytes / len(ref), 3) if ref else None,
            "v0_ratio": round(raw_bytes / len(v0), 3),
            "v1_ratio": round(raw_bytes / len(v1), 3),
            "v0_vs_ref": round(len(v0) / len(ref), 4) if ref else None,
            "v1_vs_ref": round(len(v1) / len(ref), 4) if ref else None,
            "t_ref_s": round(t_ref, 3), "t_v0_s": round(t_v0, 3),
            "t_v1_s": round(t_v1, 3),
        }
        rows[name] = row
        ok0 = ref is None or len(v0) <= len(ref)
        ok1 = ref is None or len(v1) <= len(ref)
        if not ok0:
            fails.append(f"{name}: v0 {len(v0)} > ref {len(ref)}")
        if not ok1:
            fails.append(f"{name}: v1 {len(v1)} > ref {len(ref)}")
        print(f"{name:8s} raw={raw_bytes:>10,d} ref={row['ref_bytes']:>9,} "
              f"v0={len(v0):>9,d} ({row['v0_vs_ref']}) "
              f"v1={len(v1):>9,d} ({row['v1_vs_ref']}) "
              f"{'OK' if ok0 and ok1 else 'FAIL'}")
    Path(out_path).write_text(json.dumps(rows, indent=1) + "\n")
    if fails:
        print("GATE FAILURES:")
        for f in fails:
            print(" ", f)
        return 1
    print("corpus gate: all meshes ≤ reference size")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
