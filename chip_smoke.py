#!/usr/bin/env python
"""Run trico-tpu's main path once on one CUDA GPU and check every result.

    python chip_smoke.py              # phases 1-7 on one card
    python chip_smoke.py --cards 4    # only the sharded 4-card path

Phases (each prints its own lines; any failure exits non-zero):

1. device: JAX's platform, device kind and count, and the card's name and
   power limit from nvidia-smi; anything but a GPU stops here, printing no
   result.
2. programs at real width: the f32 v2 encode (fixed (4,6) and adaptive) and
   decode compiled at (C, L) = (10752, 4096), with memory_analysis(); payloads
   of >= 64 seeded chunks (first and last included) equal the fp_ref oracle's,
   and the full decode is bit-exact on raw u32. Times the Pallas-Triton
   replay kernel against the XLA scan.
3. Lucy-class mesh end to end: 14M f32 vertices + 28M u32 triangles through
   compress_mesh -> bytes -> decompress_mesh on a one-GPU mesh, bit-exact,
   the bytes equal to ArchiveWriter(chunk_len=4096, layout="tpu")'s, every FP
   plane decoded on the device.
4. f64 + u64: a 2M-vertex double mesh with 64-bit indices through
   compress_mesh / decompress_mesh / ArchiveReader, bit-exact.
5. CLI: trico_encoder --chunked and plain v0, then trico_decoder, on the
   bunny, bit-exact.
6. canary: (C, L) = (8192, 1024) encode -> decode bit-exact through the
   row-blocked entry points; also reports whether the unblocked program is.
7. the `gpu`-marked tests, in this process.

The last line is one JSON object: {"ok": true, "device": {...}}.
The native host library is built from trico_tpu/native/codec.cpp into a fresh
directory first. Data is synthesized from fixed seeds.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time
import traceback
from pathlib import Path

REPO = Path(__file__).resolve().parent
BUILD = REPO / "build"
L = 4096


def say(*parts):
    print(*parts, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def peak_bytes(dev) -> int:
    return dev.memory_stats()["peak_bytes_in_use"]


def device_stream(n, seed):
    """Smooth f32 coordinate-like stream made on the device, as raw u32."""
    import jax
    import jax.numpy as jnp

    step = jax.random.normal(jax.random.PRNGKey(seed), (n,), jnp.float32) * 1e-3
    v = jnp.cumsum(step) + jnp.sin(jnp.linspace(0., 3000., n)) * 10
    return jax.lax.bitcast_convert_type(v.astype(jnp.float32), jnp.uint32)


def median_wall(fn, reps=3):
    import jax

    out = fn()
    jax.block_until_ready(out)
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return sorted(ts)[len(ts) // 2], out


def decode_grouped(mat, sizes, chunk_len):
    """Decode v2 payload rows the way decompress_mesh does: each hash_info
    group on the device, groups past the replay bound on host threads.
    Returns (values (C, L), chunks decoded on the host)."""
    import jax.numpy as jnp
    import numpy as np

    from trico_tpu import chunked
    from trico_tpu.codec import fp_jax
    from trico_tpu.parallel.mesh_codec import _DEVICE_TABLE_ROWS

    out = np.empty((mat.shape[0], chunk_len), np.uint32)
    on_host = 0
    for hi in np.unique(mat[:, 0]):
        idx = np.nonzero(mat[:, 0] == hi)[0]
        e1, e2 = (int(hi) >> 4) << 1, (int(hi) & 15) << 1
        if (1 << e1) + (1 << e2) > _DEVICE_TABLE_ROWS:
            out[idx] = chunked.host_decode_full_chunks(
                mat, sizes, idx, chunk_len, 32, "tpu")
            on_host += len(idx)
        else:
            out[idx] = np.asarray(fp_jax.decode_f32_chunks_v2(
                jnp.asarray(mat[idx]), chunk_len, e1, e2))
    return out, on_host


def phase_programs(dev):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from trico_tpu.codec import fp_jax, fp_ref, replay_triton

    C = 10752
    x = device_stream(C * L, 0).reshape(C, L)
    enc = fp_jax.encode_f32_chunks_v2.lower(x, 4, 6).compile()
    ada = fp_jax.encode_f32_chunks_v2_adaptive.lower(x).compile()
    say(f"  encode_v2(4,6) memory_analysis: {enc.memory_analysis()}")
    say(f"  encode_v2_adaptive memory_analysis: {ada.memory_analysis()}")
    pay, sizes = enc(x)
    dec = fp_jax.decode_f32_chunks_v2.lower(pay, L, 4, 6).compile()
    say(f"  decode_v2(4,6) memory_analysis: {dec.memory_analysis()}")
    pay_a, sizes_a = ada(x)

    rng = np.random.default_rng(2024)
    idx = np.unique(np.concatenate([[0, C - 1], rng.choice(C, 62, replace=False)]))
    xs = np.asarray(x[idx])
    pay_np, sz_np = np.asarray(pay[idx]), np.asarray(sizes[idx])
    pay_a_np = np.asarray(pay_a)
    sz_a_np = np.asarray(sizes_a)
    cands = fp_jax.F32_TPU_CANDIDATES
    for k, c in enumerate(idx):
        want = fp_jax.relayout_f32_v1_to_v2(
            np.frombuffer(fp_ref.compress(xs[k], 4, 6), np.uint8))
        assert pay_np[k, : sz_np[k]].tobytes() == want.tobytes(), f"fixed chunk {c}"
        refs = [fp_ref.compress(xs[k], *e) for e in cands]
        best = int(np.argmin([len(r) for r in refs]))
        want = fp_jax.relayout_f32_v1_to_v2(np.frombuffer(refs[best], np.uint8))
        assert pay_a_np[c, : sz_a_np[c]].tobytes() == want.tobytes(), \
            f"adaptive chunk {c}"
    say(f"  oracle: {len(idx)} chunks (first and last included) byte-equal "
        "to fp_ref, fixed and adaptive")

    out = dec(pay)
    assert bool(jnp.all(out == x)), "fixed (4,6) decode not bit-exact"
    vals, on_host = decode_grouped(pay_a_np, sz_a_np, L)
    assert np.array_equal(vals, np.asarray(x)), "adaptive decode not bit-exact"
    say(f"  full decode bit-exact: fixed {C}x{L}, adaptive {C}x{L} "
        f"({on_host} (14,18) chunks on host threads)")

    bc, xors = fp_jax.parse_f32_chunks_v2(pay, L, 4, 6)
    t_kernel, got_k = median_wall(lambda: replay_triton.replay(bc, xors, 4, 6))
    scan = jax.jit(fp_jax._replay_scan, static_argnums=(2, 3))
    t_scan, got_s = median_wall(lambda: scan(bc, xors, 4, 6))
    assert bool(jnp.all(got_k == x)) and bool(jnp.all(got_s == x))
    say(f"  replay (4,6) {C}x{L}: triton kernel {t_kernel:.6f} s, "
        f"XLA scan (unroll {fp_jax._SCAN_UNROLL}) {t_scan:.6f} s, "
        f"both bit-exact")
    say(f"  peak_bytes_in_use {peak_bytes(dev)}")


def phase_lucy(dev):
    import numpy as np

    from bench import grid_surface_mesh
    from trico_tpu.archive import ArchiveWriter
    from trico_tpu.parallel import mesh_codec

    verts, tris = grid_surface_mesh(14_000_000)
    raw = verts.nbytes + tris.nbytes
    say(f"  mesh: {len(verts)} vertices, {len(tris)} triangles, {raw} raw bytes")
    mesh = mesh_codec.make_mesh(1)
    t0 = time.perf_counter()
    blob = mesh_codec.compress_mesh(verts, tris, chunk_len=L, mesh=mesh)
    cold_enc = time.perf_counter() - t0
    t0 = time.perf_counter()
    blob = mesh_codec.compress_mesh(verts, tris, chunk_len=L, mesh=mesh)
    enc_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    mesh_codec.decompress_mesh(blob, mesh)
    cold_dec = time.perf_counter() - t0
    stats: dict = {}
    t0 = time.perf_counter()
    out = mesh_codec.decompress_mesh(blob, mesh, route_stats=stats)
    dec_s = time.perf_counter() - t0
    assert np.array_equal(out["vertices"].view(np.uint32),
                          verts.view(np.uint32)), "vertices not bit-exact"
    assert np.array_equal(out["triangles"], tris), "triangles not exact"
    say(f"  route_stats {stats}")
    assert stats["sharded_fp"] == 3 and stats["host_other"] == 0, stats
    say(f"  (14,18) chunks decoded on host threads by design: "
        f"{stats['host_fp_chunks']}")
    w = ArchiveWriter(chunk_len=L, layout="tpu")
    w.write_vertices(verts)
    w.write_triangles(tris)
    assert w.tobytes() == blob, "compress_mesh bytes != ArchiveWriter bytes"
    say(f"  archive {len(blob)} bytes, ratio {raw / len(blob):.4f}, "
        "bytes equal to ArchiveWriter(chunk_len=4096, layout='tpu')")
    say(f"  encode wall {enc_s:.3f} s warm ({cold_enc:.3f} s cold), "
        f"decode wall {dec_s:.3f} s warm ({cold_dec:.3f} s cold), "
        f"peak_bytes_in_use {peak_bytes(dev)}")


def phase_f64():
    import numpy as np

    from bench import grid_surface_mesh
    from trico_tpu.archive import ArchiveReader
    from trico_tpu.parallel import mesh_codec

    verts, tris = grid_surface_mesh(2_000_000, dtype=np.float64,
                                    index_dtype=np.uint64)
    mesh = mesh_codec.make_mesh(1)
    blob = mesh_codec.compress_mesh(verts, tris, chunk_len=L, mesh=mesh)
    stats: dict = {}
    out = mesh_codec.decompress_mesh(blob, mesh, route_stats=stats)
    assert np.array_equal(out["vertices"].view(np.uint64), verts.view(np.uint64))
    assert np.array_equal(out["triangles"], tris)
    r = ArchiveReader(blob)
    assert np.array_equal(r.read_vertices_double().view(np.uint64),
                          verts.view(np.uint64))
    assert np.array_equal(r.read_triangles_long(), tris)
    say(f"  {len(verts)} f64 vertices + {len(tris)} u64 triangles bit-exact "
        f"(archive {len(blob)} bytes, route_stats {stats})")


def phase_cli():
    import numpy as np

    from trico_tpu.cli import decoder_main, encoder_main
    from trico_tpu.io import stl

    bunny = REPO / "tests" / "data" / "StanfordBunny.stl"
    v0, t0 = stl.read_stl(bunny)
    tmp = BUILD / "smoke_cli"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    for name, extra in (("v1", ["--chunked"]), ("v0", [])):
        trc, back = tmp / f"{name}.trc", tmp / f"{name}.stl"
        assert encoder_main(["-i", str(bunny), "-o", str(trc), *extra]) == 0
        assert decoder_main(["-i", str(trc), "-o", str(back)]) == 0
        v1, t1 = stl.read_stl(back)
        assert np.array_equal(v1.view(np.uint32), v0.view(np.uint32)), name
        assert np.array_equal(t1, t0), name
        say(f"  {name} ({' '.join(extra) or 'reference format'}): "
            f"{trc.stat().st_size} bytes, bit-exact")


def phase_canary():
    import jax
    import jax.numpy as jnp

    from trico_tpu.codec import fp_jax

    Cc, Lc = 8192, 1024
    xc = device_stream(Cc * Lc, 7).reshape(Cc, Lc)
    pc, _ = fp_jax.encode_f32_chunks_v2(xc, 4, 6)
    ok = bool(jnp.all(fp_jax.decode_f32_chunks_v2(pc, Lc, 4, 6) == xc))
    assert ok, "row-blocked canary not bit-exact"
    say(f"  row-blocked canary {Cc}x{Lc}: bit-exact")
    enc = jax.jit(lambda v: fp_jax._pack_f32_chunks_v2_impl(
        *fp_jax.predict_f32_chunks(v, 4, 6), 4, 6))
    dec = jax.jit(lambda p: fp_jax._replay_impl(
        *fp_jax._parse_f32_chunks_v2_impl(p, Lc, 4, 6), 4, 6))
    pu, _ = enc(xc)
    same = bool(jnp.all(pu == pc))
    exact = bool(jnp.all(dec(pu) == xc))
    say(f"  unblocked canary {Cc}x{Lc} (one program, no row blocks) on XLA:GPU: "
        f"payloads equal to blocked: {same}, decode bit-exact: {exact}")


def phase_tests():
    import pytest

    os.environ["TRICO_TEST_PLATFORM"] = "gpu"
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      "-p", "no:xdist", "-p", "no:randomly",
                      str(REPO / "tests")])
    assert rc == 0, f"gpu-marked tests failed (pytest exit {rc})"


def phase_cards(n):
    import jax
    import numpy as np

    from trico_tpu.parallel import mesh_codec

    devs = jax.devices()
    assert len(devs) >= n, f"--cards {n}: JAX sees {len(devs)} devices"
    side = 10_000  # 100M points
    rng = np.random.default_rng(5)
    u = np.linspace(0.0, 1.0, side, dtype=np.float32)
    h = np.cumsum(rng.normal(0, 1e-3, (side, side)).astype(np.float32), axis=1)
    pts = np.stack([np.broadcast_to(u[:, None] * 50, (side, side)).ravel(),
                    np.broadcast_to(u[None, :] * 50, (side, side)).ravel(),
                    (np.sin(u[:, None] * 9) * np.cos(u[None, :] * 7) + h).ravel()],
                   axis=1).astype(np.float32)
    del h
    q = (pts[:, 2] * 40).astype(np.int64)
    rgba = ((q & 0xFF) | ((q * 3 & 0xFF) << 8) | (((q >> 2) & 0xFF) << 16)
            | (0xFF << 24)).astype(np.uint32)
    raw = pts.nbytes + rgba.nbytes
    say(f"  point cloud: {len(pts)} points, f32 xyz + u32 rgba, {raw} raw bytes")
    mesh_n = mesh_codec.make_mesh(n)
    t0 = time.perf_counter()
    blob = mesh_codec.compress_mesh(pts, vertex_colors=rgba, mesh=mesh_n)
    enc_s = time.perf_counter() - t0
    stats: dict = {}
    t0 = time.perf_counter()
    out = mesh_codec.decompress_mesh(blob, mesh_n, route_stats=stats)
    dec_s = time.perf_counter() - t0
    assert np.array_equal(out["vertices"].view(np.uint32), pts.view(np.uint32))
    assert np.array_equal(out["vertex_colors"], rgba)
    say(f"  {n}-card encode {enc_s:.3f} s, decode bit-exact {dec_s:.3f} s "
        f"(both include compilation), route_stats {stats}")
    for d in devs[:n]:
        say(f"  device {d.id} peak_bytes_in_use {peak_bytes(d)} "
            f"after the {n}-card encode and decode")
    one = mesh_codec.compress_mesh(pts, vertex_colors=rgba,
                                   mesh=mesh_codec.make_mesh(1))
    assert blob == one, f"{n}-card archive bytes differ from the 1-card archive"
    say(f"  archive {len(blob)} bytes (ratio {raw / len(blob):.4f}) identical "
        f"over {n} cards and over device 0 alone")


def build_native():
    """Build the host library from source into a fresh directory."""
    out = BUILD / "smoke_native"
    shutil.rmtree(out, ignore_errors=True)
    os.environ["TRICO_TPU_BUILD_DIR"] = str(out)
    from trico_tpu import native

    t0 = time.perf_counter()
    assert native.available(), "native build failed"
    so = sorted(out.glob("*.so"))
    say(f"  native library built from codec.cpp in {time.perf_counter() - t0:.1f} s: "
        f"{so[0].relative_to(REPO)}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cards", type=int, default=1,
                    help="with 4: run only the sharded 4-card path")
    args = ap.parse_args()
    sys.path.insert(0, str(REPO))
    BUILD.mkdir(exist_ok=True)
    from trico_tpu.compile_cache import enable_compile_cache

    enable_compile_cache()
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: no GPU — JAX's default device is {dev.platform!r}",
              file=sys.stderr)
        return 2
    say(f"[1] device: platform={dev.platform} kind={dev.device_kind} "
        f"count={len(jax.devices())}")
    say(card_line())

    if args.cards > 1:
        phases = [("build native", build_native),
                  (f"{args.cards} cards", lambda: phase_cards(args.cards))]
    else:
        phases = [("build native", build_native),
                  ("[2] programs at (10752, 4096)", lambda: phase_programs(dev)),
                  ("[3] Lucy-class mesh end to end", lambda: phase_lucy(dev)),
                  ("[4] f64 mesh + u64 indices", phase_f64),
                  ("[5] CLI", phase_cli),
                  ("[6] canary", phase_canary),
                  ("[7] gpu-marked tests", phase_tests)]
    failed = []
    for name, fn in phases:
        say(name)
        t0 = time.perf_counter()
        try:
            fn()
            say(f"  ok ({time.perf_counter() - t0:.1f} s)")
        except Exception:
            traceback.print_exc(file=sys.stdout)
            say(f"  FAILED ({time.perf_counter() - t0:.1f} s)")
            failed.append(name)
    if failed:
        say(json.dumps({"ok": False, "failed": failed}))
        return 1
    say(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
