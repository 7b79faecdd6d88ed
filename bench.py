#!/usr/bin/env python
"""trico-tpu benchmark: the f32 chunk-parallel codec on one GPU.

Prints ONE JSON line:
  {"metric": "fp32_encode_GBps_per_chip", "value": <GB/s>, "unit": "GB/s",
   "device": {"platform", "kind", "count", "card"}, "extra": {...}}

Every number is a wall-clock time around work that ends in
``block_until_ready``, on the device named in the line (``card`` is
``nvidia-smi``'s name and power limit). Without a GPU the bench fails: it
never reports host or CPU numbers. An inexact round-trip voids throughput.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))

CHUNK = 4096
E1, E2 = 4, 6  # production chunked-mode exponents (chunked.F32_TPU_EXP)


def grid_surface_mesh(n_verts: int, seed: int = 0, dtype=np.float32,
                      index_dtype=np.uint32):
    """Seeded Lucy-class scan surface: a side x side grid on a bumpy sphere
    patch (side = isqrt(n_verts)) and its two-triangles-per-cell
    triangulation. Returns (verts (side^2, 3), tris (2 (side-1)^2, 3))."""
    side = int(np.sqrt(n_verts))
    th = np.linspace(0.2, np.pi - 0.2, side, dtype=dtype)[:, None]
    ph = np.linspace(0.0, 1.7 * np.pi, side, dtype=dtype)[None, :]
    r = 10.0 + np.cumsum(np.random.default_rng(seed).normal(
        0, 1e-3, (side, side)).astype(dtype), axis=1)
    verts = np.stack([(r * np.sin(th) * np.cos(ph)).ravel(),
                      (r * np.sin(th) * np.sin(ph)).ravel(),
                      (r * np.cos(th) * np.ones_like(ph)).ravel()],
                     axis=1).astype(dtype)
    i, j = np.meshgrid(np.arange(side - 1, dtype=index_dtype),
                       np.arange(side - 1, dtype=index_dtype), indexing="ij")
    v00 = (i * side + j).ravel()
    v01, v10 = v00 + 1, v00 + side
    tris = np.concatenate([np.stack([v00, v10, v01], 1),
                           np.stack([v01, v10, v10 + 1], 1)])
    return verts, tris.astype(index_dtype)


def device_info() -> dict:
    """The device every result ran on; exits when JAX has no GPU."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py: needs a CUDA GPU; JAX's default device is "
                 f"{dev.platform!r}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip().splitlines()[0]
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices()), "card": card}


def _timed(fn, reps):
    """Seconds per call of ``fn`` (warm), over ``reps`` back-to-back calls."""
    import jax

    jax.block_until_ready(fn())
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps, out


def _device_stream(n, seed):
    import jax
    import jax.numpy as jnp

    step = jax.random.normal(jax.random.PRNGKey(seed), (n,), jnp.float32) * 1e-3
    v = (jnp.cumsum(step) + jnp.sin(jnp.linspace(0., 3000., n)) * 10)
    return jax.lax.bitcast_convert_type(v.astype(jnp.float32), jnp.uint32)


def kernel_cells(n_values: int) -> dict:
    """Device-resident encode/decode of one f32 stream (payloads stay in
    device memory), fixed (4,6) and adaptive exponents."""
    import jax.numpy as jnp

    from trico_tpu.codec import fp_jax

    C = n_values // CHUNK
    x = _device_stream(C * CHUNK, 0).reshape(C, CHUNK)
    raw = C * CHUNK * 4
    reps = max(3, int(1.5e9 // raw) + 1)
    enc_s, (pay, sizes) = _timed(
        lambda: fp_jax.encode_f32_chunks_v2(x, E1, E2), reps)
    dec_s, dec = _timed(
        lambda: fp_jax.decode_f32_chunks_v2(pay, CHUNK, E1, E2), reps)
    ada_s, (pay_a, sz_a) = _timed(
        lambda: fp_jax.encode_f32_chunks_v2_adaptive(x), reps)
    return {
        "n_values": C * CHUNK, "reps": reps,
        "encode_gbps": raw / 1e9 / enc_s, "decode_gbps": raw / 1e9 / dec_s,
        "adaptive_encode_gbps": raw / 1e9 / ada_s,
        "ratio": raw / int(jnp.sum(sizes)),
        "adaptive_ratio": raw / int(jnp.sum(sz_a)),
        "exact": bool(jnp.all(dec == x)),
    }


def canary() -> bool:
    """The row-block fence's canary shape (C, L) = (8192, 1024), through the
    blocked production entry points: encode -> decode must be bit-exact."""
    import jax.numpy as jnp

    from trico_tpu.codec import fp_jax

    xc = _device_stream(8192 * 1024, 7).reshape(8192, 1024)
    pc, _ = fp_jax.encode_f32_chunks_v2(xc, E1, E2)
    return bool(jnp.all(fp_jax.decode_f32_chunks_v2(pc, 1024, E1, E2) == xc))


def f64_cell(n64: int = 16 * 1024 * 1024) -> dict:
    import jax.numpy as jnp

    from trico_tpu.codec import fp64_jax

    rh = np.random.default_rng(3)
    w = (np.cumsum(rh.normal(0, 1e-3, n64))
         + np.sin(np.linspace(0., 3000., n64)) * 10).view(np.uint64)
    hi = jnp.asarray((w >> np.uint64(32)).astype(np.uint32).reshape(-1, CHUNK))
    lo = jnp.asarray((w & np.uint64(0xFFFFFFFF)).astype(np.uint32)
                     .reshape(-1, CHUNK))
    reps = max(2, int(1.5e9 // (n64 * 8)) + 1)
    enc_s, (p64, s64) = _timed(
        lambda: fp64_jax.encode_f64_chunks_v2(hi, lo, E1, E2), reps)
    dec_s, (dh, dl) = _timed(
        lambda: fp64_jax.decode_f64_chunks_v2(p64, CHUNK, E1, E2), reps)
    return {"n_values": n64, "exponents": [E1, E2], "reps": reps,
            "encode_gbps": n64 * 8 / 1e9 / enc_s,
            "decode_gbps": n64 * 8 / 1e9 / dec_s,
            "ratio": n64 * 8 / int(jnp.sum(s64)),
            "exact": bool(jnp.all(dh == hi) & jnp.all(dl == lo))}


def fullmesh_archive(n_verts: int = 14_000_000) -> dict:
    """The product path end to end: host arrays -> compress_mesh -> archive
    bytes -> decompress_mesh -> host arrays, on a one-GPU mesh, warm."""
    import jax

    from trico_tpu.parallel import mesh_codec
    from trico_tpu.profiling import StageTimer

    verts, tris = grid_surface_mesh(n_verts)
    raw = verts.nbytes + tris.nbytes
    mesh = mesh_codec.make_mesh(1)
    blob = mesh_codec.compress_mesh(verts, tris, mesh=mesh)  # compiles
    mesh_codec.decompress_mesh(blob, mesh)
    prof = StageTimer()
    t0 = time.perf_counter()
    blob = mesh_codec.compress_mesh(verts, tris, mesh=mesh, profile=prof)
    enc_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = mesh_codec.decompress_mesh(blob, mesh)
    dec_s = time.perf_counter() - t0
    exact = bool(np.array_equal(out["vertices"].view(np.uint32),
                                verts.view(np.uint32))
                 and np.array_equal(out["triangles"], tris))
    return {"n_vertices": len(verts), "n_triangles": len(tris),
            "raw_bytes": raw, "archive_bytes": len(blob),
            "ratio": raw / len(blob), "encode_wall_s": enc_s,
            "decode_wall_s": dec_s, "encode_gbps": raw / 1e9 / enc_s,
            "decode_gbps": raw / 1e9 / dec_s,
            "stage_seconds": {k: s.seconds for k, s in prof.stages.items()},
            "peak_bytes_in_use":
                jax.devices()[0].memory_stats()["peak_bytes_in_use"],
            "exact": exact}


def main():
    from trico_tpu.compile_cache import enable_compile_cache

    enable_compile_cache()
    device = device_info()
    headline = kernel_cells(8 * 1024 * 1024)
    extra = {
        "headline_8M": headline,
        "lucy42M": kernel_cells(10752 * CHUNK),
        "miscompile_canary": canary(),
        "f64": f64_cell(),
        "fullmesh_archive": fullmesh_archive(),
    }
    exact = all(c.get("exact", True) for c in extra.values()
                if isinstance(c, dict)) and extra["miscompile_canary"]
    value = headline["encode_gbps"]
    if not exact:
        value = 0.0
        print("BENCH FAILURE: round-trip not bit-exact; throughput voided",
              file=sys.stderr)
    print(json.dumps({"metric": "fp32_encode_GBps_per_chip", "value": value,
                      "unit": "GB/s", "exact": exact, "device": device,
                      "extra": extra}))
    return 0 if exact else 1


if __name__ == "__main__":
    sys.exit(main())
