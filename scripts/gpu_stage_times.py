#!/usr/bin/env python
"""Stage times of the f32 device codec on one GPU.

Times, at the bench shapes (C, L) = (2048, 4096) and (10752, 4096) u32
(10752 x 4096 = 44M values, a Lucy-class vertex stream):

1. decode replay: the Pallas-Triton kernel (``codec/replay_triton.py``) at
   several block widths and warp counts, against
   the XLA ``lax.scan`` (``fp_jax._replay_scan``) at unroll 1 and 8 — wall
   time of the call, median of repeats, each checked bit-exact; also at
   C = 512, the chunk count one row block of the decode hands the kernel;
2. the whole v2 decode (``decode_f32_chunks_v2``) with the kernel route and
   with the XLA route;
3. device time of each XLA stage (sort predictor, pack, parse, fixed and
   adaptive encode, decode) from a profiler trace: the union of the kernel
   events on the GPU's stream lines.

With ``--mesh``, instead: the Lucy-class mesh (``bench.grid_surface_mesh``,
14M vertices + 28M triangles) through ``compress_mesh`` / ``decompress_mesh``
warm, decode with the kernel route and with the XLA route in turns (kernel,
XLA, XLA, kernel), the host stage split, and the device busy share of one
warm encode and decode from a trace.

Prints one line per measurement, then a JSON summary line. Needs a GPU:
exits non-zero without one. Usage: ``python scripts/gpu_stage_times.py
[--quick | --mesh]`` (``--quick``: the 10752-row shape, replay and decode
only).
"""

from __future__ import annotations

import argparse
import functools
import glob
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


def _median_wall(fn, reps):
    import jax

    out = fn()
    jax.block_until_ready(out)
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    ts.sort()
    return ts[len(ts) // 2], out


def device_seconds(fn, reps=3):
    """Device busy time per call of ``fn`` from a profiler trace: the union
    of kernel intervals on the GPU plane's stream lines, over ``reps``."""
    import jax
    from jax.profiler import ProfileData

    jax.block_until_ready(fn())
    with tempfile.TemporaryDirectory(dir=REPO / "build") as d:
        jax.profiler.start_trace(d)
        for _ in range(reps):
            jax.block_until_ready(fn())
        jax.profiler.stop_trace()
        pd = ProfileData.from_file(
            glob.glob(f"{d}/plugins/profile/*/*.xplane.pb")[0])
        spans, names = [], {}
        for plane in pd.planes:
            if not plane.name.startswith("/device:GPU"):
                continue
            for line in plane.lines:
                if "Stream" not in line.name:
                    continue
                for e in line.events:
                    spans.append((e.start_ns, e.start_ns + e.duration_ns))
                    names[e.name] = names.get(e.name, 0) + e.duration_ns
    spans.sort()
    busy, end = 0, -1
    for a, b in spans:
        if a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    top = sorted(names.items(), key=lambda kv: -kv[1])[:4]
    return busy / reps / 1e9, [(n[:48], round(t / reps / 1e6, 3)) for n, t in top]


def mesh_run(results):
    """Lucy-class compress_mesh / decompress_mesh, kernel vs XLA replay."""
    import jax
    import numpy as np

    from bench import grid_surface_mesh
    from trico_tpu.codec import fp_jax
    from trico_tpu.parallel import mesh_codec
    from trico_tpu.profiling import StageTimer

    verts, tris = grid_surface_mesh(14_000_000)
    raw = verts.nbytes + tris.nbytes
    mesh = mesh_codec.make_mesh(1)
    enc = lambda: mesh_codec.compress_mesh(verts, tris, mesh=mesh)
    blob = enc()
    enc_s, blob = _median_wall(enc, 3)
    prof = StageTimer()
    mesh_codec.compress_mesh(verts, tris, mesh=mesh, profile=prof)
    stages = {k: round(v.seconds, 4) for k, v in prof.stages.items()}
    print(f"mesh encode wall_s={enc_s:.4f} raw={raw} archive={len(blob)} "
          f"stages={stages}", flush=True)
    results["mesh_encode_s"] = enc_s
    real_route = fp_jax.kernel_route
    for route in ("triton", "xla", "xla", "triton"):
        fp_jax.kernel_route = (lambda r: lambda platform=None: r)(route)
        jax.clear_caches()
        mesh_codec.decompress_mesh(blob, mesh)  # compile
        t, out = _median_wall(lambda: mesh_codec.decompress_mesh(blob, mesh), 3)
        ok = (np.array_equal(out["vertices"].view(np.uint32),
                             verts.view(np.uint32))
              and np.array_equal(out["triangles"], tris))
        print(f"mesh decode route={route} wall_s={t:.4f} exact={ok}", flush=True)
        results.setdefault(f"mesh_decode_{route}_s", []).append(t)
    fp_jax.kernel_route = real_route
    jax.clear_caches()
    mesh_codec.decompress_mesh(blob, mesh)
    dec_s = min(results["mesh_decode_triton_s"])
    for name, fn, wall in (
            ("encode", enc, enc_s),
            ("decode", lambda: mesh_codec.decompress_mesh(blob, mesh), dec_s)):
        busy, top = device_seconds(fn, reps=1)
        print(f"mesh {name} traced: device busy {busy:.4f} s of {wall:.4f} s "
              f"untraced warm wall (idle share {1 - busy / wall:.3f}); "
              f"top={top}", flush=True)
        results[f"mesh_{name}_device_busy_s"] = busy


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--mesh", action="store_true")
    args = ap.parse_args()

    os.makedirs(REPO / "build", exist_ok=True)
    from trico_tpu.compile_cache import enable_compile_cache

    enable_compile_cache()
    import jax
    import jax.numpy as jnp

    from trico_tpu.codec import fp_jax, replay_triton

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"gpu_stage_times: needs a CUDA GPU, JAX found {dev.platform!r}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    print(f"device platform={dev.platform} kind={dev.device_kind} "
          f"count={len(jax.devices())} card={card}", flush=True)
    results = {"card": card, "kind": dev.device_kind}
    if args.mesh:
        mesh_run(results)
        print(json.dumps(results))
        return
    L = 4096
    shapes = [10752] if args.quick else [10752, 2048]
    exps = [(4, 6), (4, 10)]

    def data(C, seed):
        k = jax.random.PRNGKey(seed)
        v = (jnp.cumsum(jax.random.normal(k, (C * L,), jnp.float32) * 1e-3)
             + jnp.sin(jnp.linspace(0., 3000., C * L)) * 10)
        return jax.lax.bitcast_convert_type(v, jnp.uint32).reshape(C, L)

    for C in shapes:
        x = data(C, C)
        for e1, e2 in exps:
            tag = f"C{C}_e{e1}_{e2}"
            pay, _ = fp_jax.encode_f32_chunks_v2(x, e1, e2)
            bc, xors = fp_jax.parse_f32_chunks_v2(pay, L, e1, e2)
            jax.block_until_ready((bc, xors))
            reps = 5
            grid = ([(2, 1), (4, 1), (8, 1), (16, 1)] if e2 <= 6
                    else [(4, 4), (8, 4), (8, 2)])
            variants = [("kernel_default", None, None)]
            variants += [(f"kernel_b{b}_w{w}", b, w) for b, w in grid]
            for rows in (C, 512):
                for name, block, warps in variants:
                    fn = functools.partial(
                        replay_triton.replay, bc[:rows], xors[:rows], e1, e2,
                        False, block, warps)
                    try:
                        t, out = _median_wall(fn, reps)
                        ok = bool(jnp.all(out == x[:rows]))
                        print(f"replay {tag} rows={rows} {name} wall_s={t:.6f} "
                              f"exact={ok}", flush=True)
                        results[f"replay_{tag}_r{rows}_{name}"] = [t, ok]
                    except Exception as e:  # report and keep measuring
                        print(f"replay {tag} rows={rows} {name} FAILED "
                              f"{type(e).__name__}: {str(e)[:300]}", flush=True)
            for unroll in ((8,) if args.quick else (1, 8)):
                fp_jax._SCAN_UNROLL = unroll
                scan = jax.jit(functools.partial(
                    fp_jax._replay_scan, e1=e1, e2=e2))
                t, out = _median_wall(lambda: scan(bc, xors), 3)
                ok = bool(jnp.all(out == x))
                print(f"replay {tag} xla_scan_unroll{unroll} wall_s={t:.6f} "
                      f"exact={ok}", flush=True)
                results[f"replay_{tag}_scan_u{unroll}"] = [t, ok]
            fp_jax._SCAN_UNROLL = 8
            # whole v2 decode, kernel route vs XLA route
            for route in (("triton",) if args.quick else ("triton", "xla")):
                fp_jax.kernel_route = (lambda r: lambda platform=None: r)(route)
                jax.clear_caches()
                t, out = _median_wall(
                    lambda: fp_jax.decode_f32_chunks_v2(pay, L, e1, e2), 3)
                ok = bool(jnp.all(out == x))
                print(f"decode_v2 {tag} route={route} wall_s={t:.6f} "
                      f"exact={ok}", flush=True)
                results[f"decode_{tag}_{route}"] = [t, ok]
            fp_jax.kernel_route = lambda platform=None: "triton"
            jax.clear_caches()
        if args.quick:
            continue
        # device time of the XLA stages at this shape, (4,6)
        e1, e2 = 4, 6
        bcode, res = fp_jax.predict_f32_chunks(x, e1, e2)
        pay, _ = fp_jax.encode_f32_chunks_v2(x, e1, e2)
        predict_sort = jax.jit(fp_jax._predict_sort, static_argnums=(1, 2))
        stages = {
            "predict_sort": lambda: predict_sort(x, e1, e2),
            "pack_v2": lambda: fp_jax.pack_f32_chunks_v2(bcode, res, e1, e2),
            "parse_v2": lambda: fp_jax.parse_f32_chunks_v2(pay, L, e1, e2),
            "encode_v2_fixed": lambda: fp_jax.encode_f32_chunks_v2(x, e1, e2),
            "encode_v2_adaptive":
                lambda: fp_jax.encode_f32_chunks_v2_adaptive(x),
            "decode_v2": lambda: fp_jax.decode_f32_chunks_v2(pay, L, e1, e2),
        }
        for name, fn in stages.items():
            try:
                t, top = device_seconds(fn)
                print(f"trace C{C} {name} device_s={t:.6f} "
                      f"GBps={C * L * 4 / t / 1e9:.3f} top={top}", flush=True)
                results[f"trace_C{C}_{name}"] = t
            except Exception as e:
                print(f"trace C{C} {name} FAILED {type(e).__name__}: "
                      f"{str(e)[:300]}", flush=True)
    print(json.dumps(results))


if __name__ == "__main__":
    main()
