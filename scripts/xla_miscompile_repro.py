"""Minimized repro for the XLA:TPU large-batch miscompile that forces
row-blocking in every v2 device program (fp_jax._row_block).

Symptom
-------
The fused v2 parse (tag-slice → per-value length cumsum → monotone log-shift
byte redistribution, fp_jax._parse_f32_chunks_v2_impl) silently drops
residual bytes once the per-program slot arrays reach ~32M entries:
decode(encode(x)) != x with NO error raised. Verified failing shapes on a
TPU v5e (jax 0.9.0): (C=8192, L=1024) and (C=2048, L=4096) — both
4L·C = 33.5M slots. (C=4096, L=1024) and every shape ≤ 16M slots round-trip
bit-exactly, CPU is exact at every size, and inserting
``jax.lax.optimization_barrier`` between the stages does NOT fix it (the
original bisection localized the first corruption to the parse's
byte-expansion network). chip_smoke.py reports whether the unblocked canary
shape is bit-exact on XLA:GPU.

Production mitigation
---------------------
``fp_jax._row_block`` runs every v2 entry point per row block under
``lax.map`` with a 2^21-value budget (8M slots — 4x margin below the
observed threshold), plus a canary that runs an exact failing shape
(C=8192, L=1024) through the blocked entry points (bench.py
"miscompile_canary", chip_smoke.py phase 6).

Usage
-----
    python scripts/xla_miscompile_repro.py [C] [L]

Defaults to the smallest known-failing shape. Prints the number of
mismatching values with row-blocking disabled vs enabled. On a fixed XLA
this prints 0 for both; on affected releases the first line is nonzero.
Report upstream with this script + the HLO dump:
    XLA_FLAGS=--xla_dump_to=/tmp/hlo python scripts/xla_miscompile_repro.py
"""

import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

C = int(sys.argv[1]) if len(sys.argv) > 1 else 8192
L = int(sys.argv[2]) if len(sys.argv) > 2 else 1024

import jax
import jax.numpy as jnp
import numpy as np


def run(block_values: int):
    os.environ["TRICO_TPU_V2_BLOCK_VALUES"] = str(block_values)
    # bisection deliberately crosses the verified budget; bypass the guard
    os.environ["TRICO_TPU_V2_UNSAFE"] = "1"
    # fresh import state for the env-dependent row budget
    for m in list(sys.modules):
        if m.startswith("trico_tpu"):
            del sys.modules[m]
    from trico_tpu.codec import fp_jax

    key = jax.random.PRNGKey(0)
    v = (jnp.cumsum(jax.random.normal(key, (C * L,), jnp.float32) * 1e-3)
         + jnp.sin(jnp.linspace(0.0, 3000.0, C * L)) * 10).astype(jnp.float32)
    x = jax.lax.bitcast_convert_type(v, jnp.uint32).reshape(C, L)
    p, s = fp_jax.encode_f32_chunks_v2(x, 4, 6)
    d = fp_jax.decode_f32_chunks_v2(p, L, 4, 6)
    return int(jnp.sum((d != x).astype(jnp.int32)))


if __name__ == "__main__":
    print(f"backend={jax.default_backend()} shape=({C}, {L}) "
          f"slots={4 * C * L / 1e6:.1f}M", flush=True)
    bad = run(block_values=1 << 62)  # one program, no row blocking
    print(f"unblocked: {bad} mismatching values "
          f"({'MISCOMPILE' if bad else 'ok'})", flush=True)
    good = run(block_values=1 << 21)  # production row-blocked
    print(f"row-blocked (production): {good} mismatching values "
          f"({'BROKEN' if good else 'ok'})", flush=True)
