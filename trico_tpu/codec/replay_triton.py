"""FCM/DFCM decode replay as one Pallas kernel through Triton (GPU).

Replay is sequential within a chunk: value i makes the hash keys for value
i+1, so it cannot be windowed or sorted like the encode predictor. The XLA
formulation (``fp_jax._replay_impl``) is a ``lax.scan`` over the L positions;
on a GPU that is a device while-loop with a few small launches per step,
whatever the chunk count. This kernel keeps the whole loop inside one launch.

Layout: each program owns a block of ``CB`` chunks and walks the transposed
(L, CB) xor/bcode rows, so every row load is one coalesced read. The two hash
tables live in registers as (2^e1, CB) and (2^e2, CB) tiles and are read and
written by one-hot compare/select (Triton tensors cannot be indexed by a
runtime value). Semantics are exactly ``fp_jax._replay_impl``'s (reference
decoder loop: floating_point_stream_compression.c:212-417).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

# Most chunks one program replays: 8 was fastest on the H100 at (10752, 4096)
# and (2048, 4096), against 2-64 (PERF.md). A step is latency-bound, so wider
# blocks only add table work per thread.
CHUNK_BLOCK = 8
# Programs wanted per launch: one per streaming multiprocessor of an H100.
MIN_PROGRAMS = 132
# Largest 2^e1 + 2^e2 the register tables take (the (4,10) adaptive
# candidate has 1040 rows); bigger tables replay through the XLA scan.
MAX_TABLE_ROWS = 1 << 11


def tables_fit(e1: int, e2: int) -> bool:
    """True when the (normalized) exponents' tables fit the kernel."""
    return (1 << e1) + (1 << e2) <= MAX_TABLE_ROWS


def chunk_block(C: int) -> int:
    """Chunks per program: ``CHUNK_BLOCK``, halved (down to 1) until the
    launch has ``MIN_PROGRAMS`` programs, so small batches still spread over
    the card."""
    cb = CHUNK_BLOCK
    while cb > 1 and -(-C // cb) < MIN_PROGRAMS:
        cb //= 2
    return cb


def num_warps_for(e1: int, e2: int) -> int:
    """Warps per program: one for small tables, four once the (T, CB) tiles
    would otherwise spill a single warp's registers."""
    return 1 if (1 << e1) + (1 << e2) <= 256 else 4


def _read(table, iota, h):
    """table[h] per lane: one-hot select + sum over the table axis."""
    return jnp.sum(jnp.where(iota == h[None, :], table, 0), axis=0,
                   dtype=jnp.uint32)


def _replay_kernel(e1, e2, L, x_ref, b_ref, o_ref):
    CB = x_ref.shape[1]
    T1, T2 = 1 << e1, 1 << e2
    m2 = np.uint32(T2 - 1)
    iota1 = jax.lax.broadcasted_iota(jnp.uint32, (T1, CB), 0)
    iota2 = jax.lax.broadcasted_iota(jnp.uint32, (T2, CB), 0)
    z = jnp.zeros((CB,), jnp.uint32)

    def body(i, carry):
        t1, t2, h1, h2, pred1, pred2, last, x, bc = carry
        # issue the next row's loads before this step's dependent chain, so
        # their latency overlaps it
        nxt = jnp.minimum(i + 1, L - 1)
        x_next, bc_next = x_ref[nxt, :], b_ref[nxt, :]
        v = x ^ jnp.where(bc > 4, last + pred2, pred1)
        o_ref[i, :] = v
        t1 = jnp.where(iota1 == h1[None, :], v[None, :], t1)
        h1n = v >> (32 - e1) if e1 else h1
        pred1 = _read(t1, iota1, h1n)
        stride = v - last
        t2 = jnp.where(iota2 == h2[None, :], stride[None, :], t2)
        h2n = ((h2 << (e2 // 2)) ^ (stride >> (32 - e2))) & m2 if e2 else h2
        pred2 = _read(t2, iota2, h2n)
        return t1, t2, h1n, h2n, pred1, pred2, v, x_next, bc_next

    carry0 = (jnp.zeros((T1, CB), jnp.uint32), jnp.zeros((T2, CB), jnp.uint32),
              z, z, z, z, z, x_ref[0, :], b_ref[0, :])
    jax.lax.fori_loop(0, L, body, carry0)


@functools.partial(jax.jit, static_argnums=(2, 3, 4, 5, 6))
def replay(bcodes: jax.Array, xors: jax.Array, e1: int, e2: int,
           interpret: bool = False, block: int | None = None,
           num_warps: int | None = None):
    """Decode replay: (C, L) (bcode, xor) → (C, L) uint32 values.

    ``e1``/``e2`` must be normalized (``fp_jax._norm_exponents``) and fit
    (:func:`tables_fit`). ``block`` chunks per program (default
    :func:`chunk_block`), ``num_warps`` per program (default
    :func:`num_warps_for`). Chunks are zero-padded up to a multiple of the
    block; zero rows replay to zeros and are sliced off."""
    C, L = xors.shape
    CB = block or chunk_block(C)
    Cp = -(-C // CB) * CB
    xT = jnp.pad(xors, ((0, Cp - C), (0, 0))).T
    bT = jnp.pad(bcodes.astype(jnp.uint32), ((0, Cp - C), (0, 0))).T
    spec = pl.BlockSpec((L, CB), lambda j: (0, j))
    outT = pl.pallas_call(
        functools.partial(_replay_kernel, e1, e2, L),
        grid=(Cp // CB,),
        in_specs=[spec, spec],
        out_specs=spec,
        out_shape=jax.ShapeDtypeStruct((L, Cp), jnp.uint32),
        backend="triton",
        compiler_params=plgpu.CompilerParams(
            num_warps=num_warps or num_warps_for(e1, e2), num_stages=1),
        interpret=interpret,
        name="fp32_replay",
    )(xT, bT)
    return outT.T[:C]
