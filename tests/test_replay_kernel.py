"""The Pallas-Triton decode replay kernel (codec/replay_triton.py) in
interpret mode, against the XLA scan (`fp_jax._replay_scan`) and the NumPy
oracle (`fp_ref`), plus the wrapper's block choice, padding and table bound.

Reference semantics: the FCM/DFCM decoder loop of
floating_point_stream_compression.c:212-417, per chunk with fresh tables.
The compiled kernel itself runs only on the card (tests/test_gpu.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from trico_tpu.codec import fp_jax, fp_ref, replay_triton

from conftest import mesh_like_floats

EXPONENTS = [(0, 6), (4, 6), (4, 10)]


def _chunks(n_chunks, L, seed=0):
    vals = mesh_like_floats(n_chunks * L, seed=seed).view(np.uint32)
    return vals.reshape(n_chunks, L)


def _encoded(chunks, e1, e2):
    bc, res = fp_jax._predict_scan(jnp.asarray(chunks), e1, e2)
    return bc, res


@pytest.mark.parametrize("C", [1, 8, 25])
@pytest.mark.parametrize("e1,e2", EXPONENTS)
def test_replay_interpret_roundtrip(e1, e2, C):
    """Kernel replay (block of 8 chunks: C below, at and past one block,
    with padding) reproduces the input and agrees with the XLA scan."""
    L = 64
    chunks = _chunks(C, L, seed=C + e2)
    bc, res = _encoded(chunks, e1, e2)
    got = replay_triton.replay(bc, res, e1, e2, True, 8)
    assert got.shape == (C, L)
    np.testing.assert_array_equal(np.asarray(got), chunks)
    want = fp_jax._replay_scan(bc, res, e1, e2)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("e1,e2", EXPONENTS)
def test_replay_interpret_oracle_payloads(e1, e2):
    """Oracle-encoded payloads → v2 parse → kernel replay (default block)."""
    C, L = 5, 128
    chunks = _chunks(C, L, seed=31)
    B = fp_jax.f32_max_chunk_bytes(L)
    mat = np.zeros((C, B), np.uint8)
    for c in range(C):
        p = fp_jax.relayout_f32_v1_to_v2(
            np.frombuffer(fp_ref.compress(chunks[c], e1, e2), np.uint8))
        mat[c, : len(p)] = p
    bc, xors = fp_jax.parse_f32_chunks_v2(jnp.asarray(mat), L, e1, e2)
    got = replay_triton.replay(bc, xors, e1, e2, True)
    np.testing.assert_array_equal(np.asarray(got), chunks)


@pytest.mark.parametrize("e1,e2", EXPONENTS)
def test_replay_interpret_random_bits(e1, e2):
    """A random walk with steps of random bit width hits many bcodes, incl.
    the DFCM branches."""
    rng = np.random.default_rng(e1 * 100 + e2)
    steps = rng.integers(0, 2**32, (4, 64)) >> rng.integers(0, 32, (4, 64))
    chunks = np.cumsum(steps, axis=1).astype(np.uint32)
    bc, res = _encoded(chunks, e1, e2)
    assert len(np.unique(np.asarray(bc))) >= 3
    got = replay_triton.replay(bc, res, e1, e2, True, 2)
    np.testing.assert_array_equal(np.asarray(got), chunks)


def test_predict_replay_interpret_composite():
    """Full composite at the production chunked exponents: sort predictor →
    v2 pack → v2 parse → kernel replay."""
    e1, e2 = 4, 6
    C, L = 3, 512
    chunks = _chunks(C, L, seed=11)
    bcode, res = fp_jax.predict_f32_chunks(jnp.asarray(chunks), e1, e2)
    payloads, sizes = fp_jax.pack_f32_chunks_v2(bcode, res, e1, e2)
    bc2, xors2 = fp_jax.parse_f32_chunks_v2(payloads, L, e1, e2)
    vals = replay_triton.replay(bc2, xors2, e1, e2, True, 4)
    np.testing.assert_array_equal(np.asarray(vals), chunks)


@pytest.mark.parametrize("C,want", [
    (10752, 8),        # 44M-value Lucy-class plane: 1344 programs
    (512, 2),          # one 2^21-value row block of L=4096: 256 programs
    (1, 1),
    (132 * 8, 8),
    (131 * 8, 4),
    (131, 1),
])
def test_chunk_block(C, want):
    """The block shrinks until the launch has MIN_PROGRAMS programs."""
    cb = replay_triton.chunk_block(C)
    assert cb == want
    assert -(-C // cb) >= replay_triton.MIN_PROGRAMS or cb == 1


@pytest.mark.parametrize("e1,e2,fits", [
    (0, 6, True), (4, 6, True), (4, 10, True),
    (10, 10, True), (4, 12, False), (14, 18, False),
])
def test_tables_fit(e1, e2, fits):
    assert replay_triton.tables_fit(e1, e2) is fits


@pytest.mark.parametrize("e1,e2,warps", [(0, 6, 1), (4, 6, 1), (4, 10, 4)])
def test_num_warps_for(e1, e2, warps):
    """One warp for small tables; four once 1040-row tiles would spill one
    warp's registers (measured on the H100, PERF.md)."""
    assert replay_triton.num_warps_for(e1, e2) == warps
