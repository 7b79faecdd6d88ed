"""f64 device chunk codec tests (hi/lo uint32-pair arithmetic vs the oracle)."""

import numpy as np
import pytest

from trico_tpu import native
from trico_tpu.codec import fp64_jax, fp_ref
from conftest import mesh_like_floats

pytestmark = pytest.mark.skipif(not native.available(), reason="needs native packer")


@pytest.mark.parametrize("L", [2, 64, 256])
@pytest.mark.parametrize("e", [(20, 20), (4, 10), (2, 6)])
def test_f64_chunks_match_oracle(L, e):
    C = 5
    vals = mesh_like_floats(C * L, seed=L, dtype=np.float64).view(np.uint64)
    out, sizes, tail = fp64_jax.encode_f64(vals, L, *e)
    assert len(tail) == 0
    for c in range(C):
        expect = fp_ref.compress(vals[c * L : (c + 1) * L], *e)
        got = out[c, : sizes[c]].tobytes()
        assert got == expect, f"chunk {c} differs"


def test_f64_random_bits():
    r = np.random.default_rng(0)
    vals = r.integers(0, 2**64, 8 * 128, dtype=np.uint64)
    out, sizes, _ = fp64_jax.encode_f64(vals, 128)
    for c in range(8):
        expect = fp_ref.compress(vals[c * 128 : (c + 1) * 128], 20, 20)
        assert out[c, : sizes[c]].tobytes() == expect


@pytest.mark.parametrize("L", [2, 64, 250])
def test_f64_decode_roundtrip(L):
    C = 4
    vals = mesh_like_floats(C * L, seed=L + 7, dtype=np.float64).view(np.uint64)
    out, sizes, _ = fp64_jax.encode_f64(vals, L)
    dec = fp64_jax.decode_f64(out, L)
    np.testing.assert_array_equal(dec, vals[: len(dec)])


def test_f64_chunked_container_tpu_path():
    from trico_tpu import chunked

    vals = mesh_like_floats(5000, seed=3, dtype=np.float64).view(np.uint64)
    a = chunked.encode_chunked(vals, chunk_len=512, use_tpu=True)
    b = chunked.encode_chunked(vals, chunk_len=512, use_tpu=False)
    assert a == b
    out, bits = chunked.decode_chunked(a)
    assert bits == 64
    np.testing.assert_array_equal(out, vals)


# ---------------------------------------------------------------------------
# f64 v2 "tpu layout"
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("L", [2, 64, 256])
@pytest.mark.parametrize("e", [(20, 20), (4, 10)])
def test_f64_v2_payload_is_relayout_of_reference(L, e):
    C = 4
    vals = mesh_like_floats(C * L, seed=L + 5, dtype=np.float64).view(np.uint64)
    out1, sz1, _ = fp64_jax.encode_f64(vals, L, *e)  # ref layout (native pack)
    out2, sz2, _ = fp64_jax.encode_f64(vals, L, *e, layout="tpu")
    np.testing.assert_array_equal(sz1, sz2)
    for c in range(C):
        p1 = out1[c, : sz1[c]]
        p2 = out2[c, : sz2[c]]
        np.testing.assert_array_equal(fp64_jax.relayout_f64_v1_to_v2(p1), p2)
        np.testing.assert_array_equal(fp64_jax.relayout_f64_v2_to_v1(p2), p1)


@pytest.mark.parametrize("L", [2, 64, 256])
def test_f64_v2_device_decode_roundtrip(L):
    C = 4
    vals = mesh_like_floats(C * L, seed=L + 6, dtype=np.float64).view(np.uint64)
    out, sizes, _ = fp64_jax.encode_f64(vals, L, 20, 20, layout="tpu")
    dec = fp64_jax.decode_f64(out, L, 20, 20, layout="tpu")
    np.testing.assert_array_equal(dec, vals)


def test_f64_v2_random_bits_roundtrip():
    r = np.random.default_rng(5)
    vals = r.integers(0, 2**63, 6 * 128, dtype=np.int64).astype(np.uint64)
    vals |= r.integers(0, 2, 6 * 128, dtype=np.uint64) << np.uint64(63)
    out, sizes, _ = fp64_jax.encode_f64(vals, 128, layout="tpu")
    dec = fp64_jax.decode_f64(out, 128, layout="tpu")
    np.testing.assert_array_equal(dec, vals)


def test_f64_tpu_layout_container_roundtrip():
    from trico_tpu import chunked

    vals = mesh_like_floats(1024 + 33, seed=13, dtype=np.float64).view(np.uint64)
    a = chunked.encode_chunked(vals, chunk_len=256, use_tpu=True, layout="tpu")
    b = chunked.encode_chunked(vals, chunk_len=256, use_tpu=False, layout="tpu")
    assert a == b
    for use_tpu in (True, False):
        out, bits = chunked.decode_chunked(a, use_tpu=use_tpu)
        assert bits == 64
        np.testing.assert_array_equal(out, vals)


def test_f64_adaptive_chunked_roundtrip_and_smaller():
    """Per-chunk adaptive f64 exponents (device argmin over
    F64_TPU_CANDIDATES): the container decodes exactly on every path, is
    never larger than any single fixed candidate, and ties pick the
    VMEM-viable pair so those chunks replay on device
    (VERDICT r3 missing #3)."""
    from trico_tpu import chunked
    from trico_tpu.codec.fp64_jax import F64_TPU_CANDIDATES

    vals = mesh_like_floats(8 * 512 + 100, seed=33, dtype=np.float64).view(np.uint64)
    a = chunked.encode_chunked(vals, chunk_len=512, use_tpu=True,
                               layout="tpu", optimize=True)
    for use_tpu in (True, False):
        out, bits = chunked.decode_chunked(a, use_tpu=use_tpu)
        assert bits == 64
        np.testing.assert_array_equal(out, vals)
    for e1, e2 in F64_TPU_CANDIDATES:
        fixed = chunked.encode_chunked(vals, chunk_len=512, e1=e1, e2=e2,
                                       layout="tpu")
        assert len(a) <= len(fixed)


def test_f64_adaptive_chunks_are_reference_substreams():
    """Every chunk of an adaptive f64 container (after v2→v1 relayout) is a
    standard self-describing reference f64 substream decodable by the scalar
    oracle (fps.c:803-1164 semantics)."""
    import struct as _struct

    from trico_tpu import chunked
    from trico_tpu.codec import fp64_jax, fp_ref

    vals = mesh_like_floats(4 * 256, seed=34, dtype=np.float64).view(np.uint64)
    blob = chunked.encode_chunked(vals, chunk_len=256, use_tpu=True,
                                  layout="tpu", optimize=True)
    ver, flags, chunk_len, total, n_chunks = _struct.unpack_from("<BBIII", blob, 0)
    sizes = _struct.unpack_from(f"<{n_chunks}I", blob, 14)
    off = 14 + 4 * n_chunks
    for c in range(n_chunks):
        payload = np.frombuffer(blob, np.uint8)[off : off + sizes[c]]
        off += sizes[c]
        ref = fp64_jax.relayout_f64_v2_to_v1(payload)
        got = fp_ref.decompress_f64(ref.tobytes())
        np.testing.assert_array_equal(
            got, vals[c * chunk_len : c * chunk_len + len(got)])


def test_f64_sharded_plane_decode_mixed_groups():
    """decode_plane_sharded handles an adaptive f64 container whose chunks
    mix VMEM-viable (device) and (20,20) (host-threaded) groups."""
    import jax

    from trico_tpu import chunked
    from trico_tpu.parallel import mesh_codec

    mesh = mesh_codec.make_mesh(min(4, len(jax.devices())))
    vals = mesh_like_floats(6 * 512 + 64, seed=35, dtype=np.float64).view(np.uint64)
    blob = chunked.encode_chunked(vals, chunk_len=512, use_tpu=True,
                                  layout="tpu", optimize=True)
    out = mesh_codec.decode_plane_sharded(blob, mesh)
    assert out.dtype == np.uint64
    np.testing.assert_array_equal(out, vals)
