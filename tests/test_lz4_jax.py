"""Device LZ4 match-finder tests: candidate quality, valid emission, ratio."""

import numpy as np
import pytest

from trico_tpu import native
from trico_tpu.codec import lz4_jax, lz4_ref

pytestmark = pytest.mark.skipif(not native.available(), reason="needs native emitter")


def _roundtrip_blocks(plane, block=4096):
    payloads = lz4_jax.compress_plane(plane, block=block)
    out = []
    n = len(plane)
    for i, payload in enumerate(payloads):
        size = min(block, n - i * block)
        out.append(native.lz4_decompress(payload, size))
    return np.concatenate(out) if out else np.zeros(0, np.uint8)


@pytest.mark.parametrize(
    "name,data",
    [
        ("zeros", np.zeros(20000, np.uint8)),
        ("text", np.frombuffer(b"the quick brown fox jumps over the lazy dog " * 500, np.uint8)),
        ("random", np.random.default_rng(0).integers(0, 256, 20000).astype(np.uint8)),
        ("indices", np.arange(3 * 20000, dtype=np.uint32).view(np.uint8)[1::4].copy()),
        ("short", np.arange(100, dtype=np.uint8)),
    ],
)
def test_roundtrip(name, data):
    out = _roundtrip_blocks(data)
    np.testing.assert_array_equal(out, data)


def test_jax_matches_numpy_oracle():
    r = np.random.default_rng(1)
    blocks = r.integers(0, 8, (3, 4096)).astype(np.uint8)
    import jax.numpy as jnp

    off_j, rle_j = lz4_jax.find_matches(jnp.asarray(blocks))
    off_n, rle_n = lz4_jax.find_matches_np(blocks)
    np.testing.assert_array_equal(np.asarray(rle_j), rle_n)
    np.testing.assert_array_equal(np.asarray(off_j), off_n)


def test_rle_plane_ratio():
    """Near-constant planes (triangle-index high bytes) must compress ~100x."""
    plane = np.zeros(64 * 4096, np.uint8)
    payloads = lz4_jax.compress_plane(plane)
    total = sum(len(p) for p in payloads)
    assert total < len(plane) / 100
    np.testing.assert_array_equal(_roundtrip_blocks(plane), plane)


def test_ratio_close_to_host_lz4():
    """Device-search + host-emit vs the host codec on the *same* 4KB blocks
    (isolates matcher quality from block-framing warm-up costs)."""
    idx = np.arange(3 * 69451, dtype=np.uint32)
    for p in range(4):
        plane = idx.view(np.uint8)[p::4].copy()
        dev = sum(len(x) for x in lz4_jax.compress_plane(plane))
        C = len(plane) // 4096
        host = sum(
            len(native.lz4_compress(plane[i * 4096 : (i + 1) * 4096]))
            for i in range(C)
        ) + len(native.lz4_compress(plane[C * 4096 :]))
        assert dev <= host * 1.10 + 64, (p, dev, host)


def test_reference_decodes_device_blocks():
    import ref_oracle

    if ref_oracle.get() is None:
        pytest.skip("reference unavailable")
    data = np.frombuffer(b"abcabcabc" * 2000, np.uint8)
    payloads = lz4_jax.compress_plane(data)
    n = len(data)
    out = b""
    for i, payload in enumerate(payloads):
        size = min(4096, n - i * 4096)
        out += ref_oracle.ref_lz4_decompress(payload, size)
    assert out == data.tobytes()
