"""Chunk-parallel FP device codec tests (run on CPU backend via conftest).

Each chunk payload must be bit-identical to the scalar oracle encoding of that
chunk — chunking is a framing concept, not a format change. Both packing paths
(native host packer and all-device sort compaction) and both decode paths
(native parse + device replay, all-device) are covered.
"""

import numpy as np
import pytest

from trico_tpu import native
import jax.numpy as jnp
from trico_tpu.codec import fp_jax, fp_ref
from conftest import mesh_like_floats


@pytest.mark.parametrize("L", [8, 64, 256])
@pytest.mark.parametrize("e", [(4, 10), (2, 6), (4, 8)])
def test_chunk_payloads_match_oracle(L, e):
    C = 7
    vals = mesh_like_floats(C * L, seed=L).view(np.uint32)
    out, sizes, tail = fp_jax.encode_f32(vals, L, *e)
    assert len(tail) == 0
    for c in range(C):
        expect = fp_ref.compress(vals[c * L : (c + 1) * L], *e)
        got = out[c, : sizes[c]].tobytes()
        assert got == expect, f"chunk {c} differs"


@pytest.mark.parametrize("e", [(4, 10), (4, 8)])
def test_device_pack_matches_native_pack(e):
    L, C = 64, 9
    vals = mesh_like_floats(C * L, seed=1).view(np.uint32)
    out_host, sizes_host, _ = fp_jax.encode_f32(vals, L, *e, device_pack=False)
    out_dev, sizes_dev, _ = fp_jax.encode_f32(vals, L, *e, device_pack=True)
    np.testing.assert_array_equal(sizes_host, sizes_dev)
    np.testing.assert_array_equal(out_host, out_dev)


def test_random_bits_chunks():
    r = np.random.default_rng(0)
    vals = r.integers(0, 2**32, 16 * 128, dtype=np.uint32)
    out, sizes, _ = fp_jax.encode_f32(vals, 128)
    for c in range(16):
        expect = fp_ref.compress(vals[c * 128 : (c + 1) * 128], 4, 10)
        assert out[c, : sizes[c]].tobytes() == expect


@pytest.mark.parametrize("L", [8, 64, 256])
@pytest.mark.parametrize("device_parse", [False, True])
def test_decode_roundtrip(L, device_parse):
    C = 5
    vals = mesh_like_floats(C * L, seed=L + 1).view(np.uint32)
    out, sizes, _ = fp_jax.encode_f32(vals, L)
    dec = fp_jax.decode_f32(out, L, device_parse=device_parse)
    np.testing.assert_array_equal(dec, vals)


def test_decode_oracle_encoded_chunks():
    """Decoder must accept chunks produced by the scalar oracle (format parity)."""
    L, C = 64, 4
    vals = mesh_like_floats(C * L, seed=9).view(np.uint32)
    B = fp_jax.f32_max_chunk_bytes(L)
    payloads = np.zeros((C, B), np.uint8)
    for c in range(C):
        blob = np.frombuffer(fp_ref.compress(vals[c * L : (c + 1) * L], 4, 10), np.uint8)
        payloads[c, : len(blob)] = blob
    for device_parse in (False, True):
        dec = fp_jax.decode_f32(payloads, L, device_parse=device_parse)
        np.testing.assert_array_equal(dec, vals)


def test_tail_returned():
    vals = mesh_like_floats(1000, seed=3).view(np.uint32)
    out, sizes, tail = fp_jax.encode_f32(vals, 256)
    assert out.shape[0] == 3
    np.testing.assert_array_equal(tail, vals[768:])


# ---------------------------------------------------------------------------
# v2 "tpu layout" (tags front-loaded, gather-free device decode)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("L", [8, 64, 256])
@pytest.mark.parametrize("e", [(4, 10), (4, 8)])
def test_v2_payload_is_relayout_of_reference(L, e):
    """v2 bytes == pure permutation of the reference payload (same size)."""
    C = 6
    vals = mesh_like_floats(C * L, seed=L + 3).view(np.uint32)
    out1, sz1, _ = fp_jax.encode_f32(vals, L, *e, device_pack=True)
    out2, sz2, _ = fp_jax.encode_f32(vals, L, *e, layout="tpu")
    np.testing.assert_array_equal(sz1, sz2)
    for c in range(C):
        p1 = out1[c, : sz1[c]]
        p2 = out2[c, : sz2[c]]
        np.testing.assert_array_equal(fp_jax.relayout_f32_v1_to_v2(p1), p2)
        np.testing.assert_array_equal(fp_jax.relayout_f32_v2_to_v1(p2), p1)


@pytest.mark.parametrize("L", [8, 64, 256])
def test_v2_device_decode_roundtrip(L):
    C = 5
    vals = mesh_like_floats(C * L, seed=L + 9).view(np.uint32)
    out, sizes, _ = fp_jax.encode_f32(vals, L, 4, 8, layout="tpu")
    dec = fp_jax.decode_f32(out, L, 4, 8, layout="tpu")
    np.testing.assert_array_equal(dec, vals)


def test_v2_random_bits_roundtrip():
    r = np.random.default_rng(3)
    vals = r.integers(0, 2**32, 9 * 128, dtype=np.uint32)
    out, sizes, _ = fp_jax.encode_f32(vals, 128, layout="tpu")
    dec = fp_jax.decode_f32(out, 128, layout="tpu")
    np.testing.assert_array_equal(dec, vals)


# ---------------------------------------------------------------------------
# monotone log-shift network stress tests (the primitive everything rests on)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("S", [16, 128, 1024])
def test_logshift_compact_expand_random(S, seed):
    """Compaction then expansion over random monotone partial permutations
    must be lossless for every live element (adversarial: random validity,
    random payloads, including all-dead and all-live rows)."""
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    C = 6
    valid = rng.random((C, S)) < rng.random((C, 1))  # varied density per row
    valid[0] = False  # all dead
    valid[1] = True  # all live
    payload = rng.integers(0, 256, (C, S), dtype=np.uint32)
    # dest of live element at p = number of live elements before p
    dest = np.cumsum(valid, axis=1) - valid
    move = np.where(valid, np.arange(S)[None, :] - dest, 0)

    compacted = np.asarray(
        fp_jax._compact_monotone(
            jnp.asarray(payload), jnp.asarray(move), jnp.asarray(valid), 8
        )
    )
    for c in range(C):
        live = payload[c][valid[c]]
        np.testing.assert_array_equal(compacted[c, : len(live)], live)

    # expansion: move compacted elements back out to their original slots
    n_live = valid.sum(axis=1)
    ranks = np.arange(S)[None, :]
    rvalid = ranks < n_live[:, None]
    # slot of rank r = index of r-th live slot
    slot_by_rank = np.full((C, S), 0, np.int64)
    for c in range(C):
        idx = np.flatnonzero(valid[c])
        slot_by_rank[c, : len(idx)] = idx
    expanded = np.asarray(
        fp_jax._expand_monotone(
            jnp.asarray(compacted),
            jnp.asarray(slot_by_rank - ranks),
            jnp.asarray(rvalid),
            8,
        )
    )
    for c in range(C):
        np.testing.assert_array_equal(expanded[c][valid[c]], payload[c][valid[c]])


def test_logshift_max_displacement():
    """Single live element moving the full width (worst-case shift S-1)."""
    import jax.numpy as jnp

    S = 256
    payload = np.zeros((1, S), np.uint32)
    payload[0, S - 1] = 0xAB
    valid = np.zeros((1, S), bool)
    valid[0, S - 1] = True
    move = np.where(valid, S - 1, 0)
    out = np.asarray(
        fp_jax._compact_monotone(
            jnp.asarray(payload), jnp.asarray(move), jnp.asarray(valid), 8
        )
    )
    assert out[0, 0] == 0xAB
    back = np.asarray(
        fp_jax._expand_monotone(
            jnp.asarray(out),
            jnp.asarray(move[:, ::-1] * 0 + np.where(np.arange(S) == 0, S - 1, 0)[None, :]),
            jnp.asarray(np.arange(S)[None, :] == 0),
            8,
        )
    )
    assert back[0, S - 1] == 0xAB


class TestSortPredictor:
    """Closed-form sort-based predictor (fp_jax._predict_sort): bit-identical
    to the one-hot scan for every exponent combination, including the edge
    cases e=0 and the big-table candidates the scan can't afford on device.
    Reference recurrences: floating_point_stream_compression.c:76-84, 128-195."""

    @pytest.mark.parametrize(
        "e1,e2",
        [(4, 10), (4, 8), (0, 10), (4, 0), (10, 16), (0, 0), (2, 2), (16, 20)],
    )
    def test_matches_scan(self, e1, e2):
        C, L = 5, 256
        vals = mesh_like_floats(C * L, seed=e1 * 31 + e2).view(np.uint32).reshape(C, L)
        x = jnp.asarray(vals)
        bc_s, res_s = fp_jax._predict_scan(x, *fp_jax._norm_exponents(e1, e2))
        bc_c, res_c = fp_jax.predict_f32_chunks_sort(x, e1, e2)
        np.testing.assert_array_equal(np.asarray(bc_s), np.asarray(bc_c))
        np.testing.assert_array_equal(np.asarray(res_s), np.asarray(res_c))

    def test_matches_scan_random_bits(self):
        r = np.random.default_rng(0)
        vals = r.integers(0, 2**32, (3, 512), dtype=np.uint32)
        x = jnp.asarray(vals)
        for e1, e2 in [(4, 10), (8, 14)]:
            bc_s, res_s = fp_jax._predict_scan(x, *fp_jax._norm_exponents(e1, e2))
            bc_c, res_c = fp_jax.predict_f32_chunks_sort(x, e1, e2)
            np.testing.assert_array_equal(np.asarray(bc_s), np.asarray(bc_c))
            np.testing.assert_array_equal(np.asarray(res_s), np.asarray(res_c))

    def test_encode_composite_with_sort_predictor(self, monkeypatch):
        """Full v2 encode->decode with the sort predictor forced."""
        monkeypatch.setenv("TRICO_TPU_PREDICT", "sort")
        C, L = 4, 512
        vals = mesh_like_floats(C * L, seed=9).view(np.uint32).reshape(C, L)
        x = jnp.asarray(vals)
        payloads, sizes = fp_jax.encode_f32_chunks_v2(x, 4, 10)
        dec = fp_jax.decode_f32_chunks_v2(payloads, L, 4, 10)
        np.testing.assert_array_equal(np.asarray(dec), vals)


def test_v2_row_blocking_matches_oracle(monkeypatch):
    """Row-blocked v2 entry points (the large-batch miscompile fence,
    scripts/xla_miscompile_repro.py) are bit-identical to the oracle,
    including the zero-padding path (C not a multiple of the block)."""
    import jax.numpy as jnp

    from trico_tpu.codec import fp_jax, fp_ref

    monkeypatch.setenv("TRICO_TPU_V2_ROW_BLOCK", "4")
    L, C = 64, 13  # 13 rows / block 4 -> 4 blocks with 3 rows of padding
    vals = mesh_like_floats(C * L, seed=55).view(np.uint32).reshape(C, L)
    pay, sz = fp_jax.encode_f32_chunks_v2(jnp.asarray(vals), 4, 8)
    pay, sz = np.asarray(pay), np.asarray(sz)
    assert pay.shape[0] == C and sz.shape == (C,)
    for c in range(C):
        expect = fp_jax.relayout_f32_v1_to_v2(
            np.frombuffer(fp_ref.compress(vals[c], 4, 8), np.uint8))
        assert pay[c, : sz[c]].tobytes() == expect.tobytes()
    dec = np.asarray(fp_jax.decode_f32_chunks_v2(jnp.asarray(pay), L, 4, 8))
    np.testing.assert_array_equal(dec, vals)
    # adaptive encode under blocking: still self-describing + decodable
    pay_a, sz_a = fp_jax.encode_f32_chunks_v2_adaptive(jnp.asarray(vals))
    pay_a, sz_a = np.asarray(pay_a), np.asarray(sz_a)
    for hi in np.unique(pay_a[:, 0]):
        idx = np.nonzero(pay_a[:, 0] == hi)[0]
        e1, e2 = (int(hi) >> 4) << 1, (int(hi) & 15) << 1
        out = np.asarray(fp_jax.decode_f32_chunks_v2(
            jnp.asarray(pay_a[idx]), L, e1, e2))
        np.testing.assert_array_equal(out, vals[idx])


def test_v2_f64_row_blocking_roundtrip(monkeypatch):
    import jax.numpy as jnp

    from trico_tpu.codec import fp64_jax

    monkeypatch.setenv("TRICO_TPU_V2_ROW_BLOCK", "4")
    L, C = 32, 11
    vals = mesh_like_floats(C * L, seed=56, dtype=np.float64).view(np.uint64)
    hi = (vals >> np.uint64(32)).astype(np.uint32).reshape(C, L)
    lo = (vals & np.uint64(0xFFFFFFFF)).astype(np.uint32).reshape(C, L)
    pay, sz = fp64_jax.encode_f64_chunks_v2(jnp.asarray(hi), jnp.asarray(lo), 20, 20)
    vh, vl = fp64_jax.decode_f64_chunks_v2(jnp.asarray(np.asarray(pay)), L, 20, 20)
    np.testing.assert_array_equal(np.asarray(vh), hi)
    np.testing.assert_array_equal(np.asarray(vl), lo)


def test_pallas_tables_fit_gate():
    """The Pallas replay kernel is only attempted when its register tables
    fit (2^e1 + 2^e2 <= replay_triton.MAX_TABLE_ROWS): the adaptive
    candidates (0,6)/(4,6)/(4,10) do, the big-table (14,18) and f64-class
    exponents replay through the XLA scan or on host threads instead."""
    from trico_tpu.codec.replay_triton import tables_fit

    assert tables_fit(4, 10)   # adaptive candidate (1040 rows)
    assert tables_fit(4, 6)    # chunked default
    assert not tables_fit(16, 20)  # f64-class tables don't
    assert not tables_fit(4, 16)


def test_large_exponent_encode_falls_back(monkeypatch):
    """Encodes with large-table exponents work under any TRICO_TPU_PREDICT
    value: an unknown mode (here the removed 'pallas') selects the default
    sort predictor."""
    monkeypatch.setenv("TRICO_TPU_PREDICT", "pallas")
    vals = mesh_like_floats(2048).view(np.uint32).reshape(2, 1024)
    bc, res = fp_jax.predict_f32_chunks(jnp.asarray(vals), 12, 18)
    bc2, res2 = fp_jax.predict_f32_chunks_sort(jnp.asarray(vals), 12, 18)
    np.testing.assert_array_equal(np.asarray(bc), np.asarray(bc2))
    np.testing.assert_array_equal(np.asarray(res), np.asarray(res2))
