"""The XLA stages that carry the device path, against NumPy references, and
the platform route that picks between the GPU kernel and the XLA paths.

- encode predictor: `_predict_sort` vs `_predict_scan` vs `fp_ref`;
- byte movement: `_logshift_passes` and the merging `_pair_compact_or_xla`
  vs a NumPy placement of each live element at its destination;
- f64: the sort and scan predictors and the scan replay vs the oracle;
- adaptive candidates: per-candidate sort predictors, smallest chunk wins;
- `kernel_route` on "gpu", "cpu" and platforms with no route.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from trico_tpu.codec import fp64_jax, fp_jax, fp_ref, pack_funnel, replay_triton

from conftest import mesh_like_floats

# The exponent grid the removed one-hot predictor kernels were pinned on,
# plus the adaptive candidates and the degenerate (0, 0).
PREDICT_GRID = [(0, 6), (4, 6), (4, 8), (4, 10), (2, 8), (0, 10), (4, 0),
                (10, 16), (14, 18), (0, 0)]


def _chunks(n_chunks, L, seed=0, dtype=np.float32):
    vals = mesh_like_floats(n_chunks * L, seed=seed, dtype=dtype)
    return vals.view(np.uint32 if dtype == np.float32 else np.uint64).reshape(
        n_chunks, L)


@pytest.mark.parametrize("e1,e2", PREDICT_GRID)
def test_predict_sort_scan_oracle(e1, e2):
    C, L = 3, 128
    chunks = _chunks(C, L, seed=e1 * 31 + e2)
    v = jnp.asarray(chunks)
    x1s, x2s = fp_jax._predict_sort(v, e1, e2)
    bc_scan, res_scan = fp_jax._predict_scan(v, e1, e2)
    bc_sort, res_sort = fp_jax._bcode_res_from_xors(x1s, x2s)
    np.testing.assert_array_equal(np.asarray(bc_sort), np.asarray(bc_scan))
    np.testing.assert_array_equal(np.asarray(res_sort), np.asarray(res_scan))
    for c in range(C):
        p1, p2 = fp_ref.predictions(chunks[c], e1, e2)
        np.testing.assert_array_equal(np.asarray(x1s)[c], chunks[c] ^ p1)
        np.testing.assert_array_equal(np.asarray(x2s)[c], chunks[c] ^ p2)


def _monotone_pairs(rng, S, merge=False):
    """Random live lanes ``hi`` and destinations ``lo <= hi`` with ``lo``
    increasing (nondecreasing for ``merge``: only consecutive lanes share a
    destination) and ``hi - lo`` nondecreasing — the log-shift networks'
    precondition."""
    hi = np.sort(rng.choice(S, rng.integers(1, S // 2), replace=False))
    lo = np.empty_like(hi)
    lo[0] = rng.integers(0, hi[0] + 1)
    for k in range(1, len(hi)):
        gap = hi[k] - hi[k - 1]
        if merge and gap == 1 and rng.random() < 0.5:
            lo[k] = lo[k - 1]
        else:
            lo[k] = lo[k - 1] + rng.integers(1, gap + 1)
    return hi, lo


def _monotone_words(rng, C, S, pb, direction):
    """Random monotone movements packed as (shift << pb | payload) words,
    and the NumPy result: each payload at its destination, 0 elsewhere.
    Left moves a lane down to its destination; right moves it back up."""
    words = np.zeros((C, S), np.uint32)
    want = np.zeros((C, S), np.uint32)
    for c in range(C):
        hi, lo = _monotone_pairs(rng, S)
        src, dst = (hi, lo) if direction == "left" else (lo, hi)
        payload = rng.integers(1, 1 << pb, len(src), dtype=np.uint32)
        words[c, src] = ((hi - lo).astype(np.uint32) << pb) | payload
        want[c, dst] = payload
    return words, want


@pytest.mark.parametrize("direction", ["left", "right"])
@pytest.mark.parametrize("S", [128, 512, 4096])
def test_logshift_passes_matches_numpy(direction, S):
    rng = np.random.default_rng(S + (direction == "left"))
    pb = 8
    words, want = _monotone_words(rng, 5, S, pb, direction)
    got = fp_jax._logshift_passes(jnp.asarray(words), pb, S, direction) \
        & jnp.uint32((1 << pb) - 1)
    np.testing.assert_array_equal(np.asarray(got), want)


@pytest.mark.parametrize("merge", [False, True])
@pytest.mark.parametrize("S", [128, 512, 4096])
def test_pair_compact_or_matches_numpy(S, merge):
    """Merging left-compaction: items with one destination OR together
    (``merge`` lets consecutive lanes share a destination)."""
    rng = np.random.default_rng(7 * S + merge)
    C = 4
    carrier = np.zeros((C, S), np.uint32)
    payload = np.zeros((C, S), np.uint32)
    want = np.zeros((C, S), np.uint32)
    for c in range(C):
        src, dst = _monotone_pairs(rng, S, merge)
        bits = rng.integers(0, 32, len(src))
        pay = (np.uint32(1) << bits.astype(np.uint32)).astype(np.uint32)
        carrier[c, src] = ((src - dst).astype(np.uint32) << 1) | 1
        payload[c, src] = pay
        np.bitwise_or.at(want[c], dst, pay)
    nbits = (S - 1).bit_length()
    got = pack_funnel._pair_compact_or_xla(
        jnp.asarray(carrier), jnp.asarray(payload), nbits)
    np.testing.assert_array_equal(np.asarray(got), want)


def _hi_lo(vals):
    return (jnp.asarray((vals >> np.uint64(32)).astype(np.uint32)),
            jnp.asarray((vals & np.uint64(0xFFFFFFFF)).astype(np.uint32)))


@pytest.mark.parametrize("e1,e2", [(0, 6), (4, 6), (4, 10), (10, 12)])
def test_predict64_sort_scan_oracle(e1, e2):
    C, L = 3, 256
    vals = _chunks(C, L, seed=e1 + 5 * e2, dtype=np.float64)
    hi, lo = _hi_lo(vals)
    x1h, x1l, x2h, x2l = fp64_jax._predict_sort64(hi, lo, e1, e2)
    bc_sort = fp64_jax._bcode_res_from_xors64(x1h, x1l, x2h, x2l)
    bc_scan = fp64_jax._predict_scan64(hi, lo, e1, e2)
    for a, b in zip(bc_sort, bc_scan):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    x1 = (np.asarray(x1h).astype(np.uint64) << np.uint64(32)) | np.asarray(x1l)
    x2 = (np.asarray(x2h).astype(np.uint64) << np.uint64(32)) | np.asarray(x2l)
    for c in range(C):
        p1, p2 = fp_ref.predictions(vals[c], e1, e2)
        np.testing.assert_array_equal(x1[c], vals[c] ^ p1)
        np.testing.assert_array_equal(x2[c], vals[c] ^ p2)


@pytest.mark.parametrize("e1,e2", [(4, 6), (4, 10), (10, 16)])
def test_replay64_scan_roundtrip(e1, e2):
    C, L = 3, 512
    vals = _chunks(C, L, seed=9 + e2, dtype=np.float64)
    hi, lo = _hi_lo(vals)
    bc, rh, rl = fp64_jax.predict_f64_chunks(hi, lo, e1, e2)
    vh, vl = fp64_jax.replay_f64_chunks(bc, rh, rl, e1, e2)
    np.testing.assert_array_equal(np.asarray(vh), np.asarray(hi))
    np.testing.assert_array_equal(np.asarray(vl), np.asarray(lo))


@pytest.mark.parametrize("cands", [
    ((0, 6), (4, 6), (4, 10), (14, 18)),   # production default
    ((0, 6), (4, 6), (8, 6), (4, 10)),     # several e1 sharing one e2
    ((0, 8), (0, 6), (4, 6)),              # e1=0 members in two e2 groups
    ((4, 10), (14, 18)),
])
def test_adaptive_encode_picks_smallest_candidate(cands):
    """Each chunk's adaptive payload is the smallest single-candidate one
    (first wins ties) and decodes back with its self-described exponents."""
    C, L = 4, 256
    chunks = _chunks(C, L, seed=77)
    v = jnp.asarray(chunks)
    pay, sizes = fp_jax._encode_f32_chunks_v2_adaptive_impl(v, cands)
    pay, sizes = np.asarray(pay), np.asarray(sizes)
    singles = np.stack([np.asarray(fp_jax.encode_f32_chunks_v2(v, e1, e2)[1])
                        for (e1, e2) in cands])
    np.testing.assert_array_equal(sizes, singles.min(axis=0))
    for c in range(C):
        k = int(np.argmin(singles[:, c]))
        e1, e2 = fp_jax._norm_exponents(*cands[k])
        assert pay[c, 0] == ((e1 >> 1) << 4) | (e2 >> 1)
        dec = fp_jax.decode_f32_chunks_v2(jnp.asarray(pay[c:c + 1]), L, e1, e2)
        np.testing.assert_array_equal(np.asarray(dec)[0], chunks[c])


@pytest.mark.parametrize("platform,route", [("gpu", "triton"), ("cpu", "xla")])
def test_kernel_route(platform, route):
    assert fp_jax.kernel_route(platform) == route


@pytest.mark.parametrize("platform", ["tpu", "rocm", "METAL"])
def test_kernel_route_rejects_unknown_platform(platform):
    with pytest.raises(RuntimeError, match=repr(platform)):
        fp_jax.kernel_route(platform)


def test_kernel_route_default_is_this_backend():
    assert fp_jax.kernel_route() == "xla"  # the tests run on the CPU


@pytest.mark.parametrize("e1,e2,kernel", [
    (0, 6, True), (4, 6, True), (4, 10, True), (4, 12, False), (14, 18, False),
])
def test_replay_dispatch_on_gpu_route(monkeypatch, e1, e2, kernel):
    """On the "triton" route, `_replay_impl` hands tables that fit to the
    kernel (run here in interpret mode) and the rest to the XLA scan; both
    reproduce the input."""
    calls = []
    real = replay_triton.replay

    def spy(bc, x, a, b):
        calls.append((a, b))
        return real(bc, x, a, b, True)

    monkeypatch.setattr(fp_jax, "kernel_route", lambda platform=None: "triton")
    monkeypatch.setattr(replay_triton, "replay", spy)
    C, L = 2, 64
    chunks = _chunks(C, L, seed=e2)
    bc, res = fp_jax._predict_scan(jnp.asarray(chunks), e1, e2)
    got = fp_jax._replay_impl(bc, res, e1, e2)
    np.testing.assert_array_equal(np.asarray(got), chunks)
    assert calls == ([(e1, e2)] if kernel else [])


def test_device_path_off_on_cpu():
    """With the CPU backend, containers take the host codec by default."""
    from trico_tpu import chunked

    assert chunked._tpu_available() is False


def test_device_path_raises_on_unknown_platform(monkeypatch):
    """A platform with no route is an error, never a silent host fallback."""
    from trico_tpu import chunked

    monkeypatch.setattr(fp_jax, "kernel_route", lambda platform=None: (
        _ for _ in ()).throw(RuntimeError("no device route for 'tpu'")))
    with pytest.raises(RuntimeError, match="tpu"):
        chunked._tpu_available()
