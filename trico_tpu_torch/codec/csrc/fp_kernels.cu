// Hopper (sm_90a) kernels of the chunked FP codec (f32 and f64), v2 layout.
//
// Each kernel computes the same function as one or two Pallas TPU kernels of
// trico_tpu/codec/fp_pallas.py, bit for bit, but not with their block
// structure: the TPU kernels read tables by one-hot compare/select and move
// data through log-shift networks because the TPU has no fast gather or
// scatter; Hopper indexes and scatters in shared memory directly, so those
// workarounds are gone. The TPU also has no 64-bit
// integers, so its f64 kernels carry (hi, lo) u32 pairs with explicit carry
// and borrow; here a u64 word is a uint64_t, and the f32 and f64 kernels are
// one template over the word type W.
//
// A u32 word is a uint32_t here and an int32 tensor in Python; a u64 word is
// a uint64_t here and an int64 tensor in Python. Every entry point is a plain
// C function that launches on the caller's stream, does not synchronise,
// allocates nothing, and returns cudaGetLastError() (0 = ok).
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC (trico_tpu_torch/codec/_build.py).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
// Largest dynamic shared memory one block may opt into on an H100.
constexpr int kMaxSmem = 232448;
constexpr int kDefaultSmem = 49152;
// Shared memory of one H100 SM, which its resident blocks divide.
constexpr int kSmSmem = 233472;
// Exponents one fcm_multi launch takes (fp_cuda.MAX_FCM).
constexpr int kMaxFcm = 8;

// The choices below are fixed from measurements on the H100 and are no
// argument of any entry point. tools/kernel_compare.py builds copies of this
// file with other values (-D...) to time them beside the library's.
#ifndef TT_PREDICT_DEPTH
#define TT_PREDICT_DEPTH 4
#endif
#ifndef TT_FCM_DEPTH
#define TT_FCM_DEPTH 4
#endif
#ifndef TT_SHIFT_VEC
#define TT_SHIFT_VEC 2
#endif
#ifndef TT_SHIFT_KERNEL
#define TT_SHIFT_KERNEL 0
#endif
// Windows of 32 values that a predictor warp fetches ahead of the ones it
// resolves: 1 and 2 are slower, 8 gains 3% on u32 words and loses 1-2% on
// u64 words.
constexpr int kPredictDepth = TT_PREDICT_DEPTH;
// The same for the fcm_multi warp.
constexpr int kFcmDepth = TT_FCM_DEPTH;
// 16-byte loads a thread of a logshift or pair_compact tile block makes:
// tiles of 1024 x this many source slots. For logshift 1 is slower
// everywhere, 4 level with 2.
constexpr int kShiftVec = TT_SHIFT_VEC;
// Which logshift kernel a launch takes. 0: a block per row for a right
// expansion whose row fits the stage, the tiles otherwise; 1: the tiles
// always; -1: a block per row wherever the row fits.
constexpr int kShiftKernel = TT_SHIFT_KERNEL;

// Top e bits of a word, as a table key; 0 when e == 0. `x >> 32` (or 64) is
// undefined in C++, and the reference keeps the FCM/DFCM key at 0 for a zero
// exponent (fp_pallas.py:74, :78, :608, :615). Exponents are at most 30, so a
// key is below 2^30.
template <typename W>
__device__ __forceinline__ uint32_t top_bits(W x, int e) {
  return e ? (uint32_t)(x >> (8 * (int)sizeof(W) - e)) : 0u;
}

// Key of a lane past the end of the chunk: above every live key and unique
// to the lane, so it matches nothing.
__device__ __forceinline__ uint32_t dead_key(int lane) {
  return 0x80000000u | (uint32_t)lane;
}

// One warp's window of 32 positions, lane i holding position base + i, and
// one hash table: whether a lower lane holds this lane's key (`hit`), that
// lane's payload (`from_lane`), and whether this lane is the last of its key
// (`last`, the one that writes the table). No table is read.
template <typename W>
__device__ __forceinline__ void window_match(uint32_t key, W payload, int lane,
                                             bool& hit, bool& last,
                                             W& from_lane) {
  const unsigned group = __match_any_sync(kFull, key);
  const unsigned below = group & ((1u << lane) - 1u);
  from_lane = __shfl_sync(kFull, payload, below ? 31 - __clz(below) : lane);
  hit = below != 0u;
  last = (group >> lane) == 1u;
}

// ---------------------------------------------------------------------------
// predict_kernel<uint32_t, D> (tt_predict_xors): replaces
// _predict_window_kernel (fp_pallas.py:85) and _predict_kernel
// (fp_pallas.py:59). predict_kernel<uint64_t, D> (tt_predict64_xors):
// replaces _predict64_window_kernel (fp_pallas.py:493) and _predict64_kernel
// (fp_pallas.py:578).
//
// Encode has no value->prediction feedback: the FCM key of position i is
// top_e1(v[i-1]) and the DFCM key is t[i-1] ^ ((t[i-2] << e2/2) & m2) with
// t = top_e2(v - vprev), for f32 and f64 alike (the f64 keys read only the
// high word). So a table read at i is "payload of the latest j < i with the
// same key, else 0". One warp per chunk walks it 32 positions (a window) at
// a time (window_match, then the table).
//
// Bound on the H100: device-memory bytes (one word in, two out per value:
// 0.030 ms for (2048, 4096) u32 words at 3.35 TB/s, 0.120 ms for
// (4096, 4096) u64 words). A chunk is one warp, so a launch has only C
// warps to keep loads in flight, and what a warp does in turn for each
// window must be short, or L / 32 times that sets the launch's time. The
// design: the two tables of each chunk stay in shared memory (80 words at
// (4,6)) and several chunk warps share a block. Each warp holds the next D
// windows of its row in registers, fetched before the current D are
// resolved, so 2 * D * 128 bytes (u32) a warp are in flight. Keys, key
// groups and the payloads that come from a lower lane need no table, only
// the fetched values (the carries between windows too): they are worked
// out for all D windows first, so that the two match_any and nine shuffles
// of one window overlap those of the next. What is left in turn for each
// window is the table read of the lanes without a lower match, the two
// stores, and the table write, with a __syncwarp after each.
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t ld_stream(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.global.nc.u32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}
__device__ __forceinline__ uint64_t ld_stream(const uint64_t* p) {
  uint64_t v;
  asm volatile("ld.global.nc.u64 %0, [%1];" : "=l"(v) : "l"(p));
  return v;
}

// D windows of a row from `base` on, lane i of window u holding position
// base + 32 u + i (0 past the row's end). The loads start here, in program
// order.
template <typename W, int D>
__device__ __forceinline__ void fetch_windows(const W* row, int base, int L,
                                              int lane, W (&w)[D]) {
#pragma unroll
  for (int u = 0; u < D; ++u) {
    const int i = base + 32 * u + lane;
    w[u] = i < L ? ld_stream(row + i) : W(0);
  }
}

// The value before each position of D windows; `carry` holds the one before
// the first window and becomes the last window's last value.
template <typename W, int D>
__device__ __forceinline__ void prev_values(const W (&v)[D], int lane,
                                            W& carry, W (&vprev)[D]) {
#pragma unroll
  for (int u = 0; u < D; ++u) {
    const W up1 = __shfl_up_sync(kFull, v[u], 1);
    vprev[u] = lane ? up1 : carry;
    carry = __shfl_sync(kFull, v[u], 31);
  }
}

// The FCM keys of D windows from `base` on (the top e bits of the value
// before each position; a lane past the row's end gets a key that matches
// nothing) and their window_match, the values being the payloads.
template <typename W, int D>
__device__ __forceinline__ void fcm_windows(const W (&v)[D],
                                            const W (&vprev)[D], int base,
                                            int L, int lane, int e,
                                            uint32_t (&key)[D], bool (&hit)[D],
                                            bool (&last)[D], W (&from)[D]) {
#pragma unroll
  for (int u = 0; u < D; ++u) {
    key[u] = base + 32 * u + lane < L ? top_bits(vprev[u], e) : dead_key(lane);
    window_match(key[u], v[u], lane, hit[u], last[u], from[u]);
  }
}

template <typename W, int D>
__global__ void predict_kernel(const W* __restrict__ values,
                               W* __restrict__ xor1, W* __restrict__ xor2,
                               int C, int L, int e1, int e2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int T1 = 1 << e1, T2 = 1 << e2;
  const long long c = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
  if (c >= C) return;  // warp-uniform
  const W* row = values + c * L;
  W cur[D], nxt[D];
  fetch_windows(row, 0, L, lane, cur);

  W* t1 = reinterpret_cast<W*>(smem_raw) + (size_t)warp * (T1 + T2);
  W* t2 = t1 + T1;
  for (int k = lane; k < T1 + T2; k += 32) t1[k] = W(0);
  __syncwarp();

  W* x1 = xor1 + c * L;
  W* x2 = xor2 + c * L;
  const uint32_t m2 = (uint32_t)((1ull << e2) - 1);
  const int sh2 = e2 >> 1;
  W vprev_c = W(0);
  uint32_t tprev = 0u, tprev2 = 0u;  // carries, zero at i = 0

  for (int base = 0; base < L; base += 32 * D) {
    fetch_windows(row, base + 32 * D, L, lane, nxt);
    W s[D], vprev[D], from1[D], from2[D];
    uint32_t k1[D], k2[D];
    bool hit1[D], hit2[D], last1[D], last2[D];
    // no table is read until the windows' turns below
    prev_values(cur, lane, vprev_c, vprev);
    fcm_windows(cur, vprev, base, L, lane, e1, k1, hit1, last1, from1);
#pragma unroll
    for (int u = 0; u < D; ++u) {
      const bool active = base + 32 * u + lane < L;
      s[u] = cur[u] - vprev[u];
      const uint32_t t = top_bits(s[u], e2);
      const uint32_t tu1 = __shfl_up_sync(kFull, t, 1);
      const uint32_t tu2 = __shfl_up_sync(kFull, t, 2);
      const uint32_t t_1 = lane >= 1 ? tu1 : tprev;
      const uint32_t t_2 = lane >= 2 ? tu2 : (lane == 1 ? tprev : tprev2);
      k2[u] = active ? (e2 ? (t_1 ^ ((t_2 << sh2) & m2)) : 0u) : dead_key(lane);
      window_match(k2[u], s[u], lane, hit2[u], last2[u], from2[u]);
      tprev2 = __shfl_sync(kFull, t, 30);
      tprev = __shfl_sync(kFull, t, 31);
    }
#pragma unroll
    for (int u = 0; u < D; ++u) {
      const int i = base + 32 * u + lane;
      if (i - lane >= L) break;  // warp-uniform
      const bool active = i < L;
      const W v = cur[u];
      // the latest lower lane with the key, else the table as the window
      // found it (a dead lane's key matches nothing and reads nothing)
      const W pred1 = hit1[u] ? from1[u] : (active ? t1[k1[u]] : W(0));
      const W pred2 = hit2[u] ? from2[u] : (active ? t2[k2[u]] : W(0));
      if (active) {
        x1[i] = v ^ pred1;
        x2[i] = v ^ (vprev[u] + pred2);
      }
      __syncwarp();  // every lane read the tables as of the window's start
      if (active && last1[u]) t1[k1[u]] = v;
      if (active && last2[u]) t2[k2[u]] = s[u];
      __syncwarp();
    }
#pragma unroll
    for (int u = 0; u < D; ++u) cur[u] = nxt[u];
  }
}

// ---------------------------------------------------------------------------
// fcm_multi_kernel<D> (tt_fcm_multi_xors): replaces _fcm_multi_kernel
// (fp_pallas.py:150).
//
// The FCM half of predict_kernel<uint32_t, D> for K exponents at once: plane
// q of a (K, C, L) output holds v ^ T_q[top_e_q(vprev)], T_q a table of 2^e_q
// words. Bound on the H100: device-memory bytes, one word in and K out per
// value (0.020 ms for (2048, 4096) at K = 1, 0.040 ms at K = 3). As in
// predict_kernel a chunk is one warp, so what a warp does in turn for each
// window sets the time unless its loads are in flight meanwhile; the kernel
// before this one fetched one window at a time and resolved it straight
// after its load (0.0906 ms at K = 1, 22% of the bound). The design is
// predict_kernel's window pipeline, with the exponent loop inside it: the
// next D windows of the row are fetched before the current D are resolved;
// then, exponent by exponent, keys, key groups and lane payloads of all D
// windows come from the fetched values alone (fcm_windows), followed by the
// D table steps of table q and the coalesced stores into plane q. Only one
// exponent's match state is live at a time, so K = 8 spills nothing, and the
// fetched values serve all K tables. The exponents come packed five bits
// each in one 64-bit argument: an array argument indexed by the loop
// variable could be copied to local memory.
// ---------------------------------------------------------------------------
template <int D>
__global__ void fcm_multi_kernel(const uint32_t* __restrict__ values,
                                 uint32_t* __restrict__ out, int C, int L,
                                 int K, unsigned long long exps,
                                 int words_per_warp) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long c = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
  if (c >= C) return;  // warp-uniform
  const uint32_t* row = values + c * L;
  uint32_t cur[D], nxt[D];
  fetch_windows(row, 0, L, lane, cur);

  uint32_t* tables =
      reinterpret_cast<uint32_t*>(smem_raw) + (size_t)warp * words_per_warp;
  for (int k = lane; k < words_per_warp; k += 32) tables[k] = 0u;
  __syncwarp();

  const long long plane = (long long)C * L;
  uint32_t vprev_c = 0u;
  for (int base = 0; base < L; base += 32 * D) {
    fetch_windows(row, base + 32 * D, L, lane, nxt);
    uint32_t vprev[D];
    prev_values(cur, lane, vprev_c, vprev);
    uint32_t* t = tables;
    uint32_t* o = out + c * L;
    for (int q = 0; q < K; ++q) {
      const int e = (int)(exps >> (5 * q)) & 31;
      uint32_t key[D], from[D];
      bool hit[D], last[D];
      fcm_windows(cur, vprev, base, L, lane, e, key, hit, last, from);
#pragma unroll
      for (int u = 0; u < D; ++u) {
        const int i = base + 32 * u + lane;
        if (i - lane >= L) break;  // warp-uniform
        const bool active = i < L;
        const uint32_t pred = hit[u] ? from[u] : (active ? t[key[u]] : 0u);
        if (active) o[i] = cur[u] ^ pred;
        __syncwarp();  // every lane read table q as of the window's start
        if (active && last[u]) t[key[u]] = cur[u];
        __syncwarp();
      }
      t += 1 << e;
      o += plane;
    }
#pragma unroll
    for (int u = 0; u < D; ++u) cur[u] = nxt[u];
  }
}

// ---------------------------------------------------------------------------
// replay_kernel<uint32_t> (tt_replay): replaces _replay_kernel
// (fp_pallas.py:216). replay_kernel<uint64_t> (tt_replay64): replaces
// _replay64_kernel (fp_pallas.py:440).
//
// Decode feeds each value back into the next keys, so a chunk is one
// sequential chain: per value an xor, a shift, an address, a shared-memory
// store and a dependent shared-memory load (for a DFCM value a subtraction
// and an addition more). A bcode above fcm_max (4 for f32, 8 for f64: the
// word's byte count) takes the DFCM prediction.
//
// Bound on the H100: the latency of that chain times L, as long as (a) the
// chain touches only shared memory and registers, (b) nothing else runs in
// the chain's instruction stream and (c) a warp scheduler is not asked for
// more instructions per step than the chain takes cycles. The design:
//  * A block is two warps and holds G chunks (G = 1: a warp per chunk;
//    G = 32: a lane per chunk; launch_replay picks G so that every warp
//    scheduler of the card has about one walking warp). Lanes 0..G-1 of the
//    walking warp each walk one chain; a chain instruction issues once for
//    G chunks.
//  * The copying warp moves the chunks through shared memory in tiles of T
//    values, three stages deep: while the chains walk tile t it stores tile
//    t - 1 to device memory with coalesced stores and fetches tile t + 1 of
//    `xors` and `bcodes` with coalesced cp.async (16, 8 or 4 bytes wide, as
//    the row's address allows; plain byte copies for what is left). One
//    __syncthreads per tile hands the stages on. A chain writes its values
//    over the tile's xors. Device memory sees each byte once, in full
//    sectors, and the chain's warp issues nothing but the chain.
//  * The chain reads and writes its tile 16 bytes at a time, the next four
//    values fetched before the current four are walked, and addresses its
//    tables by their shared-memory address (key scaled and added in one
//    instruction).
// Rows of neighbouring chunks are 16 bytes past a multiple of 128 apart in
// shared memory, so that up to 8 walking lanes hit distinct banks.
// ---------------------------------------------------------------------------
__device__ __forceinline__ void cp_async(unsigned dst, const void* src,
                                         int bytes) {
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst),
                 "l"(src)
                 : "memory");
  else if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(dst),
                 "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(dst),
                 "l"(src)
                 : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// Shared-memory accesses by 32-bit shared address.
__device__ __forceinline__ uint32_t lds(unsigned a, uint32_t) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];" : "=r"(v) : "r"(a) : "memory");
  return v;
}
__device__ __forceinline__ uint64_t lds(unsigned a, uint64_t) {
  uint64_t v;
  asm volatile("ld.shared.u64 %0, [%1];" : "=l"(v) : "r"(a) : "memory");
  return v;
}
__device__ __forceinline__ void sts(unsigned a, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;" ::"r"(a), "r"(v) : "memory");
}
__device__ __forceinline__ void sts(unsigned a, uint64_t v) {
  asm volatile("st.shared.u64 [%0], %1;" ::"r"(a), "l"(v) : "memory");
}
__device__ __forceinline__ void sts_byte(unsigned a, uint32_t v) {
  asm volatile("st.shared.u8 [%0], %1;" ::"r"(a), "r"(v) : "memory");
}

// Four values of a tile: 16 bytes of u32 words or 32 of u64 words.
__device__ __forceinline__ void lds4(unsigned a, uint32_t (&q)[4]) {
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(q[0]), "=r"(q[1]), "=r"(q[2]), "=r"(q[3])
               : "r"(a)
               : "memory");
}
__device__ __forceinline__ void lds4(unsigned a, uint64_t (&q)[4]) {
  asm volatile("ld.shared.v2.u64 {%0, %1}, [%2];"
               : "=l"(q[0]), "=l"(q[1])
               : "r"(a)
               : "memory");
  asm volatile("ld.shared.v2.u64 {%0, %1}, [%2];"
               : "=l"(q[2]), "=l"(q[3])
               : "r"(a + 16)
               : "memory");
}
__device__ __forceinline__ void sts4(unsigned a, const uint32_t (&q)[4]) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};" ::"r"(a), "r"(q[0]),
               "r"(q[1]), "r"(q[2]), "r"(q[3])
               : "memory");
}
__device__ __forceinline__ void sts4(unsigned a, const uint64_t (&q)[4]) {
  asm volatile("st.shared.v2.u64 [%0], {%1, %2};" ::"r"(a), "l"(q[0]),
               "l"(q[1])
               : "memory");
  asm volatile("st.shared.v2.u64 [%0], {%1, %2};" ::"r"(a + 16), "l"(q[2]),
               "l"(q[3])
               : "memory");
}

// The warp copies nbytes from src (device memory, any alignment) to the
// shared address dst (16-byte aligned): asynchronous pieces as wide as src's
// address allows, then plain byte copies for the rest.
template <int width>
__device__ __forceinline__ int stage_pieces(unsigned dst,
                                            const unsigned char* src,
                                            int nbytes, int lane) {
  const int n = nbytes / width;
  for (int k = lane; k < n; k += 32)
    cp_async(dst + k * width, src + k * width, width);
  return n * width;
}

__device__ __forceinline__ void stage_bytes(unsigned dst,
                                            const unsigned char* src,
                                            int nbytes, int lane) {
  const unsigned long long a = (unsigned long long)src;
  int done = 0;
  if ((a & 15) == 0) done = stage_pieces<16>(dst, src, nbytes, lane);
  else if ((a & 7) == 0) done = stage_pieces<8>(dst, src, nbytes, lane);
  else if ((a & 3) == 0) done = stage_pieces<4>(dst, src, nbytes, lane);
  for (int k = done + lane; k < nbytes; k += 32) sts_byte(dst + k, src[k]);
}

constexpr int kReplayStages = 3;

// Shared memory of one replay block (G chunks, tiles of T values), in
// bytes: the tables, then kReplayStages stages, each the G word rows and
// then the G bcode rows of one tile.
template <typename W>
struct ReplayLayout {
  int words;      // table words per chunk
  int row_words;  // bytes between two chunks' word rows
  int row_codes;  // bytes between two chunks' bcode rows
  __host__ __device__ ReplayLayout(int e1, int e2, int T)
      : words((1 << e1) + (1 << e2)),
        row_words(T * (int)sizeof(W) + 16),
        row_codes(T + 16) {}
  __host__ __device__ long long tables(int G) const {
    return (((long long)G * words * (long long)sizeof(W)) + 15) / 16 * 16;
  }
  __host__ __device__ long long stage(int G) const {
    return (long long)G * (row_words + row_codes);
  }
  __host__ __device__ long long total(int G) const {
    return tables(G) + kReplayStages * stage(G);
  }
};

// kZero: one of the exponents is 0, whose key stays 0 (a shift by the whole
// word is undefined, so that path masks instead).
template <typename W, bool kZero>
__global__ void __launch_bounds__(64)
replay_kernel(const uint8_t* __restrict__ bcodes, const W* __restrict__ xors,
              W* __restrict__ out, int C, int L, int e1, int e2, int G, int T) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kBits = 8 * (int)sizeof(W);
  constexpr int kW = (int)sizeof(W);
  constexpr uint32_t kFcmMax = (uint32_t)sizeof(W);
  const int lane = threadIdx.x & 31;
  const bool walker = threadIdx.x < 32;  // warp 0 walks, warp 1 copies
  const long long c0 = (long long)blockIdx.x * G;
  const int g_count = (int)(C - c0 < G ? C - c0 : G);  // chunks of this block
  const ReplayLayout<W> lay(e1, e2, T);
  const unsigned smem = (unsigned)__cvta_generic_to_shared(smem_raw);
  const unsigned stage0 = smem + (unsigned)lay.tables(G);
  const unsigned stage_size = (unsigned)lay.stage(G);
  const unsigned codes_at = (unsigned)G * lay.row_words;  // within a stage
  const int n_tiles = (L + T - 1) / T;

  if (!walker) {
    // fetch tile t of every chunk into stage t % kReplayStages
    auto fetch = [&](int t) {
      const int n = L - t * T < T ? L - t * T : T;
      const unsigned st = stage0 + (t % kReplayStages) * stage_size;
      for (int g = 0; g < g_count; ++g) {
        const long long at = (c0 + g) * L + (long long)t * T;
        stage_bytes(st + g * lay.row_words,
                    reinterpret_cast<const unsigned char*>(xors + at), n * kW,
                    lane);
        stage_bytes(st + codes_at + g * lay.row_codes, bcodes + at, n, lane);
      }
    };
    fetch(0);
    cp_async_wait_all();
    __syncthreads();  // tile 0 and the zeroed tables are in place
    for (int t = 0; t <= n_tiles; ++t) {
      if (t + 1 < n_tiles) fetch(t + 1);
      if (t >= 1) {  // tile t - 1 is walked: store it
        const int u = t - 1;
        const int n = L - u * T < T ? L - u * T : T;
        const unsigned st = stage0 + (u % kReplayStages) * stage_size;
        for (int g = 0; g < g_count; ++g) {
          W* o = out + (c0 + g) * L + (long long)u * T;
          const unsigned x = st + g * lay.row_words;
          for (int i = lane; i < n; i += 32) o[i] = lds(x + i * kW, W(0));
        }
      }
      cp_async_wait_all();
      __syncthreads();  // tile t is walked, tile t + 1 has landed
    }
    return;
  }

  // the walking warp: zero the tables, then one chain per lane
  for (int k = lane; k < g_count * lay.words; k += 32)
    sts(smem + k * kW, W(0));
  const unsigned t1 = smem + (unsigned)lane * lay.words * kW;
  const unsigned t2 = t1 + (kW << e1);
  const uint32_t m1 = (uint32_t)((1ull << e1) - 1);
  const uint32_t m2 = (uint32_t)((1ull << e2) - 1);
  const int s1 = e1 ? kBits - e1 : 0, s2 = e2 ? kBits - e2 : 0;
  const int sh2 = e2 >> 1;
  unsigned a1 = t1, a2 = t2;  // addresses of the entries at keys h1 and h2
  uint32_t h2 = 0u;
  W pred1 = W(0), pred2 = W(0), last = W(0);
  // one step of the chain: xor word and bcode in, value out
  auto step = [&](W xv, uint32_t code) -> W {
    const W pred = code > kFcmMax ? last + pred2 : pred1;
    const W v = xv ^ pred;
    sts(a1, v);
    const uint32_t h1 =
        kZero ? ((uint32_t)(v >> s1) & m1) : (uint32_t)(v >> s1);
    a1 = t1 + h1 * kW;
    pred1 = lds(a1, W(0));
    const W stride = v - last;
    sts(a2, stride);
    // (h2 << sh2) & m2 does not wait for the stride; the stride's top e2
    // bits are below 2^e2 already
    const uint32_t carry = (h2 << sh2) & m2;
    h2 = carry ^ (kZero ? ((uint32_t)(stride >> s2) & m2)
                        : (uint32_t)(stride >> s2));
    a2 = t2 + h2 * kW;
    pred2 = lds(a2, W(0));
    last = v;
    return v;
  };
  __syncthreads();
  for (int t = 0; t <= n_tiles; ++t) {
    if (t < n_tiles && lane < g_count) {
      const int n = L - t * T < T ? L - t * T : T;
      const unsigned st = stage0 + (t % kReplayStages) * stage_size;
      const unsigned x = st + lane * lay.row_words;
      const unsigned bc = st + codes_at + lane * lay.row_codes;
      // four values at a time, the next four fetched first; past the last
      // group that fetch reads the row's padding (and, for u64, the start of
      // what follows it in the stage), which nothing uses
      W q[4], nq[4];
      uint32_t codes = lds(bc, uint32_t(0)), ncodes;
      lds4(x, q);
      int i = 0;
      for (; i + 4 <= n; i += 4) {
        lds4(x + (i + 4) * kW, nq);
        ncodes = lds(bc + i + 4, uint32_t(0));
#pragma unroll
        for (int k = 0; k < 4; ++k)
          q[k] = step(q[k], (codes >> (8 * k)) & 255u);
        sts4(x + i * kW, q);
#pragma unroll
        for (int k = 0; k < 4; ++k) q[k] = nq[k];
        codes = ncodes;
      }
#pragma unroll
      for (int k = 0; k < 3; ++k)
        if (i + k < n)
          sts(x + (i + k) * kW, step(q[k], (codes >> (8 * k)) & 255u));
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// logshift (tt_logshift): replaces _logshift_kernel (fp_pallas.py:275).
//
// A word is shift << pb | payload (0 = dead). The network moves each live
// word by `shift` lanes, left or right, and the caller guarantees that the
// movement is monotone: destinations rise with the source lane, so no two
// words share one. A word that would leave the row is dropped.
//
// Bound on the H100: device-memory bytes, 8 a slot (the word read, the
// payload written): 0.080 ms at (2048, 16384), 0.841 ms at (5376, 65536),
// 1.683 ms at (10752, 65536). To stay near it every output word is written
// exactly once, by the kernel, in full sectors (no memset before a 4-byte
// scatter), and nothing per slot costs more than a few instructions (the
// row comes from the block index, not from a 64-bit division). The design
// (logshift_tile_kernel):
//  * A block takes one tile of T source slots of one row, 16 bytes a thread
//    and load, on the 16-byte grid of the row's address (the row's first and
//    last vector are read word by word, so no byte outside the tensor is
//    touched whatever the row's alignment).
//  * Because destinations rise with the lane, tile t owns the output range
//    from one past the last destination of any tile before it (0 if none) up
//    to its own last destination; the row's last tile owns up to S. The
//    ranges partition the row, so there is no word that two blocks write and
//    none that nobody writes. A tile without a live word owns nothing and
//    leaves at once. The others find the range's start by scanning back
//    from their first slot until a live word turns up: the 256 slots before
//    the tile are fetched together with the tile, which nearly always
//    settles it; over a longer dead run the scan goes on 1024 slots a step.
//    These are lines that the block of the tile before reads at about the
//    same time, so L2 serves them.
//  * The range is staged in shared memory, 2 T words at a time: zeroed
//    (the first time while the loads are in flight), the tile's payloads
//    scattered into it, then streamed out with 16-byte stores on the output
//    row's 16-byte grid (its first and last vector word by word). A left
//    compaction's range is rarely longer than T; a right expansion's, and
//    the zero fill of a row's dead end, take as many rounds as they need.
// What the tiles cost is the look-back over dead runs. The codecs' left
// compactions have their live words spread along the row and pay next to
// nothing. Their right expansions (bytes or slot ids packed at the front of
// the row, moved out to their slots) leave the rest of the source row dead:
// the row's last tile reads all of that again to find where its zero fill
// begins, and the few live tiles write several tiles' worth each.
// logshift_row_kernel is the second shape: a block per row with the whole
// row staged (u32 payloads up to 58112 slots; u16 payloads, pb <= 16, up to
// 116224), zeroed, scattered into and streamed out; one block a
// multiprocessor at 65536 slots, but indifferent to where the live words
// are. On an H100 80GB HBM3 at 700 W the tiles take 0.094 ms and the rows
// 0.100 ms for the left compaction at (2048, 16384), 0.95 against 1.08 ms at
// (5376, 65536); for the right expansion 0.098 against 0.100 ms and 1.28
// against 1.08 ms. So tt_logshift gives a right expansion to the rows where
// the stage holds the row, and everything else to the tiles.
// ---------------------------------------------------------------------------
constexpr int kShiftThreads = 256;
constexpr int kRowThreads = 1024;
constexpr int kMaxSlots = 1 << 30;

// Destination + 1 of the word at slot s of its row; 0 for a dead word or
// one that moves past an edge.
__device__ __forceinline__ uint32_t dest1(uint32_t w, int s, int S, int pb,
                                          uint32_t smask, int right) {
  if (!w) return 0u;
  const uint32_t shift = (w >> pb) & smask;
  if (right) {
    const uint32_t d = (uint32_t)s + shift;
    return d < (uint32_t)S ? d + 1u : 0u;
  }
  return shift <= (uint32_t)s ? (uint32_t)s - shift + 1u : 0u;
}

// Words j .. j + 3 of a row of S words, row + j on the 16-byte grid; 0 for
// what lies outside the row.
__device__ __forceinline__ void load4(const uint32_t* row, int j, int S,
                                      uint32_t (&q)[4]) {
  if (j >= 0 && j + 4 <= S) {
    const uint4 v = *reinterpret_cast<const uint4*>(row + j);
    q[0] = v.x, q[1] = v.y, q[2] = v.z, q[3] = v.w;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      q[k] = (j + k >= 0 && j + k < S) ? row[j + k] : 0u;
  }
}

// Words g .. g + 3 of an output row, row + g on the 16-byte grid, of which
// [lo, hi) are this block's to write.
__device__ __forceinline__ void store4(uint32_t* row, int g, int lo, int hi,
                                       const uint32_t (&q)[4]) {
  if (g >= lo && g + 4 <= hi) {
    *reinterpret_cast<uint4*>(row + g) = make_uint4(q[0], q[1], q[2], q[3]);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (g + k >= lo && g + k < hi) row[g + k] = q[k];
  }
}

// A pointer's distance from the 16-byte grid, in words.
__device__ __forceinline__ int off_grid(const void* p) {
  return (int)(((unsigned long long)p >> 2) & 3ull);
}

// The largest a and the largest b of the block, in every thread; two
// barriers.
__device__ __forceinline__ void block_max2(uint32_t& a, uint32_t& b,
                                           uint32_t (*red)[2]) {
  a = __reduce_max_sync(kFull, a);
  b = __reduce_max_sync(kFull, b);
  if ((threadIdx.x & 31) == 0) {
    red[threadIdx.x >> 5][0] = a;
    red[threadIdx.x >> 5][1] = b;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kShiftThreads / 32; ++k)
    a = max(a, red[k][0]), b = max(b, red[k][1]);
  __syncthreads();
}

template <int VEC>
__global__ void __launch_bounds__(kShiftThreads)
logshift_tile_kernel(const uint32_t* __restrict__ word,
                     uint32_t* __restrict__ out, int S, int pb, int nbits,
                     int right, int tiles) {
  constexpr int T = 4 * VEC * kShiftThreads;  // source slots of a tile
  constexpr int W = 2 * T;                    // words of the stage
  __shared__ __align__(16) uint32_t stage[W];
  __shared__ uint32_t red[kShiftThreads / 32][2];
  const int x = threadIdx.x;
  const long long row = blockIdx.x / (unsigned)tiles;
  const int tile = (int)(blockIdx.x - row * tiles);
  const uint32_t* src = word + row * S;
  uint32_t* dst = out + row * S;
  const uint32_t smask = (1u << nbits) - 1u, pmask = (1u << pb) - 1u;
  const int t0 = tile * T - off_grid(src);  // the tile's first slot

  // the tile, the 256 slots before it, and meanwhile a zeroed stage
  uint32_t q[VEC][4], d[VEC][4];
#pragma unroll
  for (int v = 0; v < VEC; ++v)
    load4(src, t0 + 4 * (v * kShiftThreads + x), S, q[v]);
  int end = t0 - kShiftThreads;  // the look-back has come down to here
  const uint32_t before = (end + x >= 0 && end + x < S) ? src[end + x] : 0u;
  for (int i = x; 4 * i < W; i += kShiftThreads)
    reinterpret_cast<uint4*>(stage)[i] = make_uint4(0u, 0u, 0u, 0u);
  uint32_t mine = 0u;
#pragma unroll
  for (int v = 0; v < VEC; ++v)
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      d[v][k] = dest1(q[v][k], t0 + 4 * (v * kShiftThreads + x) + k, S, pb,
                      smask, right);
      mine = max(mine, d[v][k]);
    }
  uint32_t seen = dest1(before, end + x, S, pb, smask, right);
  block_max2(mine, seen, red);
  // [lo, hi): from one past the last destination before the tile to one
  // past the tile's last destination
  const int hi = tile == tiles - 1 ? S : (int)mine;
  if (hi == 0) return;  // no live word: the range is empty
  while (seen == 0u && end > 0) {  // block-uniform
    end -= 4 * kShiftThreads;
    uint32_t p[4], none = 0u;
    load4(src, end + 4 * x, S, p);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      seen = max(seen, dest1(p[k], end + 4 * x + k, S, pb, smask, right));
    block_max2(seen, none, red);
  }
  const int lo = (int)seen;

  const int mo = off_grid(dst);
  bool zeroed = true;
  for (int w0 = ((lo + mo) & ~3) - mo; w0 < hi; w0 += W) {
    const int wn = hi - w0 < W ? hi - w0 : W;  // words of this round
    if (!zeroed) {
      __syncthreads();  // the round before has left the stage
      for (int i = x; 4 * i < wn; i += kShiftThreads)
        reinterpret_cast<uint4*>(stage)[i] = make_uint4(0u, 0u, 0u, 0u);
      __syncthreads();
    }
    zeroed = false;
#pragma unroll
    for (int v = 0; v < VEC; ++v)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int at = (int)d[v][k] - 1 - w0;
        if (d[v][k] && at >= 0 && at < wn) stage[at] = q[v][k] & pmask;
      }
    __syncthreads();
    for (int i = x; 4 * i < wn; i += kShiftThreads) {
      const uint4 v = reinterpret_cast<const uint4*>(stage)[i];
      const uint32_t o[4] = {v.x, v.y, v.z, v.w};
      store4(dst, w0 + 4 * i, lo, hi, o);
    }
  }
}

template <typename P>
__global__ void __launch_bounds__(kRowThreads)
logshift_row_kernel(const uint32_t* __restrict__ word,
                    uint32_t* __restrict__ out, int S, int pb, int nbits,
                    int right) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  P* stage = reinterpret_cast<P*>(smem_raw);  // S payloads, padded to 16 bytes
  const int x = threadIdx.x;
  const uint32_t* src = word + (long long)blockIdx.x * S;
  uint32_t* dst = out + (long long)blockIdx.x * S;
  const uint32_t smask = (1u << nbits) - 1u, pmask = (1u << pb) - 1u;
  const int vecs = (int)(((long long)S * sizeof(P) + 15) / 16);
  for (int i = x; i < vecs; i += kRowThreads)
    reinterpret_cast<uint4*>(smem_raw)[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  for (int j = 4 * x - off_grid(src); j < S; j += 4 * kRowThreads) {
    uint32_t q[4];
    load4(src, j, S, q);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint32_t at = dest1(q[k], j + k, S, pb, smask, right);
      if (at) stage[at - 1u] = (P)(q[k] & pmask);
    }
  }
  __syncthreads();
  for (int g = 4 * x - off_grid(dst); g < S; g += 4 * kRowThreads) {
    uint32_t o[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      o[k] = (g + k >= 0 && g + k < S) ? (uint32_t)stage[g + k] : 0u;
    store4(dst, g, 0, S, o);
  }
}

// ---------------------------------------------------------------------------
// pair_compact (tt_pair_compact_or): replaces _pair_compact_kernel
// (fp_pallas.py:323).
//
// A live carrier is disp << 1 | 1 (bit 0 clear: dead); its payload goes to
// slot s - disp of its row, and payloads that meet are ORed. A carrier with
// disp >> nbits != 0 is out of the network's reach, one with disp > s would
// pass slot 0: both are dropped. Every other output word is 0. The caller's
// destinations never fall as the slot rises over live carriers, and a run
// of equal ones can hold several live carriers with dead ones between.
//
// Bound on the H100: device-memory bytes, 12 a slot (carrier and payload
// read, the word written): 0.030 ms at (2048, 4096). The kernel before this
// one zeroed the output with a memset, then ORed each payload into device
// memory with an atomic (a read-modify-write in L2): each output word written
// twice (0.0655 ms, 46% of the bound). Here every output word is written
// once, by the kernel, in full sectors, and nothing per slot costs more than
// a few instructions (the row comes from the block index). The design
// (pair_tile_kernel) is logshift_tile_kernel's, with ORs into the stage: a
// block takes a tile of 2048 source slots on the carrier row's 16-byte grid
// (the payload word by word where its row lies on another grid) and owns the
// output from one past the last destination before it, found by a
// look-back, to its own last destination; it zeroes its stage, ORs the
// payloads in with shared-memory atomics and writes the range once. One
// thing is new: a run of equal destinations can cross a tile's end. The tile
// that owns that word reads on past its end while live carriers land on it,
// until one lands further on or the row ends, and ORs their payloads in; to
// the tile the run crosses into, the word lies below its range, so it leaves
// it alone. A block per row with the whole row staged (rows up to 58112
// slots) took the same time at (2048, 4096) on an H100 80GB HBM3 at 700 W
// (0.0375 against 0.0376 ms), and the tiles take rows of any length, so
// they are the only kernel.
// ---------------------------------------------------------------------------

// Destination + 1 of the carrier c at slot s of its row; 0 for a dead
// carrier and for one that is dropped.
__device__ __forceinline__ uint32_t pair_dest1(uint32_t c, int s, int nbits) {
  if (!(c & 1u)) return 0u;
  const uint32_t disp = c >> 1;
  if ((unsigned long long)disp >> nbits) return 0u;  // out of reach
  return disp <= (uint32_t)s ? (uint32_t)s - disp + 1u : 0u;
}

// load4 of a row that may lie on another 16-byte grid than j (vec false):
// then word by word.
__device__ __forceinline__ void load4_as(const uint32_t* row, int j, int S,
                                         bool vec, uint32_t (&q)[4]) {
  if (vec) {
    load4(row, j, S, q);
    return;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k)
    q[k] = (j + k >= 0 && j + k < S) ? row[j + k] : 0u;
}

template <int VEC>
__global__ void __launch_bounds__(kShiftThreads)
pair_tile_kernel(const uint32_t* __restrict__ carrier,
                 const uint32_t* __restrict__ payload,
                 uint32_t* __restrict__ out, int S, int nbits, int tiles) {
  constexpr int T = 4 * VEC * kShiftThreads;  // source slots of a tile
  constexpr int W = 2 * T;                    // words of the stage
  __shared__ __align__(16) uint32_t stage[W];
  __shared__ uint32_t red[kShiftThreads / 32][2];
  __shared__ uint32_t ahead;  // payloads past the tile that land on its last
  const int x = threadIdx.x;
  const long long row = blockIdx.x / (unsigned)tiles;
  const int tile = (int)(blockIdx.x - row * tiles);
  const uint32_t* cr = carrier + row * S;
  const uint32_t* pr = payload + row * S;
  uint32_t* dst = out + row * S;
  const bool vec = off_grid(pr) == off_grid(cr);
  const int t0 = tile * T - off_grid(cr);  // the tile's first slot

  // the tile, the 256 slots before it, and meanwhile a zeroed stage
  uint32_t c[VEC][4], p[VEC][4], d[VEC][4];
#pragma unroll
  for (int v = 0; v < VEC; ++v) {
    const int j = t0 + 4 * (v * kShiftThreads + x);
    load4(cr, j, S, c[v]);
    load4_as(pr, j, S, vec, p[v]);
  }
  int end = t0 - kShiftThreads;  // the look-back has come down to here
  const uint32_t before = (end + x >= 0 && end + x < S) ? cr[end + x] : 0u;
  for (int i = x; 4 * i < W; i += kShiftThreads)
    reinterpret_cast<uint4*>(stage)[i] = make_uint4(0u, 0u, 0u, 0u);
  if (x == 0) ahead = 0u;
  uint32_t mine = 0u;
#pragma unroll
  for (int v = 0; v < VEC; ++v)
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int s = t0 + 4 * (v * kShiftThreads + x) + k;
      d[v][k] = pair_dest1(c[v][k], s, nbits);
      mine = max(mine, d[v][k]);
    }
  uint32_t seen = pair_dest1(before, end + x, nbits);
  block_max2(mine, seen, red);
  const bool last_tile = tile == tiles - 1;
  const int hi = last_tile ? S : (int)mine;
  if (hi == 0) return;  // no live carrier: the range is empty
  while (seen == 0u && end > 0) {  // block-uniform
    end -= 4 * kShiftThreads;
    uint32_t q[4], none = 0u;
    load4(cr, end + 4 * x, S, q);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      seen = max(seen, pair_dest1(q[k], end + 4 * x + k, nbits));
    block_max2(seen, none, red);
  }
  const int lo = (int)seen;

  if (!last_tile && hi > lo) {  // the tile owns word hi - 1: look ahead
    uint32_t acc = 0u;
    for (int j = t0 + T; j < S; j += 4 * kShiftThreads) {  // block-uniform
      uint32_t q[4], further = 0u, none = 0u;
      load4(cr, j + 4 * x, S, q);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const uint32_t e = pair_dest1(q[k], j + 4 * x + k, nbits);
        if (e == (uint32_t)hi) acc |= pr[j + 4 * x + k];
        further = max(further, (uint32_t)(e > (uint32_t)hi));
      }
      block_max2(further, none, red);
      if (further) break;
    }
    acc = __reduce_or_sync(kFull, acc);
    if ((x & 31) == 0 && acc) atomicOr(&ahead, acc);
    __syncthreads();
  }

  const int mo = off_grid(dst);
  bool zeroed = true;
  for (int w0 = ((lo + mo) & ~3) - mo; w0 < hi; w0 += W) {
    const int wn = hi - w0 < W ? hi - w0 : W;  // words of this round
    if (!zeroed) {
      __syncthreads();  // the round before has left the stage
      for (int i = x; 4 * i < wn; i += kShiftThreads)
        reinterpret_cast<uint4*>(stage)[i] = make_uint4(0u, 0u, 0u, 0u);
      __syncthreads();
    }
    zeroed = false;
#pragma unroll
    for (int v = 0; v < VEC; ++v)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int at = (int)d[v][k] - 1 - w0;
        if (d[v][k] && p[v][k] && at >= 0 && at < wn)
          atomicOr(stage + at, p[v][k]);
      }
    if (x == 0 && ahead && hi - 1 - w0 < wn)
      atomicOr(stage + (hi - 1 - w0), ahead);
    __syncthreads();
    for (int i = x; 4 * i < wn; i += kShiftThreads) {
      const uint4 v = reinterpret_cast<const uint4*>(stage)[i];
      const uint32_t o[4] = {v.x, v.y, v.z, v.w};
      store4(dst, w0 + 4 * i, lo, hi, o);
    }
  }
}

int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms > 0 ? sms : 1;
}

// Chunk warps per block for a kernel whose warp holds `per_warp` bytes of
// tables: as many as fit 48 KB, 1 to 8, opting the kernel into more shared
// memory when one warp needs it. Returns a CUDA error code.
template <typename K>
int warps_per_block(K* kernel, long long per_warp, int* warps,
                    long long* smem) {
  if (per_warp > kMaxSmem) return (int)cudaErrorInvalidValue;
  int w = (int)(kDefaultSmem / per_warp);
  w = w < 1 ? 1 : (w > 8 ? 8 : w);
  *warps = w;
  *smem = per_warp * w;
  if (*smem > kDefaultSmem)
    return (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
  return 0;
}

template <typename W>
int launch_predict(const void* values, void* xor1, void* xor2, int C, int L,
                   int e1, int e2, void* stream) {
  constexpr int D = kPredictDepth;
  int warps;
  long long smem;
  const int rc = warps_per_block(
      predict_kernel<W, D>, ((1ll << e1) + (1ll << e2)) * (long long)sizeof(W),
      &warps, &smem);
  if (rc) return rc;
  const int blocks = (C + warps - 1) / warps;
  predict_kernel<W, D><<<blocks, 32 * warps, smem, (cudaStream_t)stream>>>(
      (const W*)values, (W*)xor1, (W*)xor2, C, L, e1, e2);
  return (int)cudaGetLastError();
}

// Tiles of T source slots that each row of S words takes, the first row at
// `first`: rows off the 16-byte grid start up to 3 slots into their first
// tile (every row lies on the grid when the first does and S % 4 == 0).
int tiles_per_row(const void* first, int S, int T) {
  const bool on_grid = ((unsigned long long)first & 15ull) == 0 && S % 4 == 0;
  return (int)(((long long)S + (on_grid ? 0 : 3) + T - 1) / T);
}

int launch_logshift_tiles(const void* word, void* out, long long C, int S,
                          int pb, int nbits, int right, void* stream) {
  constexpr int T = 4 * kShiftVec * kShiftThreads;
  const int tiles = tiles_per_row(word, S, T);
  if (C * tiles > 0x7fffffffll) return (int)cudaErrorInvalidValue;
  logshift_tile_kernel<kShiftVec>
      <<<(unsigned)(C * tiles), kShiftThreads, 0, (cudaStream_t)stream>>>(
          (const uint32_t*)word, (uint32_t*)out, S, pb, nbits, right, tiles);
  return (int)cudaGetLastError();
}

template <typename P>
int launch_logshift_rows(const void* word, void* out, long long C, int S,
                         int pb, int nbits, int right, void* stream) {
  const long long smem = ((long long)S * (long long)sizeof(P) + 15) / 16 * 16;
  if (smem > kMaxSmem || C > 0x7fffffffll) return (int)cudaErrorInvalidValue;
  if (smem > kDefaultSmem) {
    cudaError_t e = cudaFuncSetAttribute(
        logshift_row_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  logshift_row_kernel<P>
      <<<(unsigned)C, kRowThreads, smem, (cudaStream_t)stream>>>(
          (const uint32_t*)word, (uint32_t*)out, S, pb, nbits, right);
  return (int)cudaGetLastError();
}

int launch_pair_tiles(const void* carrier, const void* payload, void* out,
                      long long C, int S, int nbits, void* stream) {
  constexpr int T = 4 * kShiftVec * kShiftThreads;
  const int tiles = tiles_per_row(carrier, S, T);
  if (C * tiles > 0x7fffffffll) return (int)cudaErrorInvalidValue;
  pair_tile_kernel<kShiftVec>
      <<<(unsigned)(C * tiles), kShiftThreads, 0, (cudaStream_t)stream>>>(
          (const uint32_t*)carrier, (const uint32_t*)payload, (uint32_t*)out,
          S, nbits, tiles);
  return (int)cudaGetLastError();
}

// Chunks per block (G) and values per tile (T) of a replay launch; 0 =
// choose. G: about one walking warp for each of the card's 4 * SMs warp
// schedulers, so that a step's instructions never queue behind another
// warp's, a power of two in 1..32, fewer when the tables leave no room.
// T: 256 values, halved while the blocks of one SM's share do not fit its
// shared memory together (every chunk is resident at once), or L is less.
template <typename W>
int launch_replay(const void* bcodes, const void* xors, void* out, int C,
                  int L, int e1, int e2, int G, int T, void* stream) {
  if (G < 0 || G > 32 || T < 0 || (T & 15)) return (int)cudaErrorInvalidValue;
  const bool auto_g = G == 0, auto_t = T == 0;
  const int sms = sm_count();
  if (auto_g) {
    G = 1;
    while (G < 32 && (long long)C > 4ll * sms * G) G *= 2;
  }
  if (auto_t) {
    T = 256;
    while (T >= 2 * L && T > 16) T /= 2;
  }
  for (;;) {
    const long long need = ReplayLayout<W>(e1, e2, T).total(G);
    const long long blocks = ((long long)C + G - 1) / G;
    const long long per_sm = (blocks + sms - 1) / sms;
    // an SM's 228 KB, less the 1 KB the system keeps for each block
    const long long share = kSmSmem / (per_sm > 32 ? 32 : per_sm) - 1024;
    if (need <= kMaxSmem && (need <= share || !auto_t || T <= 64)) break;
    if (auto_t && T > 32) T /= 2;
    else if (auto_g && G > 1) G /= 2;
    else return (int)cudaErrorInvalidValue;
  }
  const long long smem = ReplayLayout<W>(e1, e2, T).total(G);
  const bool zero = e1 == 0 || e2 == 0;
  auto kernel = zero ? replay_kernel<W, true> : replay_kernel<W, false>;
  if (smem > kDefaultSmem) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (C + G - 1) / G;
  kernel<<<blocks, 64, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)bcodes, (const W*)xors, (W*)out, C, L, e1, e2, G, T);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// sort_predict_kernel<uint32_t, K, S> (tt_predict_sort_xors) and
// sort_predict_kernel<uint64_t, K, S> (tt_predict64_sort_xors): the
// predictor of predict_kernel for tables that no block holds, (14,18) of the
// f32 adaptive set and the f64 (20,20) default among them. No Pallas kernel
// has this route: the JAX package computes the same words with two XLA sorts
// (fp_jax._predict_sort, fp_jax.py:286; fp64_jax._predict_sort64,
// fp64_jax.py:61), as the plain versions do with torch.sort.
//
// A table read at position i is "the payload of the latest j < i with the
// same key, else 0" (see predict_kernel), so no table is needed: sort the
// composites key << pb | i of a chunk, and each sorted entry whose
// predecessor has its key takes the predecessor's position as its j. One
// block per chunk. The composites of both tables (FCM keys, then DFCM keys,
// N each: L rounded up to a power of two, at least kSortTile; the pad, all
// ones, sorts last) go through one bitonic network; each position's j lands
// in `prev`, and a last coalesced pass reads the payloads (the value for
// FCM, the stride for DFCM) from the row and writes both xors in position
// order. Composites are u32 where the larger exponent plus pb is at most 32
// (fp_jax.py:261's rule, with pb at least 8), u64 otherwise.
//
// Bound on the H100: device-memory bytes, as predict_kernel (0.030 ms for
// (2048, 4096) u32 words, 0.120 ms for (4096, 4096) u64 words). The network
// has pb (pb + 1) / 2 compare-exchange stages over 2N composites, 78 at
// L = 4096, so its instructions, not the bytes, set the time. The design
// keeps them few and out of shared memory: a warp holds a tile of kSortTile
// composites in registers, kSortE a lane in the order q * 32 + lane, so
// strides below 32 are shuffles, strides 32..128 compare two registers of
// one lane, and only strides of kSortTile and more go through the buffer
// (10 of the 78 stages at L = 4096), each pair by one thread. Each level
// starts by comparing every element with its mirror, so every stage sorts
// upwards: an element's role in a stage is fixed at compile time for a
// register stage and by its lane for a shuffle. The row, the
// composites and `prev` are staged in shared memory where they fit one
// block (kStaged; up to L = 8192 for u32 words with u32 composites);
// otherwise the composites and `prev` live in a global scratch buffer that
// the wrapper allocates, the row is read where it lies, and at most
// kSortGrid blocks walk the chunks: slower, but the same network.
// ---------------------------------------------------------------------------
constexpr int kSortE = 8;               // composites a lane holds
constexpr int kSortTile = 32 * kSortE;  // composites a warp tile holds
constexpr int kSortThreads = 1024;
// blocks of the scratch form: two a streaming multiprocessor fill the card,
// and the scratch buffer grows with them
constexpr int kSortGrid = 256;
constexpr int kSortMaxPb = 28;   // rows of at most 2^28 values

template <typename K>
__device__ __forceinline__ K kmin(K a, K b) {
  return a < b ? a : b;
}
template <typename K>
__device__ __forceinline__ K kmax(K a, K b) {
  return a < b ? b : a;
}

// One stage of the network inside a warp tile: element i meets element
// i ^ M, and the lower of the two keeps the smaller composite. M is a
// stride j (a half-cleaner) or 2j - 1 (the first stage of merge level 2j,
// which compares each element with its mirror, so that every stage sorts
// upwards and no element needs a direction). Element q of a lane has index
// 32 q + lane in its tile: the bits of M below 32 pick the partner lane (a
// shuffle), those above the partner register.
template <int M, typename K>
__device__ __forceinline__ void sort_tile_stage(K (&x)[kSortE], int lane) {
  constexpr int ML = M & 31, MQ = M >> 5;
  constexpr int HB = M >= 128 ? 128 : M >= 64 ? 64 : M >= 32 ? 32
                   : M >= 16 ? 16 : M >= 8 ? 8 : M >= 4 ? 4 : M >= 2 ? 2 : 1;
  if constexpr (ML == 0) {  // registers q and q ^ MQ of one lane
#pragma unroll
    for (int q = 0; q < kSortE; ++q) {
      if (q & MQ) continue;
      const K lo = kmin(x[q], x[q ^ MQ]), hi = kmax(x[q], x[q ^ MQ]);
      x[q] = lo;
      x[q ^ MQ] = hi;
    }
  } else {
    K y[kSortE];
#pragma unroll
    for (int q = 0; q < kSortE; ++q)
      y[q] = __shfl_xor_sync(kFull, x[q ^ MQ], ML);
    const bool lane_lower = (lane & HB) == 0;
#pragma unroll
    for (int q = 0; q < kSortE; ++q) {
      const bool lower = HB < 32 ? lane_lower : ((32 * q) & HB) == 0;
      x[q] = lower ? kmin(x[q], y[q]) : kmax(x[q], y[q]);
    }
  }
}

// Half-cleaners at strides J, J / 2, ..., 1.
template <int J, typename K>
__device__ __forceinline__ void sort_half_cleaners(K (&x)[kSortE], int lane) {
  if constexpr (J >= 1) {
    sort_tile_stage<J>(x, lane);
    sort_half_cleaners<J / 2>(x, lane);
  }
}

// Merge levels L2, 2 L2, ..., kSortTile of a tile: it ends sorted.
template <int L2, typename K>
__device__ __forceinline__ void sort_tile_levels(K (&x)[kSortE], int lane) {
  if constexpr (L2 <= kSortTile) {
    sort_tile_stage<L2 - 1>(x, lane);  // the mirror
    sort_half_cleaners<L2 / 4>(x, lane);
    sort_tile_levels<2 * L2>(x, lane);
  }
}

// Every tile of the 2N composites, a warp per tile: sorted whole
// (kPresort), or the half-cleaners of strides below kSortTile that end a
// merge level.
template <bool kPresort, typename K>
__device__ __forceinline__ void sort_tile_pass(K* buf, int N) {
  const int lane = threadIdx.x & 31;
  const int tiles = 2 * N / kSortTile;
  for (int w = threadIdx.x >> 5; w < tiles; w += blockDim.x >> 5) {
    K* p = buf + (long long)w * kSortTile + lane;  // warp-uniform loop
    K x[kSortE];
#pragma unroll
    for (int q = 0; q < kSortE; ++q) x[q] = p[32 * q];
    if constexpr (kPresort)
      sort_tile_levels<2>(x, lane);
    else
      sort_half_cleaners<kSortTile / 2>(x, lane);
#pragma unroll
    for (int q = 0; q < kSortE; ++q) p[32 * q] = x[q];
  }
}

// One stage at stride j >= kSortTile over the buffer, both tables, one
// thread a pair: the mirror of merge level 2j (i and i ^ (2j - 1)) or a
// half-cleaner (i and i + j); the lower index keeps the smaller.
template <typename K>
__device__ __forceinline__ void sort_buffer_stage(K* buf, int N, int j,
                                                  bool mirror) {
  const int half = N >> 1;  // pairs of one table
  for (int p = threadIdx.x; p < N; p += blockDim.x) {
    const int t = p >= half;
    const int q = p - t * half;
    const int i = ((q & ~(j - 1)) << 1) | (q & (j - 1));
    K* row = buf + (long long)t * N;
    const int o = mirror ? i ^ (2 * j - 1) : i + j;
    const K a = row[i], b = row[o];
    if (a > b) {
      row[i] = b;
      row[o] = a;
    }
  }
}

// The stride at position j of a row (its value less the one before).
template <typename W>
__device__ __forceinline__ W stride_at(const W* v, int j) {
  return v[j] - (j ? v[j - 1] : W(0));
}

template <typename W, typename K, bool kStaged>
__global__ void __launch_bounds__(kSortThreads)
    sort_predict_kernel(const W* __restrict__ values, W* __restrict__ xor1,
                        W* __restrict__ xor2, int C, int L, int e1, int e2,
                        int pb, unsigned char* __restrict__ scratch,
                        long long scratch_stride) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int N = 1 << pb;
  const int T = blockDim.x;
  const uint32_t m2 = (uint32_t)((1ull << e2) - 1);
  const int sh2 = e2 >> 1;
  for (long long c = blockIdx.x; c < C; c += gridDim.x) {
    const W* row = values + c * L;
    K* buf;
    int* prev;
    const W* v;
    if constexpr (kStaged) {
      buf = reinterpret_cast<K*>(smem_raw);
      W* sv = reinterpret_cast<W*>(smem_raw + 2ll * N * sizeof(K));
      prev = reinterpret_cast<int*>(
          smem_raw + 2ll * N * sizeof(K) +
          ((long long)L * sizeof(W) + 15) / 16 * 16);
      for (int i = threadIdx.x; i < L; i += T) sv[i] = row[i];
      __syncthreads();
      v = sv;
    } else {
      buf = reinterpret_cast<K*>(scratch + blockIdx.x * scratch_stride);
      prev = reinterpret_cast<int*>(buf + 2ll * N);
      v = row;
    }
    // composites: FCM key top_e1(v[i-1]), DFCM key t[i-1] ^ ((t[i-2] <<
    // e2/2) & m2) with t the top e2 bits of the stride; 0 before the row
    for (int g = threadIdx.x; g < 2 * N; g += T) {
      const int i = g & (N - 1);
      K comp = ~K(0);
      if (i < L) {
        uint32_t key = 0u;
        if (g < N) {
          key = i ? top_bits(v[i - 1], e1) : 0u;
        } else if (e2 && i) {
          const uint32_t t1 = top_bits(stride_at(v, i - 1), e2);
          const uint32_t t2 = i >= 2 ? top_bits(stride_at(v, i - 2), e2) : 0u;
          key = t1 ^ ((t2 << sh2) & m2);
        }
        comp = (K(key) << pb) | K(i);
      }
      buf[g] = comp;
    }
    __syncthreads();
    sort_tile_pass<true>(buf, N);
    __syncthreads();
    for (int k = 2 * kSortTile; k <= N; k <<= 1) {
      for (int j = k >> 1; j >= kSortTile; j >>= 1) {
        sort_buffer_stage(buf, N, j, j == k >> 1);
        __syncthreads();
      }
      sort_tile_pass<false>(buf, N);
      __syncthreads();
    }
    // the real composites are the first L of each table, in (key, i) order
    const K low = K(N - 1);
    for (int g = threadIdx.x; g < 2 * N; g += T) {
      const int r = g & (N - 1);
      if (r >= L) continue;
      const K cur = buf[g];
      int j = -1;
      if (r) {
        const K before = buf[g - 1];
        if ((before >> pb) == (cur >> pb)) j = (int)(before & low);
      }
      prev[(g < N ? 0 : L) + (int)(cur & low)] = j;
    }
    __syncthreads();
    W* x1 = xor1 + c * L;
    W* x2 = xor2 + c * L;
    for (int i = threadIdx.x; i < L; i += T) {
      const W x = v[i];
      const W xp = i ? v[i - 1] : W(0);
      const int j1 = prev[i], j2 = prev[L + i];
      x1[i] = x ^ (j1 >= 0 ? v[j1] : W(0));
      x2[i] = x ^ (xp + (j2 >= 0 ? stride_at(v, j2) : W(0)));
    }
    __syncthreads();  // the next chunk reuses the buffers
  }
}

// How a sort_predict launch runs (C, L, exponents and word width given).
struct SortPlan {
  int pb;       // log2 N
  bool wide;    // u64 composites
  bool staged;  // everything in shared memory
  int threads, blocks;
  long long smem, scratch_stride, scratch;
};

bool sort_plan(int C, int L, int e1, int e2, int word_bytes, SortPlan* p) {
  if (C < 1 || L < 1 || e1 < 0 || e1 > 30 || e2 < 0 || e2 > 30) return false;
  int pb = 8;  // N >= kSortTile
  while ((1ll << pb) < L) ++pb;
  if (pb > kSortMaxPb) return false;
  const long long N = 1ll << pb;
  p->pb = pb;
  p->wide = (e1 > e2 ? e1 : e2) + pb > 32;
  const long long keys = 2 * N * (p->wide ? 8 : 4);  // a multiple of 16
  const long long prev = 2ll * L * 4;
  const long long row = ((long long)L * word_bytes + 15) / 16 * 16;
  p->staged = keys + row + prev <= kMaxSmem;
  p->threads = (int)(2 * N / kSortE < kSortThreads ? 2 * N / kSortE
                                                    : kSortThreads);
  p->smem = p->staged ? keys + row + prev : 0;
  p->blocks = p->staged ? C : (C < kSortGrid ? C : kSortGrid);
  p->scratch_stride = p->staged ? 0 : keys + (prev + 15) / 16 * 16;
  p->scratch = p->scratch_stride * p->blocks;
  return true;
}

template <typename W, typename K>
int launch_sort_predict_k(const SortPlan& p, const void* values, void* xor1,
                          void* xor2, int C, int L, int e1, int e2,
                          void* scratch, void* stream) {
  if (p.staged) {
    auto kernel = sort_predict_kernel<W, K, true>;
    if (p.smem > kDefaultSmem) {
      cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
      if (e != cudaSuccess) return (int)e;
    }
    kernel<<<p.blocks, p.threads, p.smem, (cudaStream_t)stream>>>(
        (const W*)values, (W*)xor1, (W*)xor2, C, L, e1, e2, p.pb, nullptr, 0);
  } else {
    sort_predict_kernel<W, K, false>
        <<<p.blocks, p.threads, 0, (cudaStream_t)stream>>>(
            (const W*)values, (W*)xor1, (W*)xor2, C, L, e1, e2, p.pb,
            (unsigned char*)scratch, p.scratch_stride);
  }
  return (int)cudaGetLastError();
}

template <typename W>
int launch_sort_predict(const void* values, void* xor1, void* xor2, int C,
                        int L, int e1, int e2, void* scratch,
                        long long scratch_bytes, void* stream) {
  SortPlan p;
  if (!sort_plan(C, L, e1, e2, (int)sizeof(W), &p) ||
      p.scratch > scratch_bytes || (p.scratch && !scratch))
    return (int)cudaErrorInvalidValue;
  return p.wide ? launch_sort_predict_k<W, uint64_t>(p, values, xor1, xor2, C,
                                                     L, e1, e2, scratch, stream)
                : launch_sort_predict_k<W, uint32_t>(p, values, xor1, xor2, C,
                                                     L, e1, e2, scratch, stream);
}

}  // namespace

extern "C" {

// values, xor1, xor2: (C, L) u32. Exponents normalised (even, <= 30).
int tt_predict_xors(const void* values, void* xor1, void* xor2, int C, int L,
                    int e1, int e2, void* stream) {
  return launch_predict<uint32_t>(values, xor1, xor2, C, L, e1, e2, stream);
}

// values, xor1, xor2: (C, L) u64; the rest as tt_predict_xors.
int tt_predict64_xors(const void* values, void* xor1, void* xor2, int C,
                      int L, int e1, int e2, void* stream) {
  return launch_predict<uint64_t>(values, xor1, xor2, C, L, e1, e2, stream);
}

// values: (C, L) u32; out: (K, C, L) u32; e1s: K exponents in 2..30.
int tt_fcm_multi_xors(const void* values, void* out, int C, int L, int K,
                      const int* e1s, void* stream) {
  if (K < 1 || K > kMaxFcm) return (int)cudaErrorInvalidValue;
  unsigned long long exps = 0;  // five bits an exponent
  long long words = 0;
  for (int q = 0; q < K; ++q) {
    if (e1s[q] < 2 || e1s[q] > 30) return (int)cudaErrorInvalidValue;
    exps |= (unsigned long long)e1s[q] << (5 * q);
    words += 1ll << e1s[q];
  }
  int warps;
  long long smem;
  const int rc = warps_per_block(fcm_multi_kernel<kFcmDepth>, words * 4,
                                 &warps, &smem);
  if (rc) return rc;
  const int blocks = (C + warps - 1) / warps;
  fcm_multi_kernel<kFcmDepth>
      <<<blocks, 32 * warps, smem, (cudaStream_t)stream>>>(
          (const uint32_t*)values, (uint32_t*)out, C, L, K, exps, (int)words);
  return (int)cudaGetLastError();
}

// bcodes: (C, L) u8; xors, out: (C, L) u32. Exponents normalised. G chunks
// per block (1..32) and tiles of T values (a multiple of 16) are chosen here
// when 0; a measurement may name them.
int tt_replay(const void* bcodes, const void* xors, void* out, int C, int L,
              int e1, int e2, int G, int T, void* stream) {
  return launch_replay<uint32_t>(bcodes, xors, out, C, L, e1, e2, G, T,
                                 stream);
}

// bcodes: (C, L) u8; xors, out: (C, L) u64; the rest as tt_replay.
int tt_replay64(const void* bcodes, const void* xors, void* out, int C, int L,
                int e1, int e2, int G, int T, void* stream) {
  return launch_replay<uint64_t>(bcodes, xors, out, C, L, e1, e2, G, T,
                                 stream);
}

// word, out: (C, S) u32; pb >= 1, pb + nbits <= 32, S <= 2^30. A right
// expansion whose row fits the stage goes to a block per row, everything
// else to the tiles.
int tt_logshift(const void* word, void* out, long long C, int S, int pb,
                int nbits, int right, void* stream) {
  if (S < 1 || S > kMaxSlots || pb < 1 || nbits < 1 || pb + nbits > 32)
    return (int)cudaErrorInvalidValue;
  const bool wide = (long long)S * 4 <= kMaxSmem;  // u32 payloads fit
  const bool narrow = pb <= 16 && (long long)S * 2 <= kMaxSmem;
  const bool rows = kShiftKernel ? kShiftKernel < 0 : right != 0;
  if (rows && wide)
    return launch_logshift_rows<uint32_t>(word, out, C, S, pb, nbits, right,
                                          stream);
  if (rows && narrow)
    return launch_logshift_rows<uint16_t>(word, out, C, S, pb, nbits, right,
                                          stream);
  return launch_logshift_tiles(word, out, C, S, pb, nbits, right, stream);
}

// Bytes of device scratch that a sort_predict launch of (C, L) words of
// `word_bytes` bytes needs (0 where everything fits shared memory), or -1
// for arguments no launch takes. Exponents normalised.
long long tt_predict_sort_scratch(int C, int L, int e1, int e2,
                                  int word_bytes) {
  SortPlan p;
  if ((word_bytes != 4 && word_bytes != 8) ||
      !sort_plan(C, L, e1, e2, word_bytes, &p))
    return -1;
  return p.scratch;
}

// values, xor1, xor2: (C, L) u32; scratch: tt_predict_sort_scratch bytes
// (4-byte words) of device memory. Exponents normalised.
int tt_predict_sort_xors(const void* values, void* xor1, void* xor2, int C,
                         int L, int e1, int e2, void* scratch,
                         long long scratch_bytes, void* stream) {
  return launch_sort_predict<uint32_t>(values, xor1, xor2, C, L, e1, e2,
                                       scratch, scratch_bytes, stream);
}

// values, xor1, xor2: (C, L) u64; the rest as tt_predict_sort_xors, with
// 8-byte words.
int tt_predict64_sort_xors(const void* values, void* xor1, void* xor2, int C,
                           int L, int e1, int e2, void* scratch,
                           long long scratch_bytes, void* stream) {
  return launch_sort_predict<uint64_t>(values, xor1, xor2, C, L, e1, e2,
                                       scratch, scratch_bytes, stream);
}

// carrier, payload, out: (C, S) u32; S <= 2^30.
int tt_pair_compact_or(const void* carrier, const void* payload, void* out,
                       long long C, int S, int nbits, void* stream) {
  if (S < 1 || S > kMaxSlots || nbits < 0) return (int)cudaErrorInvalidValue;
  nbits = nbits < 32 ? nbits : 32;  // a displacement has 31 bits
  return launch_pair_tiles(carrier, payload, out, C, S, nbits, stream);
}

}  // extern "C"
