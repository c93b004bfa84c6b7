// Hopper (sm_90a) kernels of the chunked FP codec (f32 and f64), v2 layout.
//
// Each kernel computes the same function as one or two Pallas TPU kernels of
// trico_tpu/codec/fp_pallas.py, bit for bit, but not with their block
// structure: the TPU kernels read tables by one-hot compare/select and move
// data through log-shift networks because the TPU has no fast gather or
// scatter; Hopper indexes shared memory directly and scatters to global
// memory, so those workarounds are gone. The TPU also has no 64-bit
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

// One warp's read of one hash table for a window of 32 positions, lane i
// holding position base + i: the payload of the latest lower lane with the
// same key, else the table as the window found it (0 for a dead lane).
// `group` returns the lanes that share this lane's key.
template <typename W>
__device__ __forceinline__ W window_read(const W* t, uint32_t key, W payload,
                                         int lane, bool active,
                                         unsigned& group) {
  group = __match_any_sync(kFull, key);
  const unsigned below = group & ((1u << lane) - 1u);
  const W w = __shfl_sync(kFull, payload, below ? 31 - __clz(below) : lane);
  return below ? w : (active ? t[key] : W(0));
}

// The matching write, after every lane has read (a __syncwarp between): the
// last lane of each key group stores its payload.
template <typename W>
__device__ __forceinline__ void window_write(W* t, uint32_t key, W payload,
                                             int lane, bool active,
                                             unsigned group) {
  if (active && (group >> lane) == 1u) t[key] = payload;
}

// ---------------------------------------------------------------------------
// predict_kernel<uint32_t> (tt_predict_xors): replaces _predict_window_kernel
// (fp_pallas.py:85) and _predict_kernel (fp_pallas.py:59).
// predict_kernel<uint64_t> (tt_predict64_xors): replaces
// _predict64_window_kernel (fp_pallas.py:493) and _predict64_kernel
// (fp_pallas.py:578).
//
// Encode has no value->prediction feedback: the FCM key of position i is
// top_e1(v[i-1]) and the DFCM key is t[i-1] ^ ((t[i-2] << e2/2) & m2) with
// t = top_e2(v - vprev), for f32 and f64 alike (the f64 keys read only the
// high word). So a table read at i is "payload of the latest j < i with the
// same key, else 0". One warp per chunk walks it 32 positions at a time
// (window_read / window_write).
//
// Bound on the H100: latency of the per-window shared-memory read and the
// shuffles; the bytes (1 word in, 2 out per value) are small. The design
// keeps the two tables of each chunk in shared memory (80 words at (4,6): 320
// bytes for f32, 640 for f64) and packs several chunk warps per block, so no
// table traffic reaches device memory and 32 positions resolve per step
// instead of one.
// ---------------------------------------------------------------------------
template <typename W>
__global__ void predict_kernel(const W* __restrict__ values,
                               W* __restrict__ xor1, W* __restrict__ xor2,
                               int C, int L, int e1, int e2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int T1 = 1 << e1, T2 = 1 << e2;
  const long long c = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
  if (c >= C) return;  // warp-uniform
  W* t1 = reinterpret_cast<W*>(smem_raw) + (size_t)warp * (T1 + T2);
  W* t2 = t1 + T1;
  for (int k = lane; k < T1 + T2; k += 32) t1[k] = W(0);
  __syncwarp();

  const W* row = values + c * L;
  W* x1 = xor1 + c * L;
  W* x2 = xor2 + c * L;
  const uint32_t m2 = (uint32_t)((1ull << e2) - 1);
  const int sh2 = e2 >> 1;
  W vprev_c = W(0);
  uint32_t tprev = 0u, tprev2 = 0u;  // carries, zero at i = 0

  for (int base = 0; base < L; base += 32) {
    const int i = base + lane;
    const bool active = i < L;
    const W v = active ? row[i] : W(0);
    const W up1 = __shfl_up_sync(kFull, v, 1);
    const W vprev = lane ? up1 : vprev_c;
    const W s = v - vprev;
    const uint32_t t = top_bits(s, e2);
    const uint32_t tu1 = __shfl_up_sync(kFull, t, 1);
    const uint32_t tu2 = __shfl_up_sync(kFull, t, 2);
    const uint32_t t_1 = lane >= 1 ? tu1 : tprev;
    const uint32_t t_2 = lane >= 2 ? tu2 : (lane == 1 ? tprev : tprev2);
    const uint32_t k1 = active ? top_bits(vprev, e1) : dead_key(lane);
    const uint32_t k2 =
        active ? (e2 ? (t_1 ^ ((t_2 << sh2) & m2)) : 0u) : dead_key(lane);
    unsigned g1, g2;
    const W pred1 = window_read(t1, k1, v, lane, active, g1);
    const W pred2 = window_read(t2, k2, s, lane, active, g2);
    if (active) {
      x1[i] = v ^ pred1;
      x2[i] = v ^ (vprev + pred2);
    }
    __syncwarp();  // every lane read the tables as of the window's start
    window_write(t1, k1, v, lane, active, g1);
    window_write(t2, k2, s, lane, active, g2);
    __syncwarp();
    vprev_c = __shfl_sync(kFull, v, 31);
    tprev2 = __shfl_sync(kFull, t, 30);
    tprev = __shfl_sync(kFull, t, 31);
  }
}

// ---------------------------------------------------------------------------
// fcm_multi_kernel (tt_fcm_multi_xors): replaces _fcm_multi_kernel
// (fp_pallas.py:150).
//
// The FCM half of predict_kernel<uint32_t> for K exponents at once: one warp
// per chunk reads each value once and resolves K tables (2^e1 words each)
// per window with the same window_read / window_write. Output q is plane q of
// a (K, C, L) array. Bound on the H100: as predict_kernel, shared-memory
// latency and shuffles, K times over; the tables stay in shared memory.
// ---------------------------------------------------------------------------
struct FcmExponents {
  int k;
  int e[kMaxFcm];
};

__global__ void fcm_multi_kernel(const uint32_t* __restrict__ values,
                                 uint32_t* __restrict__ out, int C, int L,
                                 FcmExponents ex, int words_per_warp) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long c = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
  if (c >= C) return;  // warp-uniform
  uint32_t* tables =
      reinterpret_cast<uint32_t*>(smem_raw) + (size_t)warp * words_per_warp;
  for (int k = lane; k < words_per_warp; k += 32) tables[k] = 0u;
  __syncwarp();

  const uint32_t* row = values + c * L;
  const long long plane = (long long)C * L;
  uint32_t vprev_c = 0u;
  for (int base = 0; base < L; base += 32) {
    const int i = base + lane;
    const bool active = i < L;
    const uint32_t v = active ? row[i] : 0u;
    const uint32_t up1 = __shfl_up_sync(kFull, v, 1);
    const uint32_t vprev = lane ? up1 : vprev_c;
    uint32_t* t = tables;
    for (int q = 0; q < ex.k; ++q) {
      const int e = ex.e[q];
      const uint32_t key = active ? top_bits(vprev, e) : dead_key(lane);
      unsigned g;
      const uint32_t pred = window_read(t, key, v, lane, active, g);
      if (active) out[q * plane + c * L + i] = v ^ pred;
      __syncwarp();  // every lane read table q as of the window's start
      window_write(t, key, v, lane, active, g);
      t += 1 << e;
    }
    __syncwarp();
    vprev_c = __shfl_sync(kFull, v, 31);
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
// logshift: replaces _logshift_kernel (fp_pallas.py:275).
//
// A word is shift << pb | payload (0 = dead). The network moves each live
// word by `shift` lanes, left or right, and the caller guarantees that the
// movement is monotone, so no two words share a destination. That is a
// direct scatter: one thread per slot writes its payload to s -/+ shift into
// an output zeroed first. Bound on the H100: device-memory bytes (one read,
// one memset, one scattered write of 4 bytes per slot); the ceil(log2 S)
// passes of the TPU network are gone.
// ---------------------------------------------------------------------------
__global__ void logshift_kernel(const uint32_t* __restrict__ word,
                                uint32_t* __restrict__ out, long long n, int S,
                                int pb, int nbits, int right) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const uint32_t w = word[idx];
  if (!w) return;
  const long long s = idx % S;
  const long long shift = (w >> pb) & ((1u << nbits) - 1u);
  const long long dest = right ? s + shift : s - shift;
  if (dest < 0 || dest >= S) return;  // moved past the edge: dropped
  out[idx - s + dest] = w & ((1u << pb) - 1u);
}

// ---------------------------------------------------------------------------
// pair_compact_or: replaces _pair_compact_kernel (fp_pallas.py:323).
//
// A live carrier is disp << 1 | 1; its payload ends at lane s - disp, and
// payloads that meet are ORed. OR is order-free, so one thread per lane
// doing atomicOr into an output zeroed first gives the network's result
// deterministically. Bound on the H100: device-memory bytes (two reads, one
// memset, one atomic per live nonzero payload); atomics to one word come
// only from the few lanes of one merge, so they do not serialise.
// ---------------------------------------------------------------------------
__global__ void pair_compact_kernel(const uint32_t* __restrict__ carrier,
                                    const uint32_t* __restrict__ payload,
                                    uint32_t* __restrict__ out, long long n,
                                    int S, int nbits) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const uint32_t c = carrier[idx];
  if (!(c & 1u)) return;
  const uint32_t disp = c >> 1;
  if ((unsigned long long)disp >> nbits) return;  // out of the network's reach
  const long long s = idx % S;
  if ((long long)disp > s) return;  // moved past lane 0: dropped
  const uint32_t p = payload[idx];
  if (p) atomicOr(out + (idx - s) + (s - disp), p);
}

int grid_1d(long long n, int threads) {
  return (int)((n + threads - 1) / threads);
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
  int warps;
  long long smem;
  const int rc = warps_per_block(
      predict_kernel<W>, ((1ll << e1) + (1ll << e2)) * (long long)sizeof(W),
      &warps, &smem);
  if (rc) return rc;
  const int blocks = (C + warps - 1) / warps;
  predict_kernel<W><<<blocks, 32 * warps, smem, (cudaStream_t)stream>>>(
      (const W*)values, (W*)xor1, (W*)xor2, C, L, e1, e2);
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

}  // namespace

extern "C" {

// values, xor1, xor2: (C, L) u32. Exponents normalised (even, <= 30).
int tt_predict_xors(const void* values, void* xor1, void* xor2, int C, int L,
                    int e1, int e2, void* stream) {
  return launch_predict<uint32_t>(values, xor1, xor2, C, L, e1, e2, stream);
}

// values, xor1, xor2: (C, L) u64. Exponents normalised (even, <= 30).
int tt_predict64_xors(const void* values, void* xor1, void* xor2, int C,
                      int L, int e1, int e2, void* stream) {
  return launch_predict<uint64_t>(values, xor1, xor2, C, L, e1, e2, stream);
}

// values: (C, L) u32; out: (K, C, L) u32; e1s: K exponents in 2..30.
int tt_fcm_multi_xors(const void* values, void* out, int C, int L, int K,
                      const int* e1s, void* stream) {
  if (K < 1 || K > kMaxFcm) return (int)cudaErrorInvalidValue;
  FcmExponents ex;
  ex.k = K;
  long long words = 0;
  for (int q = 0; q < kMaxFcm; ++q) {
    ex.e[q] = q < K ? e1s[q] : 0;
    if (q < K) {
      if (e1s[q] < 2 || e1s[q] > 30) return (int)cudaErrorInvalidValue;
      words += 1ll << e1s[q];
    }
  }
  int warps;
  long long smem;
  const int rc = warps_per_block(fcm_multi_kernel, words * 4, &warps, &smem);
  if (rc) return rc;
  const int blocks = (C + warps - 1) / warps;
  fcm_multi_kernel<<<blocks, 32 * warps, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)values, (uint32_t*)out, C, L, ex, (int)words);
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

// word, out: (C, S) u32; pb + ceil(log2 S) <= 32.
int tt_logshift(const void* word, void* out, long long C, int S, int pb,
                int nbits, int right, void* stream) {
  const long long n = C * S;
  cudaError_t e = cudaMemsetAsync(out, 0, n * 4, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  logshift_kernel<<<grid_1d(n, 256), 256, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)word, (uint32_t*)out, n, S, pb, nbits, right);
  return (int)cudaGetLastError();
}

// carrier, payload, out: (C, S) u32.
int tt_pair_compact_or(const void* carrier, const void* payload, void* out,
                       long long C, int S, int nbits, void* stream) {
  const long long n = C * S;
  cudaError_t e = cudaMemsetAsync(out, 0, n * 4, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  pair_compact_kernel<<<grid_1d(n, 256), 256, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)carrier, (const uint32_t*)payload, (uint32_t*)out, n, S,
      nbits);
  return (int)cudaGetLastError();
}

}  // extern "C"
