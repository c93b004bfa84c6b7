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
// sequential chain; one thread walks one chunk. A bcode above fcm_max (4 for
// f32, 8 for f64: the word's byte count) takes the DFCM prediction. Its two
// tables live in shared memory, interleaved across the block's threads (word
// idx of thread tid at idx * nt + tid) so that lanes reading the same idx hit
// distinct banks.
//
// Bound on the H100: the dependent chain of one shared-memory write, read and
// a few integer ops per value, with only C threads in flight (2048 f32 chunks
// or 4096 f64 chunks of 4096 values at the bench shapes, a fraction of one
// thread per core). The design keeps the chain out of device memory; the
// block width is chosen in launch_replay to spread the chunks over every SM.
// ---------------------------------------------------------------------------
template <typename W>
__global__ void replay_kernel(const uint8_t* __restrict__ bcodes,
                              const W* __restrict__ xors, W* __restrict__ out,
                              int C, int L, int e1, int e2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kBits = 8 * (int)sizeof(W);
  constexpr int kFcmMax = (int)sizeof(W);
  W* smem = reinterpret_cast<W*>(smem_raw);
  const int nt = blockDim.x;
  const int tid = threadIdx.x;
  const int T1 = 1 << e1, T2 = 1 << e2;
  for (int k = tid; k < (T1 + T2) * nt; k += nt) smem[k] = W(0);
  __syncthreads();
  const long long c = (long long)blockIdx.x * nt + tid;
  if (c >= C) return;
  W* t1 = smem + tid;
  W* t2 = smem + (size_t)T1 * nt + tid;
  const uint8_t* bc = bcodes + c * L;
  const W* xr = xors + c * L;
  W* o = out + c * L;
  const uint32_t m2 = (uint32_t)((1ull << e2) - 1);
  const int sh2 = e2 >> 1;
  uint32_t h1 = 0u, h2 = 0u;
  W pred1 = W(0), pred2 = W(0), last = W(0);
  for (int i = 0; i < L; ++i) {
    const W pred = bc[i] > kFcmMax ? last + pred2 : pred1;
    const W v = xr[i] ^ pred;
    o[i] = v;
    t1[(size_t)h1 * nt] = v;
    if (e1) h1 = (uint32_t)(v >> (kBits - e1));
    pred1 = t1[(size_t)h1 * nt];
    const W stride = v - last;
    t2[(size_t)h2 * nt] = stride;
    if (e2) h2 = ((h2 << sh2) ^ (uint32_t)(stride >> (kBits - e2))) & m2;
    pred2 = t2[(size_t)h2 * nt];
    last = v;
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

template <typename W>
int launch_replay(const void* bcodes, const void* xors, void* out, int C,
                  int L, int e1, int e2, void* stream) {
  const long long per_thread =
      ((1ll << e1) + (1ll << e2)) * (long long)sizeof(W);
  if (per_thread > kMaxSmem) return (int)cudaErrorInvalidValue;
  const long long cap = kMaxSmem / per_thread;  // what shared memory allows
  long long w = (C + sm_count() - 1) / sm_count();  // >= one block per SM
  w = w > 32 ? 32 : w;
  w = w > cap ? cap : w;
  w = w < 1 ? 1 : w;
  const long long smem = per_thread * w;
  if (smem > kDefaultSmem) {
    cudaError_t e = cudaFuncSetAttribute(
        replay_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (int)((C + w - 1) / w);
  replay_kernel<W><<<blocks, (int)w, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)bcodes, (const W*)xors, (W*)out, C, L, e1, e2);
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

// bcodes: (C, L) u8; xors, out: (C, L) u32. Exponents normalised.
int tt_replay(const void* bcodes, const void* xors, void* out, int C, int L,
              int e1, int e2, void* stream) {
  return launch_replay<uint32_t>(bcodes, xors, out, C, L, e1, e2, stream);
}

// bcodes: (C, L) u8; xors, out: (C, L) u64. Exponents normalised.
int tt_replay64(const void* bcodes, const void* xors, void* out, int C, int L,
                int e1, int e2, void* stream) {
  return launch_replay<uint64_t>(bcodes, xors, out, C, L, e1, e2, stream);
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
