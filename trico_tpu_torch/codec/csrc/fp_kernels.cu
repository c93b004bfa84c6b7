// Hopper (sm_90a) kernels of the f32 chunked FP codec, v2 layout.
//
// Each kernel computes the same function as one Pallas TPU kernel of
// trico_tpu/codec/fp_pallas.py, bit for bit, but not with its block
// structure: the TPU kernels read tables by one-hot compare/select and move
// data through log-shift networks because the TPU has no fast gather or
// scatter; Hopper indexes shared memory directly and scatters to global
// memory, so those workarounds are gone.
//
// A u32 word is a uint32_t here and an int32 tensor in Python. Every entry
// point is a plain C function that launches on the caller's stream, does not
// synchronise, allocates nothing, and returns cudaGetLastError() (0 = ok).
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC (trico_tpu_torch/codec/_build.py).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
// Largest dynamic shared memory one block may opt into on an H100.
constexpr int kMaxSmem = 232448;
constexpr int kDefaultSmem = 49152;

// Top e bits of x; 0 when e == 0. `x >> 32` is undefined in C++, and the
// reference keeps the FCM/DFCM key at 0 for a zero exponent
// (fp_pallas.py:74, :78).
__device__ __forceinline__ uint32_t top_bits(uint32_t x, int e) {
  return e ? x >> (32 - e) : 0u;
}

// ---------------------------------------------------------------------------
// predict_xors: replaces _predict_window_kernel (fp_pallas.py:85) and
// _predict_kernel (fp_pallas.py:59); one kernel serves both.
//
// Encode has no value->prediction feedback: the FCM key of position i is
// top_e1(v[i-1]) and the DFCM key is t[i-1] ^ ((t[i-2] << e2/2) & m2) with
// t = top_e2(v - vprev), so a table read at i is "payload of the latest
// j < i with the same key, else 0". One warp per chunk walks it 32 positions
// at a time: a lane's latest same-key lane below it comes from
// __match_any_sync, otherwise it reads the table as it stood at the window's
// start; then the last lane of each key group writes the table.
//
// Bound on the H100: latency of the per-window shared-memory read and the
// shuffles; the bytes (4 in, 8 out per value) are small. The design keeps the
// two tables of each chunk in shared memory (80 words at (4,6)) and packs
// several chunk warps per block, so no table traffic reaches device memory
// and 32 positions resolve per step instead of one.
// ---------------------------------------------------------------------------
__global__ void predict_xors_kernel(const uint32_t* __restrict__ values,
                                    uint32_t* __restrict__ xor1,
                                    uint32_t* __restrict__ xor2, int C, int L,
                                    int e1, int e2) {
  extern __shared__ uint32_t smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int T1 = 1 << e1, T2 = 1 << e2;
  const long long c = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
  if (c >= C) return;  // warp-uniform
  uint32_t* t1 = smem + (size_t)warp * (T1 + T2);
  uint32_t* t2 = t1 + T1;
  for (int k = lane; k < T1 + T2; k += 32) t1[k] = 0u;
  __syncwarp();

  const uint32_t* row = values + c * L;
  uint32_t* x1 = xor1 + c * L;
  uint32_t* x2 = xor2 + c * L;
  const uint32_t m2 = (uint32_t)((1ull << e2) - 1);
  const int sh2 = e2 >> 1;
  const unsigned below = (1u << lane) - 1u;
  uint32_t vprev_c = 0u, tprev = 0u, tprev2 = 0u;  // carries, zero at i = 0

  for (int base = 0; base < L; base += 32) {
    const int i = base + lane;
    const bool active = i < L;
    const uint32_t v = active ? row[i] : 0u;
    const uint32_t up1 = __shfl_up_sync(kFull, v, 1);
    const uint32_t vprev = lane ? up1 : vprev_c;
    const uint32_t s = v - vprev;
    const uint32_t t = top_bits(s, e2);
    const uint32_t tu1 = __shfl_up_sync(kFull, t, 1);
    const uint32_t tu2 = __shfl_up_sync(kFull, t, 2);
    const uint32_t t_1 = lane >= 1 ? tu1 : tprev;
    const uint32_t t_2 = lane >= 2 ? tu2 : (lane == 1 ? tprev : tprev2);
    uint32_t k1 = top_bits(vprev, e1);
    uint32_t k2 = e2 ? (t_1 ^ ((t_2 << sh2) & m2)) : 0u;
    if (!active) {  // keys are < 2^30: these never match a live lane
      k1 = 0x80000000u | lane;
      k2 = 0x80000000u | lane;
    }
    const unsigned g1 = __match_any_sync(kFull, k1);
    const unsigned g2 = __match_any_sync(kFull, k2);
    const unsigned p1 = g1 & below, p2 = g2 & below;
    const int src1 = p1 ? 31 - __clz(p1) : lane;
    const int src2 = p2 ? 31 - __clz(p2) : lane;
    const uint32_t w1 = __shfl_sync(kFull, v, src1);
    const uint32_t w2 = __shfl_sync(kFull, s, src2);
    if (active) {
      const uint32_t pred1 = p1 ? w1 : t1[k1];
      const uint32_t pred2 = p2 ? w2 : t2[k2];
      x1[i] = v ^ pred1;
      x2[i] = v ^ (vprev + pred2);
    }
    __syncwarp();  // every lane read the table as of the window's start
    if (active && (g1 >> lane) == 1u) t1[k1] = v;  // last lane of its group
    if (active && (g2 >> lane) == 1u) t2[k2] = s;
    __syncwarp();
    vprev_c = __shfl_sync(kFull, v, 31);
    tprev2 = __shfl_sync(kFull, t, 30);
    tprev = __shfl_sync(kFull, t, 31);
  }
}

// ---------------------------------------------------------------------------
// replay: replaces _replay_kernel (fp_pallas.py:216).
//
// Decode feeds each value back into the next keys, so a chunk is one
// sequential chain; one thread walks one chunk. Its two tables live in
// shared memory, interleaved across the block's threads (word idx of thread
// tid at idx * W + tid) so that lanes reading the same idx hit distinct
// banks.
//
// Bound on the H100: the dependent chain of one shared-memory write, read and
// a few integer ops per value, with only C threads in flight (2048 at the
// bench shape of 8M values in chunks of 4096, a fraction of one thread per
// core). The design keeps the chain out of device memory; the block width
// is chosen in tt_replay to spread the chunks over every SM.
// ---------------------------------------------------------------------------
__global__ void replay_kernel(const uint8_t* __restrict__ bcodes,
                              const uint32_t* __restrict__ xors,
                              uint32_t* __restrict__ out, int C, int L, int e1,
                              int e2) {
  extern __shared__ uint32_t smem[];
  const int W = blockDim.x;
  const int tid = threadIdx.x;
  const int T1 = 1 << e1, T2 = 1 << e2;
  for (int k = tid; k < (T1 + T2) * W; k += W) smem[k] = 0u;
  __syncthreads();
  const long long c = (long long)blockIdx.x * W + tid;
  if (c >= C) return;
  uint32_t* t1 = smem + tid;
  uint32_t* t2 = smem + (size_t)T1 * W + tid;
  const uint8_t* bc = bcodes + c * L;
  const uint32_t* xr = xors + c * L;
  uint32_t* o = out + c * L;
  const uint32_t m2 = (uint32_t)((1ull << e2) - 1);
  const int sh2 = e2 >> 1;
  uint32_t h1 = 0u, h2 = 0u, pred1 = 0u, pred2 = 0u, last = 0u;
  for (int i = 0; i < L; ++i) {
    const uint32_t pred = bc[i] > 4 ? last + pred2 : pred1;  // fcm_max = 4
    const uint32_t v = xr[i] ^ pred;
    o[i] = v;
    t1[(size_t)h1 * W] = v;
    if (e1) h1 = v >> (32 - e1);
    pred1 = t1[(size_t)h1 * W];
    const uint32_t stride = v - last;
    t2[(size_t)h2 * W] = stride;
    if (e2) h2 = ((h2 << sh2) ^ (stride >> (32 - e2))) & m2;
    pred2 = t2[(size_t)h2 * W];
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

}  // namespace

extern "C" {

// values, xor1, xor2: (C, L) u32. Exponents normalised (even, <= 30).
int tt_predict_xors(const void* values, void* xor1, void* xor2, int C, int L,
                    int e1, int e2, void* stream) {
  const long long per_warp = ((1ll << e1) + (1ll << e2)) * 4;
  if (per_warp > kMaxSmem) return (int)cudaErrorInvalidValue;
  int warps = (int)(kDefaultSmem / per_warp);
  warps = warps < 1 ? 1 : (warps > 8 ? 8 : warps);
  const long long smem = per_warp * warps;
  if (smem > kDefaultSmem) {
    cudaError_t e = cudaFuncSetAttribute(
        predict_xors_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (C + warps - 1) / warps;
  predict_xors_kernel<<<blocks, 32 * warps, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)values, (uint32_t*)xor1, (uint32_t*)xor2, C, L, e1, e2);
  return (int)cudaGetLastError();
}

// bcodes: (C, L) u8; xors, out: (C, L) u32. Exponents normalised.
int tt_replay(const void* bcodes, const void* xors, void* out, int C, int L,
              int e1, int e2, void* stream) {
  const long long per_thread = ((1ll << e1) + (1ll << e2)) * 4;
  if (per_thread > kMaxSmem) return (int)cudaErrorInvalidValue;
  const long long cap = kMaxSmem / per_thread;  // what shared memory allows
  long long w = (C + sm_count() - 1) / sm_count();  // >= one block per SM
  w = w > 32 ? 32 : w;
  w = w > cap ? cap : w;
  w = w < 1 ? 1 : w;
  const long long smem = per_thread * w;
  if (smem > kDefaultSmem) {
    cudaError_t e = cudaFuncSetAttribute(
        replay_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (int)((C + w - 1) / w);
  replay_kernel<<<blocks, (int)w, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)bcodes, (const uint32_t*)xors, (uint32_t*)out, C, L, e1,
      e2);
  return (int)cudaGetLastError();
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
