// K4: single-token grouped-query attention against a KV cache (flash decode).
//
// Replaces the TPU kernel src/repro/kernels/flash_decode.py:76
// (flash_decode_pallas, body _kernel).  It is the core of the serve path's
// decode_attention: q (B, H, hd) float32, already scaled by hd**-0.5, against
// k/v caches (B, C, Hkv, hd) in float32, float16 or bfloat16, masked by
// valid (B, C) -> out (B, H, hd) float32.  Query head h reads kv head
// h / G (G = H / Hkv), as the reference's repeat over kv heads does, without
// a repeated copy of the cache.
//
// Semantics kept from the reference:
//   * cache values are upcast to float32 before any product;
//   * a masked position scores -1e30, not -inf, so a row whose every
//     position is masked gives the mean of V (the softmax of equal scores),
//     not NaN;
//   * any C >= 1: the last tile is ragged, and positions past C carry no
//     weight at all (-inf, unlike a masked position).
//
// Design.  One CTA per (kv head, sequence) holds its G query heads.  It walks
// the cache in tiles of kTile positions: the tile's K and V rows are upcast
// into shared memory with 16-byte loads (hd must be a multiple of 8; row
// stride hd + 1 in shared memory, so threads on neighbouring positions read
// different banks), every (head, position) score is one
// thread's dot product, one warp per head updates the online softmax
// (running max m, denominator l; the tile's weights replace its scores in
// shared memory), and every (head, dim) output is one thread's weighted sum
// over the tile, kept in shared memory across tiles.  The TPU grid's chunk
// axis, which carried (m, l, acc) in VMEM from one grid step to the next,
// becomes this loop inside the CTA.
//
// Bound.  Bytes: each cache element is read once (2 * B * C * Hkv * hd *
// sizeof(cache) bytes; 4 * G flops per cache element pair), so at the serve
// shape (B=8, C=2048, Hkv=8, hd=128, bf16) the card needs 67 MB, 20 us at
// 3.35 TB/s.  This simple version runs only B * Hkv CTAs (64 at that shape,
// on 132 SMs) and loads each tile synchronously, so it is latency-bound well
// above that; splitting C across CTAs with a combine pass and staging tiles
// with cp.async or TMA is later work.

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 64;            // cache positions per tile
constexpr int kPerLane = kTile / 32; // positions per lane in the softmax update
constexpr int kBatch = 4;            // 16-byte loads of K (and of V) in flight
constexpr float kMasked = -1e30f;
// Returned when the tile buffers do not fit in a CTA's shared memory; the
// wrapper raises KernelShapeError for it.
constexpr int kErrSmem = -1;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

size_t smem_bytes(int G, int hd) {
  // q, acc: G * hd; K and V tiles: kTile * (hd + 1); scores or weights:
  // G * kTile; m, l, alpha: G; the tile's valid flags: kTile.
  return sizeof(float) * (2 * static_cast<size_t>(G) * hd + 2 * kTile * (static_cast<size_t>(hd) + 1)
                          + static_cast<size_t>(G) * kTile + 3 * static_cast<size_t>(G) + kTile);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const float* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const uint8_t* __restrict__ valid,
                    long long valid_stride, float* __restrict__ out, int C, int Hkv,
                    int G, int hd) {
  extern __shared__ float smem[];
  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  constexpr int kVec = 16 / sizeof(T);  // cache elements per 16-byte load
  const int vrow = hd / kVec;            // loads per cache row
  const int ld = hd + 1;
  const int gd = G * hd;

  float* q_s = smem;                  // (G, hd)
  float* acc = q_s + gd;              // (G, hd)
  float* k_s = acc + gd;              // (kTile, ld)
  float* v_s = k_s + kTile * ld;      // (kTile, ld)
  float* w_s = v_s + kTile * ld;      // (G, kTile): scores, then weights
  float* m_s = w_s + G * kTile;       // (G,)
  float* l_s = m_s + G;               // (G,)
  float* a_s = l_s + G;               // (G,) alpha of the current tile
  float* ok_s = a_s + G;              // (kTile,) 1 where valid

  // heads kh*G .. kh*G + G - 1 of sequence b are G*hd contiguous floats
  const size_t head0 = (static_cast<size_t>(b) * Hkv + kh) * gd;
  for (int i = tid; i < gd; i += kThreads) {
    q_s[i] = q[head0 + i];
    acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = kMasked;
    l_s[g] = 0.f;
  }
  const uint8_t* valid_b = valid + static_cast<long long>(b) * valid_stride;
  __syncthreads();

  for (int c0 = 0; c0 < C; c0 += kTile) {
    const int nt = min(kTile, C - c0);
    // 16-byte loads, kBatch of K and of V in flight per thread before any
    // is upcast into shared memory
    for (int j0 = tid; j0 < nt * vrow; j0 += kBatch * kThreads) {
      uint4 kr[kBatch], vr[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int j = j0 + u * kThreads;
        if (j < nt * vrow) {
          const int t = j / vrow;
          const size_t off = ((static_cast<size_t>(b) * C + c0 + t) * Hkv + kh) * hd
                             + static_cast<size_t>(j - t * vrow) * kVec;
          kr[u] = *reinterpret_cast<const uint4*>(k + off);
          vr[u] = *reinterpret_cast<const uint4*>(v + off);
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int j = j0 + u * kThreads;
        if (j < nt * vrow) {
          const int t = j / vrow;
          const int d = (j - t * vrow) * kVec;
          const T* ke = reinterpret_cast<const T*>(&kr[u]);
          const T* ve = reinterpret_cast<const T*>(&vr[u]);
#pragma unroll
          for (int e = 0; e < kVec; ++e) {
            k_s[t * ld + d + e] = to_f32(ke[e]);
            v_s[t * ld + d + e] = to_f32(ve[e]);
          }
        }
      }
    }
    for (int t = tid; t < nt; t += kThreads) ok_s[t] = valid_b[c0 + t] ? 1.f : 0.f;
    __syncthreads();

    for (int i = tid; i < G * kTile; i += kThreads) {
      const int g = i / kTile;
      const int t = i - g * kTile;
      float s = -INFINITY;  // past C: no weight
      if (t < nt) {
        if (ok_s[t] != 0.f) {
          const float* qg = q_s + g * hd;
          const float* kt = k_s + t * ld;
          s = 0.f;
          for (int d = 0; d < hd; ++d) s = fmaf(qg[d], kt[d], s);
        } else {
          s = kMasked;
        }
      }
      w_s[i] = s;
    }
    __syncthreads();

    for (int g = warp; g < G; g += kWarps) {
      float* wg = w_s + g * kTile;
      float s[kPerLane];
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < kPerLane; ++j) {
        s[j] = wg[lane + 32 * j];
        mt = fmaxf(mt, s[j]);
      }
      mt = warp_max(mt);
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mt);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < kPerLane; ++j) {
        const float p = expf(s[j] - m_new);
        wg[lane + 32 * j] = p;
        ps += p;
      }
      ps = warp_sum(ps);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + ps;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    for (int i = tid; i < gd; i += kThreads) {
      const int g = i / hd;
      const int d = i - g * hd;
      const float* wg = w_s + g * kTile;
      float a = acc[i] * a_s[g];
      for (int t = 0; t < nt; ++t) a = fmaf(wg[t], v_s[t * ld + d], a);
      acc[i] = a;
    }
    __syncthreads();
  }

  for (int i = tid; i < gd; i += kThreads) {
    out[head0 + i] = acc[i] / fmaxf(l_s[i / hd], 1e-30f);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* valid,
           long long valid_stride, void* out, int B, int C, int Hkv, int G, int hd,
           void* stream) {
  const size_t smem = smem_bytes(G, hd);
  int dev = 0, max_smem = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (smem > static_cast<size_t>(max_smem)) return kErrSmem;
  cudaError_t err = cudaFuncSetAttribute(flash_decode_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(Hkv, B);
  flash_decode_kernel<T><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const uint8_t*>(valid), valid_stride, static_cast<float*>(out), C, Hkv,
      G, hd);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define FLASH_DECODE_ENTRY(NAME, T)                                                    \
  extern "C" int NAME(const void* q, const void* k, const void* v, const void* valid, \
                      long long valid_stride, void* out, int B, int C, int Hkv, int G, \
                      int hd, void* stream) {                                          \
    return launch<T>(q, k, v, valid, valid_stride, out, B, C, Hkv, G, hd, stream);     \
  }

FLASH_DECODE_ENTRY(flash_decode_f32, float)
FLASH_DECODE_ENTRY(flash_decode_f16, __half)
FLASH_DECODE_ENTRY(flash_decode_bf16, __nv_bfloat16)
