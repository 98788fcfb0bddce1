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
// Bound.  The kernel reads each cache element once: 2 * B * C * Hkv * hd *
// sizeof(cache) bytes against 4 * G flops per (K, V) element pair.  At the
// serve shape (B=8, C=2048, Hkv=8, G=4, hd=128, bf16) that is 67 MB, 20 us
// at 3.35 TB/s, against 4 us of float32 operations: the kernel is bound by
// bytes, and its design is about keeping enough of them in flight.
//
// Split.  The cache axis is cut into runs of kTile-position tiles, one run a
// CTA: the grid is (splits, Hkv * head groups, B).  flash_decode_plan picks
// the split count from B, Hkv, C and the card's SM count and occupancy: as
// many CTAs as the card holds at once (SMs x CTAs an SM: at 3 an SM, near
// three CTAs for each of the 132 SMs), one wave with no tail, since the
// kernel is bound by its instructions as much as by bytes and a partial
// second wave leaves SMs idle (measured in PERF.md, PR 14); no more splits
// than half the tiles (1 for C <= 2 kTile), at most kMaxSplits.  Each CTA
// keeps an online softmax
// (running max m, denominator l, unnormalised acc) per query head; with one
// split it writes out = acc / max(l, 1e-30) itself, else its (m, l, acc) go
// to a float32 workspace that the wrapper allocates, and flash_decode_combine
// merges the splits: M = max_s m_s, out = sum_s e^(m_s - M) acc_s /
// max(sum_s e^(m_s - M) l_s, 1e-30).  A masked position's -1e30 stays a
// score like any other through the merge: a split whose every position is
// masked has m = -1e30 and weighs e^(-1e30 - M) = 0 beside any split with a
// valid position, and when every split is masked M = -1e30 and every
// position weighs 1, so the row averages V.  A position past C scores -inf
// and weighs 0 in every case.
//
// Ring.  K and V tiles are copied in their storage dtype with 16-byte
// cp.async copies into a ring of two stages: tile i+1 is in flight while
// tile i is computed, and a bf16 tile takes half the shared memory of an
// upcast one.  Rows past C are zero-filled (cp.async src-size 0), so the
// weighted sum never reads stale shared memory.  Values are upcast to
// float32 when read from shared memory.
//
// Scores.  Each of the 4 warps takes 16 positions of a tile.  A lane holds
// one 8-element piece of the head dimension (hd <= 256, so a row is at most
// 32 pieces): kLpr lanes (4 to 32, a template parameter) cover a row, and a
// warp scores 32 / kLpr positions a pass.  The lane keeps its piece of the
// kG query heads' q and acc in registers; each K piece it reads serves all
// kG heads, so no thread runs a dependent chain longer than 8 products.
// The partial sums of all the warp's (position, head) pairs are finished
// together by a shuffle reduce-scatter over the row's lanes (each step
// halves the values a lane holds), which takes a quarter of the shuffles of
// one shuffle sum per pair.  A warp updates its own (m, l) once per tile;
// the warps' states merge in shared memory at the end of the run.  For
// G > 4 (or G not a multiple of 4) the heads are cut into groups of kG in
// {4, 2, 1}, one group a CTA.  Exponentials are exp2f of prescaled
// differences.
//
// What is left above the byte bound is the instructions of the scores and
// the weighted sum (PERF.md, PR 14), not the copies.
//
// No tensor cores: at G = 4 an mma tile would be mostly padding, the kernel
// is bound by bytes, and the reference multiplies a float32 query by the
// upcast cache, which float32 FMAs on the CUDA cores keep.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 64;                 // cache positions per tile
constexpr int kPos = kTile / kWarps;      // positions per warp and tile
constexpr int kPiece = 8;                 // head-dimension elements a lane holds
constexpr int kMaxHd = 32 * kPiece;
constexpr int kMaxSplits = 64;
constexpr float kMasked = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;  // e^x = 2^(x log2 e)
// Returned when the ring does not fit in a CTA's shared memory or hd is
// larger than kMaxHd (the wrapper raises KernelShapeError for it), and when
// a launch is given a split count that flash_decode_plan would not give.
// flash_decode_plan returns -(kErrCuda + e) for a CUDA error e.
constexpr int kErrSmem = -1;
constexpr int kErrSplits = -2;
constexpr int kErrCuda = 1000;

__device__ __forceinline__ void load8(const float* p, float (&f)[kPiece]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

__device__ __forceinline__ void load8(const __half* p, float (&f)[kPiece]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __half2* h = reinterpret_cast<const __half2*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __half22float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&f)[kPiece]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// 16 bytes global -> shared; src_bytes 0 fills the 16 bytes with zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// All but the newest committed group of this thread's copies have landed.
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Stage one tile of K and V rows (positions c0 .. c0 + kTile - 1 of kv head
// kh) into ks/vs; rows at or past nt are zero-filled.
template <typename T>
__device__ __forceinline__ void issue_tile(T* ks, T* vs, const T* __restrict__ k,
                                           const T* __restrict__ v, size_t row0,
                                           size_t rstride, int nt, int hd) {
  constexpr int kVec = 16 / sizeof(T);
  const int per_row = hd / kVec;
  // this thread's copies: row t, element e, stepping kThreads copies a time
  int t = threadIdx.x / per_row;
  int e = (threadIdx.x - t * per_row) * kVec;
  const int dt = kThreads / per_row;
  const int de = (kThreads - dt * per_row) * kVec;
  for (; t < kTile; t += dt) {
    const bool in = t < nt;
    const size_t off = row0 + static_cast<size_t>(in ? t : 0) * rstride + e;
    cp_async16(ks + t * hd + e, k + off, in ? 16 : 0);
    cp_async16(vs + t * hd + e, v + off, in ? 16 : 0);
    e += de;
    if (e >= hd) {
      e -= hd;
      ++t;
    }
  }
}

__host__ __device__ inline size_t ring_bytes(int hd, size_t elem) {
  return 2 * 2 * static_cast<size_t>(kTile) * hd * elem;
}

template <int kG>
size_t smem_bytes(int hd, size_t elem) {
  // the ring (reused for the warps' acc at the end of the run: kWarps * kG *
  // hd floats, never more than the ring), the tile's scores (kG, kTile) and
  // the warps' (m, l) (kWarps, kG, 2)
  return ring_bytes(hd, elem) + sizeof(float) * (kG * kTile + kWarps * kG * 2);
}

// Lanes a row's pieces take: a power of two from 4 to 32.
__host__ __device__ inline int lanes_per_row(int hd) {
  int lpr = 4;
  while (lpr * kPiece < hd) lpr <<= 1;
  return lpr;
}

// Sums each of a lane's kCnt partial scores over the kLpr lanes of its row,
// scattering: at offset kO a lane keeps half of its values (the upper half
// if its bit kO is set) and adds its partner's copy of that half; once one
// value is left, plain shuffle sums.  After the scattering step at offset
// 2^st, value j stands for partial j + bit_st(sub) * (kCnt / 2) of those
// the step began with.
template <int kCnt, int kO, int kLpr>
struct RowSum {
  __device__ __forceinline__ static void run(float* sv, int sub) {
    if constexpr (kO < kLpr) {
      if constexpr (kCnt >= 2) {
        const bool up = sub & kO;
#pragma unroll
        for (int j = 0; j < kCnt / 2; ++j) {
          const float lo = sv[j], hi = sv[j + kCnt / 2];
          const float got = __shfl_xor_sync(0xffffffffu, up ? lo : hi, kO);
          sv[j] = (up ? hi : lo) + got;
        }
        RowSum<kCnt / 2, kO * 2, kLpr>::run(sv, sub);
      } else {
        sv[0] += __shfl_xor_sync(0xffffffffu, sv[0], kO);
        RowSum<1, kO * 2, kLpr>::run(sv, sub);
      }
    }
  }
};

template <typename T, int kG, int kLpr>
__global__ void __launch_bounds__(kThreads)
flash_decode_split(const float* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const uint8_t* __restrict__ valid,
                   long long valid_stride, float* __restrict__ out,
                   float* __restrict__ ws_acc, float* __restrict__ ws_ml, int C, int Hkv,
                   int G, int hd, int tiles_per_split) {
  constexpr int kRpw = 32 / kLpr;      // rows a pass
  constexpr int kPass = kPos / kRpw;   // passes over the warp's positions
  constexpr int kN = kPass * kG;       // partial scores a lane holds
  extern __shared__ __align__(16) unsigned char smem[];
  const int tile_elems = kTile * hd;
  T* ring = reinterpret_cast<T*>(smem);                                  // 2 x (K, V)
  float* s_s = reinterpret_cast<float*>(smem + ring_bytes(hd, sizeof(T)));  // (kG, kTile)
  float* w_ml = s_s + kG * kTile;                                        // (kWarps, kG, 2)

  const int split = blockIdx.x;
  const int splits = gridDim.x;
  const int groups = G / kG;
  const int kh = blockIdx.y / groups;
  const int h0 = kh * G + (blockIdx.y - kh * groups) * kG;  // first query head
  const int b = blockIdx.z;
  const int B = gridDim.z;
  const int H = Hkv * G;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int sub = lane % kLpr;   // this lane's piece of a row
  const int grp = lane / kLpr;   // this lane's row of a pass
  const bool has_piece = sub * kPiece < hd;
  const int d0 = sub * kPiece;

  float qr[kG][kPiece], acc[kG][kPiece], m[kG], l[kG];
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    const float* qg = q + (static_cast<size_t>(b) * H + h0 + g) * hd + d0;
    if (has_piece) {
      load8(qg, qr[g]);
    } else {
#pragma unroll
      for (int e = 0; e < kPiece; ++e) qr[g][e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < kPiece; ++e) acc[g][e] = 0.f;
    m[g] = kMasked;
    l[g] = 0.f;
  }

  const int tiles = (C + kTile - 1) / kTile;
  const int t_begin = split * tiles_per_split;
  const int ntiles = min(tiles, t_begin + tiles_per_split) - t_begin;
  const size_t rstride = static_cast<size_t>(Hkv) * hd;
  const size_t head_off = static_cast<size_t>(kh) * hd;
  const uint8_t* valid_b = valid + static_cast<long long>(b) * valid_stride;
  // this lane's position of a tile (lanes below kPos): 0 past C, 1 masked,
  // 2 valid; read a tile ahead, so the load overlaps a tile's work
  auto code_of = [&](int c0) {
    const int c = c0 + warp * kPos + lane;
    return lane < kPos && c < C ? (valid_b[c] ? 2 : 1) : 0;
  };

  int code = code_of(t_begin * kTile);
  {
    const int c0 = t_begin * kTile;
    issue_tile(ring, ring + tile_elems, k, v,
               (static_cast<size_t>(b) * C + c0) * rstride + head_off, rstride,
               min(kTile, C - c0), hd);
    cp_async_commit();
  }
  for (int i = 0; i < ntiles; ++i) {
    const int c0 = (t_begin + i) * kTile;
    const int code_next = i + 1 < ntiles ? code_of(c0 + kTile) : 0;
    if (i + 1 < ntiles) {
      T* nk = ring + ((i + 1) & 1) * 2 * tile_elems;
      issue_tile(nk, nk + tile_elems, k, v,
                 (static_cast<size_t>(b) * C + c0 + kTile) * rstride + head_off, rstride,
                 min(kTile, C - c0 - kTile), hd);
    }
    cp_async_commit();
    cp_async_wait_prior();
    __syncthreads();
    const T* ks = ring + (i & 1) * 2 * tile_elems;
    const T* vs = ks + tile_elems;

    // partial scores: pass p, head g at sv[p * kG + g]
    float sv[kN];
#pragma unroll
    for (int p = 0; p < kPass; ++p) {
      const int tp = warp * kPos + p * kRpw + grp;
      float kf[kPiece];
      if (has_piece) {
        load8(ks + tp * hd + d0, kf);
      } else {
#pragma unroll
        for (int e = 0; e < kPiece; ++e) kf[e] = 0.f;
      }
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        float a = 0.f;
#pragma unroll
        for (int e = 0; e < kPiece; ++e) a = fmaf(qr[g][e], kf[e], a);
        sv[p * kG + g] = a;
      }
    }
    RowSum<kN, 1, kLpr>::run(sv, sub);
    // value j is now the sum of partial j + sum_st bit_st(sub) * (kN >>
    // (st + 1)) over the scattering steps; lanes that differ only in the
    // bits past them hold the same sums, and the lowest writes
    {
      constexpr int kScatter = (kN < kLpr ? kN : kLpr);
      constexpr int kLeft = kN / kScatter;
      int base = 0;
#pragma unroll
      for (int st = 0; (1 << st) < kScatter; ++st)
        if (sub & (1 << st)) base += kN >> (st + 1);
      const bool writer = (sub & ~(kScatter - 1)) == 0;
#pragma unroll
      for (int j = 0; j < kLeft; ++j) {
        const int idx = base + j;
        const int r = (idx / kG) * kRpw + grp;
        const int rc = __shfl_sync(0xffffffffu, code, r);
        if (writer)
          s_s[(idx % kG) * kTile + warp * kPos + r] =
              rc == 2 ? sv[j] : (rc == 1 ? kMasked : -INFINITY);
      }
    }
    __syncwarp();

    // online softmax over the warp's positions: scores become weights
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      float* sg = s_s + g * kTile + warp * kPos;
      const float s = lane < kPos ? sg[lane] : -INFINITY;
      const float m_new = fmaxf(m[g], warp_max(s));
      const float p = lane < kPos ? exp2f((s - m_new) * kLog2e) : 0.f;
      if (lane < kPos) sg[lane] = p;
      const float alpha = exp2f((m[g] - m_new) * kLog2e);
      l[g] = l[g] * alpha + warp_sum(p);
      m[g] = m_new;
#pragma unroll
      for (int e = 0; e < kPiece; ++e) acc[g][e] *= alpha;
    }
    __syncwarp();

    // weighted sum of V (rows past C are zeros with weight 0)
    if (has_piece) {
#pragma unroll
      for (int p = 0; p < kPass; ++p) {
        const int tp = warp * kPos + p * kRpw + grp;
        float vf[kPiece];
        load8(vs + tp * hd + d0, vf);
#pragma unroll
        for (int g = 0; g < kG; ++g) {
          const float w = s_s[g * kTile + tp];
#pragma unroll
          for (int e = 0; e < kPiece; ++e) acc[g][e] = fmaf(w, vf[e], acc[g][e]);
        }
      }
    }
    code = code_next;
    // every warp is done with this stage before the next copy into it
    __syncthreads();
  }

  // the row groups of a warp share its (m, l): sum their acc
#pragma unroll
  for (int o = kLpr; o < 32; o <<= 1) {
#pragma unroll
    for (int g = 0; g < kG; ++g)
#pragma unroll
      for (int e = 0; e < kPiece; ++e) acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], o);
  }
  float* w_acc = reinterpret_cast<float*>(smem);  // (kWarps, kG, hd), over the free ring
  if (grp == 0 && has_piece) {
#pragma unroll
    for (int g = 0; g < kG; ++g)
#pragma unroll
      for (int e = 0; e < kPiece; ++e) w_acc[(warp * kG + g) * hd + d0 + e] = acc[g][e];
  }
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      w_ml[(warp * kG + g) * 2] = m[g];
      w_ml[(warp * kG + g) * 2 + 1] = l[g];
    }
  }
  __syncthreads();

  // merge the warps: M = max m_w; acc, l weighted by e^(m_w - M)
  for (int i = tid; i < kG * hd; i += kThreads) {
    const int g = i / hd;
    const int d = i - g * hd;
    float M = kMasked;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, w_ml[(w * kG + g) * 2]);
    float L = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float e = exp2f((w_ml[(w * kG + g) * 2] - M) * kLog2e);
      L += e * w_ml[(w * kG + g) * 2 + 1];
      a += e * w_acc[(w * kG + g) * hd + d];
    }
    const size_t bh = static_cast<size_t>(b) * H + h0 + g;
    if (splits == 1) {
      out[bh * hd + d] = a / fmaxf(L, 1e-30f);
    } else {
      const size_t sbh = static_cast<size_t>(split) * B * H + bh;
      ws_acc[sbh * hd + d] = a;
      if (d == 0) {
        ws_ml[sbh * 2] = M;
        ws_ml[sbh * 2 + 1] = L;
      }
    }
  }
}

// One CTA per (sequence, query head): merge the splits' (m, l, acc).
__global__ void __launch_bounds__(kThreads)
flash_decode_combine(const float* __restrict__ ws_acc, const float* __restrict__ ws_ml,
                     float* __restrict__ out, int splits, int BH, int hd) {
  __shared__ float s_w[kMaxSplits];
  __shared__ float s_l;
  const int bh = blockIdx.x;
  const int tid = threadIdx.x;
  if (tid < 32) {
    float M = kMasked;
    for (int s = tid; s < splits; s += 32)
      M = fmaxf(M, ws_ml[(static_cast<size_t>(s) * BH + bh) * 2]);
    M = warp_max(M);
    float L = 0.f;
    for (int s = tid; s < splits; s += 32) {
      const size_t o = (static_cast<size_t>(s) * BH + bh) * 2;
      const float w = exp2f((ws_ml[o] - M) * kLog2e);
      s_w[s] = w;
      L += w * ws_ml[o + 1];
    }
    L = warp_sum(L);
    if (tid == 0) s_l = L;
  }
  __syncthreads();
  const float L = fmaxf(s_l, 1e-30f);
  for (int d = tid; d < hd; d += kThreads) {
    float a = 0.f;
    for (int s = 0; s < splits; ++s)
      a += s_w[s] * ws_acc[(static_cast<size_t>(s) * BH + bh) * hd + d];
    out[static_cast<size_t>(bh) * hd + d] = a / L;
  }
}

// The head group a CTA holds: the largest of 4, 2, 1 that divides G.
int group_of(int G) { return G % 4 == 0 ? 4 : (G % 2 == 0 ? 2 : 1); }

template <typename T>
using SplitKernel = void (*)(const float*, const T*, const T*, const uint8_t*, long long,
                             float*, float*, float*, int, int, int, int, int);

template <typename T, int kG>
SplitKernel<T> pick_lanes(int hd) {
  switch (lanes_per_row(hd)) {
    case 4: return flash_decode_split<T, kG, 4>;
    case 8: return flash_decode_split<T, kG, 8>;
    case 16: return flash_decode_split<T, kG, 16>;
    default: return flash_decode_split<T, kG, 32>;
  }
}

// The instantiation for (G, hd) and its shared memory, after setting the
// kernel's shared-memory limit; kErrSmem when it does not fit.
template <typename T>
int prepare(int G, int hd, SplitKernel<T>* fn, size_t* smem) {
  const int kG = group_of(G);
  *fn = kG == 4 ? pick_lanes<T, 4>(hd) : (kG == 2 ? pick_lanes<T, 2>(hd) : pick_lanes<T, 1>(hd));
  *smem = kG == 4 ? smem_bytes<4>(hd, sizeof(T))
                  : (kG == 2 ? smem_bytes<2>(hd, sizeof(T)) : smem_bytes<1>(hd, sizeof(T)));
  int dev = 0, max_smem = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (hd > kMaxHd || *smem > static_cast<size_t>(max_smem)) return kErrSmem;
  return static_cast<int>(cudaFuncSetAttribute(reinterpret_cast<const void*>(*fn),
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(*smem)));
}

// Splits of the cache axis: the most whose CTAs all fit on the card at
// once, at least two tiles a split (one split for C <= 2 kTile), at most
// kMaxSplits, then as few as give every split the same whole number of
// tiles but the last.  Negative: kErrSmem, or -(kErrCuda + e) for a CUDA
// error e.
template <typename T>
int plan(int B, int C, int Hkv, int G, int hd) {
  SplitKernel<T> fn;
  size_t smem = 0;
  int rc = prepare<T>(G, hd, &fn, &smem);
  int per_sm = 0;
  if (rc == 0)
    rc = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, reinterpret_cast<const void*>(fn), kThreads, smem));
  if (rc != 0) return rc > 0 ? -(kErrCuda + rc) : rc;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long base = static_cast<long long>(B) * Hkv * (G / group_of(G));
  const long long slots = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  const int tiles = (C + kTile - 1) / kTile;
  long long splits = slots / base;
  splits = std::min<long long>(splits, tiles / 2);
  splits = std::max<long long>(1, std::min<long long>(splits, kMaxSplits));
  const int tps = static_cast<int>((tiles + splits - 1) / splits);
  return (tiles + tps - 1) / tps;
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* valid,
           long long valid_stride, void* out, void* ws_acc, void* ws_ml, int B, int C,
           int Hkv, int G, int hd, int splits, void* stream) {
  if (splits < 1 || splits > kMaxSplits) return kErrSplits;
  const int tiles = (C + kTile - 1) / kTile;
  const int tps = (tiles + splits - 1) / splits;
  if ((tiles + tps - 1) / tps != splits) return kErrSplits;
  SplitKernel<T> fn;
  size_t smem = 0;
  const int rc = prepare<T>(G, hd, &fn, &smem);
  if (rc != 0) return rc;
  const dim3 grid(splits, Hkv * (G / group_of(G)), B);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dst = static_cast<float*>(out);
  float* wa = static_cast<float*>(ws_acc);
  float* wm = static_cast<float*>(ws_ml);
  fn<<<grid, kThreads, smem, s>>>(static_cast<const float*>(q), static_cast<const T*>(k),
                                  static_cast<const T*>(v), static_cast<const uint8_t*>(valid),
                                  valid_stride, dst, wa, wm, C, Hkv, G, hd, tps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  flash_decode_combine<<<B * Hkv * G, kThreads, 0, s>>>(wa, wm, dst, splits, B * Hkv * G, hd);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define FLASH_DECODE_ENTRY(NAME, T)                                                      \
  extern "C" int NAME(const void* q, const void* k, const void* v, const void* valid,   \
                      long long valid_stride, void* out, void* ws_acc, void* ws_ml,      \
                      int B, int C, int Hkv, int G, int hd, int splits, void* stream) {  \
    return launch<T>(q, k, v, valid, valid_stride, out, ws_acc, ws_ml, B, C, Hkv, G, hd, \
                     splits, stream);                                                    \
  }                                                                                      \
  extern "C" int NAME##_plan(int B, int C, int Hkv, int G, int hd) {                     \
    return plan<T>(B, C, Hkv, G, hd);                                                    \
  }

FLASH_DECODE_ENTRY(flash_decode_f32, float)
FLASH_DECODE_ENTRY(flash_decode_f16, __half)
FLASH_DECODE_ENTRY(flash_decode_bf16, __nv_bfloat16)
