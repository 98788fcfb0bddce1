// Asynchronous copies from global to shared memory, shared by K2
// (seq_cumsum.cu) and K3 (dict_match.cu).
#pragma once

#include <cstddef>
#include <cstdint>

// One element: cp.async for 4 and 8 bytes, a plain copy for a half
// (cp.async takes no 2-byte copy).
template <typename T>
__device__ __forceinline__ void cp_async_elem(T* dst, const T* src) {
  if constexpr (sizeof(T) >= 4) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(src),
                 "n"(sizeof(T))
                 : "memory");
  } else {
    *dst = *src;
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

// Commits this thread's copies and waits for all of them.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_all;\n" ::: "memory");
}

// Elements before the first 16-byte boundary of p (p is aligned to T), at
// most count.
template <typename T>
__device__ __forceinline__ size_t head_elems(const void* p, size_t count) {
  const size_t h = ((16 - (reinterpret_cast<uintptr_t>(p) & 15)) & 15) / sizeof(T);
  return h < count ? h : count;
}

// count contiguous elements from g into s, where s = g modulo 16 bytes (the
// caller shifts its shared image by g's address modulo 16): 16-byte copies
// between an element-wise head and tail, spread over the CTA's threads.
template <typename T>
__device__ void load_span(T* s, const T* g, size_t count) {
  constexpr int kVec = 16 / sizeof(T);
  const size_t head = head_elems<T>(g, count);
  const size_t body = (count - head) / kVec * kVec;
  for (size_t e = threadIdx.x; e < head; e += blockDim.x) cp_async_elem(s + e, g + e);
  for (size_t k = threadIdx.x; k < body / kVec; k += blockDim.x)
    cp_async16(s + head + k * kVec, g + head + k * kVec);
  for (size_t e = head + body + threadIdx.x; e < count; e += blockDim.x)
    cp_async_elem(s + e, g + e);
}
