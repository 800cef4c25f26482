// Decode-token K/V row write into a paged cache with fused-head rows
// (k_pages / v_pages: [num_pages, page, KVH * D]), and the same write
// folded into the decode step's rotary embedding.
//
// Replaces: ray_tpu/ops/paged_attention.py _row_write_kernel, the Pallas
// TPU kernel driven by write_token_rows.  Two C entry points share one
// kernel template:
//
//   - row_write (ROTATE = false): the plain row write, a byte copy of each
//     sequence's K and V rows into their page (write_token_rows);
//   - rope_row_write (ROTATE = true): what a decode layer does between
//     its Q/K/V projection and its attention, in one launch
//     (rope_write_token_rows): rotate the new token's q and k by the
//     rotary tables at p = max(pos, 0), write the rotated K row and the V
//     row into their page, and return the rotated q.
//
// What bounds it on an H100: launches.  At decode batch sizes a layer's
// rotary embedding and row write move under 1 MB (B = 16, Llama-2-7B,
// bf16: about 0.8 MB, 0.24 us at 3.35 TB/s), far below the card's
// per-launch floor of about 1.2 us, while the plain PyTorch sequence
// (two gathers of the tables, four products, a difference, a sum, a
// concatenation and a cast per tensor, then the write) is about 22
// launches per layer, each writing its intermediate to device memory.
// One launch per layer keeps every intermediate in registers.
//
// Design: the grid is (sequence, group of vectors), so that 8-16
// sequences spread over many of the 132 SMs.  A sequence's work is a flat
// list of 16-byte vectors: for each query head and each K head, the pairs
// (x[i], x[i + D/2]) of VEC lanes (8 bf16 or 4 fp32; elements pair by
// halves, not interleaved), then the V row (and, for row_write, the K
// row) as plain copies.  Neighbouring threads take neighbouring vectors,
// so loads and stores coalesce.  Each block reads its sequence's cos/sin
// row once into shared memory.  The rotation rounds as PyTorch's
// apply_rope does, product by product in fp32 (__fmul_rn, __fsub_rn,
// __fadd_rn: no FMA contraction), then once to the working dtype, so the
// result is bit-exact with the plain version.  Rows with pos < 0 go to
// the scratch page num_pages - 1, offset 0, as the TPU kernel routes
// them (concurrent duplicate writes there are benign: the engine never
// allocates or reads that page); their q is rotated at position 0 and is
// never read.  No host sync, no allocation, no attribute call: the
// launch can be captured in a CUDA graph.  Where an address or width is
// not 16-byte aligned, the same kernel runs with one lane per vector.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxHalf = 256;  // head_dim <= 512

template <int N> struct Pack;
template <> struct Pack<16> { using type = uint4; };
template <> struct Pack<8> { using type = uint2; };
template <> struct Pack<4> { using type = uint32_t; };
template <> struct Pack<2> { using type = uint16_t; };
template <> struct Pack<1> { using type = uint8_t; };

// VEC consecutive elements moved as one load or store.
template <typename T, int VEC>
__device__ __forceinline__ void move(T* dst, const T* src) {
  using P = typename Pack<sizeof(T) * VEC>::type;
  *reinterpret_cast<P*>(dst) = *reinterpret_cast<const P*>(src);
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// (x1, x2) -> (x1 c - x2 s, x2 c + x1 s) over VEC lanes, each product,
// difference and sum rounded in fp32 as PyTorch rounds them.
template <typename T, int VEC>
__device__ __forceinline__ void rotate(T* y1p, T* y2p, const T* x1p,
                                       const T* x2p, const float* c,
                                       const float* s) {
  alignas(sizeof(T) * VEC) T x1[VEC];
  alignas(sizeof(T) * VEC) T x2[VEC];
  alignas(sizeof(T) * VEC) T y1[VEC];
  alignas(sizeof(T) * VEC) T y2[VEC];
  move<T, VEC>(x1, x1p);
  move<T, VEC>(x2, x2p);
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const float a = to_float(x1[i]), b = to_float(x2[i]);
    y1[i] = from_float<T>(__fsub_rn(__fmul_rn(a, c[i]), __fmul_rn(b, s[i])));
    y2[i] = from_float<T>(__fadd_rn(__fmul_rn(b, c[i]), __fmul_rn(a, s[i])));
  }
  move<T, VEC>(y1p, y1);
  move<T, VEC>(y2p, y2);
}

struct Args {
  const void* q;  // [B, H, D] (ROTATE only)
  const void* k;  // [B, KVH * D]
  const void* v;  // [B, KVH * D]
  const float* cos;  // [max_len, D / 2] (ROTATE only)
  const float* sin;
  void* k_pages;
  void* v_pages;
  void* q_out;  // [B, H, D] (ROTATE only)
  const int* tables;     // [B, W]
  const int* positions;  // [B]
  int H, KVH, D, W, page, num_pages, max_len;
  long long page_stride;  // elements between pages
};

template <typename T, int VEC, bool ROTATE>
__global__ void __launch_bounds__(kThreads) row_write_kernel(Args a) {
  __shared__ float s_cos[ROTATE ? kMaxHalf : 1];
  __shared__ float s_sin[ROTATE ? kMaxHalf : 1];
  const int b = blockIdx.x;
  const int pos = a.positions[b];
  const int p = max(pos, 0);
  const int half = a.D / 2;
  const int kd = a.KVH * a.D;
  if constexpr (ROTATE) {
    // Clamped so that no read leaves the tables (the engine never
    // decodes past them).
    const long long r = (long long)min(p, a.max_len - 1) * half;
    for (int i = threadIdx.x; i < half; i += kThreads) {
      s_cos[i] = a.cos[r + i];
      s_sin[i] = a.sin[r + i];
    }
    __syncthreads();
  }
  int pg = a.num_pages - 1;
  int off = 0;
  if (pos >= 0) {
    pg = a.tables[(long long)b * a.W + min(p / a.page, a.W - 1)];
    off = p % a.page;
  }
  const bool to_page = pg >= 0 && pg < a.num_pages;  // never outside the pool
  const long long row = (long long)pg * a.page_stride + (long long)off * kd;
  T* k_dst = static_cast<T*>(a.k_pages) + row;
  T* v_dst = static_cast<T*>(a.v_pages) + row;
  const T* k_src = static_cast<const T*>(a.k) + (long long)b * kd;
  const T* v_src = static_cast<const T*>(a.v) + (long long)b * kd;
  const int per_half = half / VEC;
  const int n_rot = ROTATE ? (a.H + a.KVH) * per_half : 0;
  const int n_row = kd / VEC;
  const int n_task = n_rot + (ROTATE ? 1 : 2) * n_row;
  for (int t = blockIdx.y * kThreads + threadIdx.x; t < n_task;
       t += gridDim.y * kThreads) {
    if (t < n_rot) {
      if constexpr (ROTATE) {
        const int head = t / per_half;
        const int j = (t - head * per_half) * VEC;
        const T* src;
        T* dst;
        if (head < a.H) {
          const long long at = ((long long)b * a.H + head) * a.D;
          src = static_cast<const T*>(a.q) + at;
          dst = static_cast<T*>(a.q_out) + at;
        } else {
          if (!to_page) continue;
          src = k_src + (head - a.H) * a.D;
          dst = k_dst + (head - a.H) * a.D;
        }
        rotate<T, VEC>(dst + j, dst + half + j, src + j, src + half + j,
                       s_cos + j, s_sin + j);
      }
    } else if (to_page) {
      int c = t - n_rot;
      const T* src = v_src;
      T* dst = v_dst;
      if (!ROTATE) {
        if (c < n_row) {
          src = k_src;
          dst = k_dst;
        } else {
          c -= n_row;
        }
      }
      move<T, VEC>(dst + (long long)c * VEC, src + (long long)c * VEC);
    }
  }
}

template <typename T, int VEC, bool ROTATE>
int launch(const Args& a, int B, cudaStream_t stream) {
  const int per_half = a.D / 2 / VEC;
  const long long n_task =
      (ROTATE ? (long long)(a.H + a.KVH) * per_half : 0) +
      (ROTATE ? 1 : 2) * (long long)(a.KVH * a.D / VEC);
  const long long groups = (n_task + kThreads - 1) / kThreads;
  const dim3 grid(B, (unsigned)(groups < 1 ? 1 : groups > 65535 ? 65535
                                                                 : groups));
  row_write_kernel<T, VEC, ROTATE><<<grid, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// page_bytes: bytes between pages (the pages tensor's stride 0);
// row_bytes: bytes of one fused-head row.  A byte copy, whatever the
// dtype.  Returns a cudaError_t.
extern "C" int row_write(void* k_pages, void* v_pages, const void* k_new,
                         const void* v_new, const void* tables,
                         const void* positions, int B, int W, int page,
                         int num_pages, long long page_bytes, int row_bytes,
                         void* stream) {
  if (B <= 0) return cudaGetLastError();
  if (W <= 0 || page <= 0 || num_pages <= 0 || row_bytes <= 0)
    return cudaErrorInvalidValue;
  Args a = {};
  a.k = k_new;
  a.v = v_new;
  a.k_pages = k_pages;
  a.v_pages = v_pages;
  a.tables = static_cast<const int*>(tables);
  a.positions = static_cast<const int*>(positions);
  a.KVH = 1;
  a.D = row_bytes;
  a.W = W;
  a.page = page;
  a.num_pages = num_pages;
  a.page_stride = page_bytes;
  const uintptr_t bits = reinterpret_cast<uintptr_t>(k_pages) |
                         reinterpret_cast<uintptr_t>(v_pages) |
                         reinterpret_cast<uintptr_t>(k_new) |
                         reinterpret_cast<uintptr_t>(v_new) |
                         (uintptr_t)page_bytes | (uintptr_t)row_bytes;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((bits & 15) == 0) return launch<uint8_t, 16, false>(a, B, s);
  if ((bits & 3) == 0) return launch<uint8_t, 4, false>(a, B, s);
  return launch<uint8_t, 1, false>(a, B, s);
}

// q: [B, H, D]; k, v: [B, KVH, D]; cos, sin: fp32 [max_len, D / 2];
// q_out: [B, H, D]; page_stride: elements between pages.  All in one
// dtype (0 = float32, 1 = bfloat16), rows contiguous.  Returns a
// cudaError_t.
extern "C" int rope_row_write(const void* q, const void* k, const void* v,
                              const void* cos, const void* sin,
                              void* k_pages, void* v_pages, void* q_out,
                              const void* tables, const void* positions,
                              int B, int H, int KVH, int D, int W, int page,
                              int num_pages, long long page_stride,
                              int max_len, int dtype, void* stream) {
  if (B <= 0) return cudaGetLastError();
  if (H < 0 || KVH <= 0 || D <= 0 || D % 2 || D / 2 > kMaxHalf || W <= 0 ||
      page <= 0 || num_pages <= 0 || max_len <= 0 || dtype < 0 || dtype > 1)
    return cudaErrorInvalidValue;
  Args a = {q, k, v, static_cast<const float*>(cos),
            static_cast<const float*>(sin), k_pages, v_pages, q_out,
            static_cast<const int*>(tables),
            static_cast<const int*>(positions), H, KVH, D, W, page,
            num_pages, max_len, page_stride};
  const long long esize = dtype == 0 ? 4 : 2;
  const uintptr_t bits =
      reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
      reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(k_pages) |
      reinterpret_cast<uintptr_t>(v_pages) |
      reinterpret_cast<uintptr_t>(q_out) |
      (uintptr_t)(D / 2 * esize) | (uintptr_t)(page_stride * esize);
  const bool wide = (bits & 15) == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return wide ? launch<float, 4, true>(a, B, s)
                : launch<float, 1, true>(a, B, s);
  return wide ? launch<__nv_bfloat16, 8, true>(a, B, s)
              : launch<__nv_bfloat16, 1, true>(a, B, s);
}
