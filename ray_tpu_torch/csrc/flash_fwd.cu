// Flash-attention forward with global position offsets, returning the
// output and the per-row logsumexp.
//
// Replaces: ray_tpu/ops/attention.py _fwd_kernel, the Pallas TPU kernel
// driven by _flash_fwd.
//
// What bounds it on an H100: at prefill lengths the operations and the
// bytes are of one order (a causal 1,024-token segment does 2 * s * (s+1)
// * d flops per head on 4 * s * d elements: 34 GFLOP against 134 MB for
// b = 4, 32 heads, d = 128).  Either way the s x s score matrix never
// reaches device memory: that is the flash structure both kernels below
// keep.
//
// Two kernels, chosen by dtype and head dim.  bf16 with d = 64 or 128 on
// 16-byte-aligned tensors (both main paths) runs flash_fwd_sm90.cu
// instead, as ops/attention.py flash_variant decides:
//
//  - bf16 with d a multiple of 16 up to 128:
//    the tensor cores through mma.sync.m16n8k16 (bf16 operands, fp32
//    accumulation).  One block of 4 warps per (batch x head, 64 query
//    rows); each warp owns 16 rows, keeps its Q fragments and its fp32
//    output accumulator in registers, and walks 64-key tiles up to the
//    causal bound.  A tile's K is staged in shared memory row by row and
//    its V transposed, both padded so the fragment reads are free of bank
//    conflicts.  S = Q K^T and O += P V are mma.sync products; the online
//    softmax runs on the S fragments (row max and sums across the four
//    threads that share a row), and P is rounded to bf16 for P V, as the
//    TPU kernel casts p to v's dtype.
//  - every other shape and float32: the CUDA cores in fp32 (bf16
//    products are exact in fp32).  One block of 128 threads per
//    (batch x head, 32 query rows); four threads share a row, each
//    holding every fourth float4 of the row's q and accumulator; 32-key
//    tiles of K and V staged in shared memory as fp32.
//
// Both mask in global positions (col <= row, with q_off and kv_off given
// at run time; keys past sk are masked too), stop at the causal tile bound
// floor((q_off - kv_off + (qi + 1) * BQ - 1) / BK) + 1, and seed the
// running max with -1e30, so a row that saw no key ends with out = 0 and
// lse = -1e30 exactly, as the TPU kernel leaves it.  K/V heads may be
// fewer than query heads (GQA): query head h reads KV head
// h / (h_q / h_kv), so heads need no expanding first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 32;
constexpr int kBK = 32;
constexpr int kSub = 4;
constexpr int kThreads = kBQ * kSub;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

__device__ __forceinline__ int floor_div(int a, int b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

// ---------------------------------------------------------------------------
// CUDA-core kernel (float32, and bf16 shapes the tensor-core kernel does
// not take).  NCH: float4 chunks of the head dim per thread; d <= 16 * NCH.
// ---------------------------------------------------------------------------

template <typename T, int NCH>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out,
                     float* __restrict__ lse, int h, int hk, int sq, int sk,
                     int d, int q_off, int kv_off, int causal, float scale) {
  constexpr int DP = 16 * NCH;  // padded row width in floats
  extern __shared__ __align__(16) float smem[];
  float* k_tile = smem;             // [kBK][DP]
  float* v_tile = smem + kBK * DP;  // [kBK][DP]

  const int bh = blockIdx.x;
  const int bi = bh / h;
  const int hi = bh - bi * h;
  const int kh = hi / (h / hk);
  const int qi = blockIdx.y;
  const int row = threadIdx.x / kSub;
  const int sub = threadIdx.x % kSub;
  const int qrow = qi * kBQ + row;
  const bool row_ok = qrow < sq;
  const int grow = q_off + qrow;  // global position of this query row
  const long long q_base = (((long long)bi * sq + qrow) * h + hi) * d;

  // Thread `sub` owns float4 chunks sub, sub + 4, sub + 8, ... of the row:
  // the four threads of a row read four neighbouring float4s of a staged
  // K/V row, which keeps shared-memory reads free of bank conflicts.
  float qr[NCH][4];
  float acc[NCH][4];
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int dd = (sub + kSub * c) * 4 + e;
      qr[c][e] = (row_ok && dd < d) ? to_float(q[q_base + dd]) : 0.f;
      acc[c][e] = 0.f;
    }
  }
  float m = kNegInf;
  float l = 0.f;

  const int nkt = (sk + kBK - 1) / kBK;
  int hi_t = nkt;
  if (causal) {
    const int row_max = q_off - kv_off + (qi + 1) * kBQ - 1;
    hi_t = max(0, min(floor_div(row_max, kBK) + 1, nkt));
  }

  for (int kt = 0; kt < hi_t; ++kt) {
    __syncthreads();  // every thread is done with the previous tile
    for (int i = threadIdx.x; i < kBK * DP; i += kThreads) {
      const int j = i / DP;
      const int dd = i - j * DP;
      const int key = kt * kBK + j;
      float kx = 0.f;
      float vx = 0.f;
      if (key < sk && dd < d) {
        const long long src = (((long long)bi * sk + key) * hk + kh) * d + dd;
        kx = to_float(k[src]);
        vx = to_float(v[src]);
      }
      k_tile[i] = kx;
      v_tile[i] = vx;
    }
    __syncthreads();

    float s[kBK];
    float tmax = kNegInf;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      const float4* kr = reinterpret_cast<const float4*>(k_tile + j * DP);
      float part = 0.f;
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        const float4 kx = kr[sub + kSub * c];
        part += qr[c][0] * kx.x + qr[c][1] * kx.y + qr[c][2] * kx.z +
                qr[c][3] * kx.w;
      }
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      const int key = kt * kBK + j;
      const bool visible = key < sk && (!causal || kv_off + key <= grow);
      s[j] = visible ? part * scale : kNegInf;
      tmax = fmaxf(tmax, s[j]);
    }
    const float m_new = fmaxf(m, tmax);
    const float alpha = expf(m - m_new);
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c][e] *= alpha;
    }
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      const float p = expf(s[j] - m_new);
      psum += p;
      const float pv = round_to<T>(p);
      const float4* vr = reinterpret_cast<const float4*>(v_tile + j * DP);
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        const float4 vx = vr[sub + kSub * c];
        acc[c][0] += pv * vx.x;
        acc[c][1] += pv * vx.y;
        acc[c][2] += pv * vx.z;
        acc[c][3] += pv * vx.w;
      }
    }
    l = l * alpha + psum;
    m = m_new;
  }

  if (!row_ok) return;
  // A row whose running max never left the seed saw no visible key.
  const bool valid = m > kNegInf * 0.5f;
  const float l_safe = fmaxf(l, 1e-30f);
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int dd = (sub + kSub * c) * 4 + e;
      if (dd < d)
        out[q_base + dd] = from_float<T>(valid ? acc[c][e] / l_safe : 0.f);
    }
  }
  if (sub == 0)
    lse[(long long)bh * sq + qrow] =
        (valid && l > 0.f) ? m + logf(l_safe) : kNegInf;
}

// ---------------------------------------------------------------------------
// Tensor-core kernel (bf16, d = 16 * NK, NK <= 8)
// ---------------------------------------------------------------------------

constexpr int kTcBQ = 64;  // 4 warps x 16 rows
constexpr int kTcBK = 64;
constexpr int kTcThreads = 128;

__device__ __forceinline__ unsigned ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

// Two floats as one bf16x2 register, `lo` in the low half (the lower
// column of an mma fragment pair).
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// c += a (16x16, row-major fragment) * b (16x8, column-major fragment).
__device__ __forceinline__ void mma_16816(float c[4], const unsigned a[4],
                                          const unsigned b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// mma.sync fragment layout (lane = 4 * g + t): A and C rows g and g + 8,
// columns 2t, 2t + 1 (A also 2t + 8, 2t + 9); B column g, rows 2t, 2t + 1
// and 2t + 8, 2t + 9.
template <int NK>
__global__ void __launch_bounds__(kTcThreads)
    flash_fwd_tc_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        __nv_bfloat16* __restrict__ out,
                        float* __restrict__ lse, int h, int hk, int sq,
                        int sk, int q_off, int kv_off, int causal,
                        float scale) {
  constexpr int D = 16 * NK;
  constexpr int KS = D + 8;      // K row stride: 16 B pad, rows stay aligned
  constexpr int VS = kTcBK + 8;  // V^T row stride
  constexpr int NT = kTcBK / 8;  // key n-tiles of S per tile
  constexpr int KT = kTcBK / 16; // key k-steps of P V per tile
  __shared__ __align__(16) __nv_bfloat16 k_s[kTcBK * KS];
  __shared__ __align__(16) __nv_bfloat16 vt_s[D * VS];

  const int bh = blockIdx.x;
  const int bi = bh / h;
  const int hi = bh - bi * h;
  const int kh = hi / (h / hk);
  const int qi = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int row0 = qi * kTcBQ + warp * 16 + g;  // this thread's rows: +0, +8
  const int grow[2] = {q_off + row0, q_off + row0 + 8};

  unsigned qa[NK][4];
#pragma unroll
  for (int kk = 0; kk < NK; ++kk) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      const __nv_bfloat16* src =
          q + (((long long)bi * sq + row) * h + hi) * D + 16 * kk + 2 * t;
      qa[kk][r] = row < sq ? ld32(src) : 0u;
      qa[kk][2 + r] = row < sq ? ld32(src + 8) : 0u;
    }
  }
  float o[2 * NK][4];
#pragma unroll
  for (int n = 0; n < 2 * NK; ++n)
    o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};

  const int nkt = (sk + kTcBK - 1) / kTcBK;
  int hi_t = nkt;
  if (causal) {
    const int row_max = q_off - kv_off + (qi + 1) * kTcBQ - 1;
    hi_t = max(0, min(floor_div(row_max, kTcBK) + 1, nkt));
  }

  for (int kt = 0; kt < hi_t; ++kt) {
    __syncthreads();  // every warp is done with the previous tile
    // Stage K rows and V^T.  Consecutive threads take consecutive keys of
    // one 8-wide dim chunk, so the transposed V stores hit distinct banks.
    for (int i = threadIdx.x; i < kTcBK * (D / 8); i += kTcThreads) {
      const int c = i / kTcBK;
      const int r = i - c * kTcBK;
      const int key = kt * kTcBK + r;
      uint4 kx = make_uint4(0u, 0u, 0u, 0u);
      uint4 vx = make_uint4(0u, 0u, 0u, 0u);
      if (key < sk) {
        const long long src = (((long long)bi * sk + key) * hk + kh) * D + 8 * c;
        kx = *reinterpret_cast<const uint4*>(k + src);
        vx = *reinterpret_cast<const uint4*>(v + src);
      }
      *reinterpret_cast<uint4*>(k_s + r * KS + 8 * c) = kx;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vx);
#pragma unroll
      for (int e = 0; e < 8; ++e) vt_s[(8 * c + e) * VS + r] = ve[e];
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows and the tile's 64 keys.
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) {
        const __nv_bfloat16* kr = k_s + (8 * j + g) * KS + 16 * kk + 2 * t;
        const unsigned b[2] = {ld32(kr), ld32(kr + 8)};
        mma_16816(s[j], qa[kk], b);
      }
    }
    // Scale, mask in global positions, row max over the four threads of
    // a row.
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kt * kTcBK + 8 * j + 2 * t + (e & 1);
        const bool vis =
            key < sk && (!causal || kv_off + key <= grow[e >> 1]);
        s[j][e] = vis ? s[j][e] * scale : kNegInf;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = expf(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < 2 * NK; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }
    // P = exp(S - m) in fp32 for the sums, rounded to bf16 as the A
    // fragments of P V: n-tiles 2kk and 2kk + 1 form k-step kk.
    unsigned pa[KT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float p0 = expf(s[j][0] - m[0]);
      const float p1 = expf(s[j][1] - m[0]);
      const float p2 = expf(s[j][2] - m[1]);
      const float p3 = expf(s[j][3] - m[1]);
      l[0] += p0 + p1;
      l[1] += p2 + p3;
      pa[j >> 1][(j & 1) * 2] = pack_bf16(p0, p1);
      pa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p2, p3);
    }
    // O += P V, V^T rows as the column-major B fragments.
#pragma unroll
    for (int n = 0; n < 2 * NK; ++n) {
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
        const __nv_bfloat16* vr = vt_s + (8 * n + g) * VS + 16 * kk + 2 * t;
        const unsigned b[2] = {ld32(vr), ld32(vr + 8)};
        mma_16816(o[n], pa[kk], b);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= sq) continue;
    // A row whose running max never left the seed saw no visible key.
    const bool valid = m[r] > kNegInf * 0.5f;
    const float l_safe = fmaxf(l[r], 1e-30f);
    __nv_bfloat16* dst = out + (((long long)bi * sq + row) * h + hi) * D;
#pragma unroll
    for (int n = 0; n < 2 * NK; ++n) {
      const float x0 = valid ? o[n][2 * r] / l_safe : 0.f;
      const float x1 = valid ? o[n][2 * r + 1] / l_safe : 0.f;
      *reinterpret_cast<unsigned*>(dst + 8 * n + 2 * t) = pack_bf16(x0, x1);
    }
    if (t == 0)
      lse[(long long)bh * sq + row] =
          (valid && l[r] > 0.f) ? m[r] + logf(l_safe) : kNegInf;
  }
}

template <int NK>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* out,
                      float* lse, int b, int h, int hk, int sq, int sk,
                      int q_off, int kv_off, int causal, float scale,
                      cudaStream_t stream) {
  dim3 grid(b * h, (sq + kTcBQ - 1) / kTcBQ);
  flash_fwd_tc_kernel<NK><<<grid, kTcThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      lse, h, hk, sq, sk, q_off, kv_off, causal, scale);
  return cudaGetLastError();
}

cudaError_t dispatch_tc(const void* q, const void* k, const void* v,
                        void* out, float* lse, int b, int h, int hk, int sq,
                        int sk, int d, int q_off, int kv_off, int causal,
                        float scale, cudaStream_t stream) {
  switch (d / 16) {
#define FF_TC(N)                                                         \
  case N:                                                                \
    return launch_tc<N>(q, k, v, out, lse, b, h, hk, sq, sk, q_off, kv_off, \
                        causal, scale, stream)
    FF_TC(1);
    FF_TC(2);
    FF_TC(3);
    FF_TC(4);
    FF_TC(5);
    FF_TC(6);
    FF_TC(7);
    FF_TC(8);
#undef FF_TC
  }
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

template <typename T, int NCH>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* lse, int b, int h, int hk, int sq, int sk, int d,
                   int q_off, int kv_off, int causal, float scale,
                   cudaStream_t stream) {
  const size_t smem = 2 * (size_t)kBK * 16 * NCH * sizeof(float);
  auto kernel = flash_fwd_kernel<T, NCH>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  dim3 grid(b * h, (sq + kBQ - 1) / kBQ);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, h, hk, sq, sk, d,
      q_off, kv_off, causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* out,
                     float* lse, int b, int h, int hk, int sq, int sk, int d,
                     int q_off, int kv_off, int causal, float scale,
                     cudaStream_t stream) {
  const int nch = (d + 15) / 16;
#define FF_LAUNCH(N)                                                       \
  return launch<T, N>(q, k, v, out, lse, b, h, hk, sq, sk, d, q_off, kv_off, \
                      causal, scale, stream)
  if (nch <= 1) FF_LAUNCH(1);
  if (nch <= 2) FF_LAUNCH(2);
  if (nch <= 4) FF_LAUNCH(4);
  if (nch <= 8) FF_LAUNCH(8);
  if (nch <= 16) FF_LAUNCH(16);
#undef FF_LAUNCH
  return cudaErrorInvalidValue;
}

}  // namespace

// q/out: [b, sq, h, d]; k/v: [b, sk, hk, d]; lse: [b * h, sq] float32.
// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t.
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         void* out, void* lse, int b, int h, int hk, int sq,
                         int sk, int d, int q_off, int kv_off, int causal,
                         float scale, int dtype, void* stream) {
  if (b <= 0 || sq <= 0) return cudaGetLastError();
  if (d <= 0 || d > 256 || h <= 0 || hk <= 0 || h % hk != 0 || sk < 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == 0)
    return dispatch<float>(q, k, v, out, l, b, h, hk, sq, sk, d, q_off,
                           kv_off, causal, scale, s);
  const bool aligned = ((reinterpret_cast<uintptr_t>(q) |
                         reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v) |
                         reinterpret_cast<uintptr_t>(out)) % 16) == 0;
  if (dtype == 1 && d % 16 == 0 && d <= 128 && aligned)
    return dispatch_tc(q, k, v, out, l, b, h, hk, sq, sk, d, q_off, kv_off,
                       causal, scale, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, out, l, b, h, hk, sq, sk, d,
                                   q_off, kv_off, causal, scale, s);
  return cudaErrorInvalidValue;
}
