// Flash-attention backward with global position offsets: dq, and dk/dv
// summed over each GQA group, from the saved logsumexp.
//
// Replaces: ray_tpu/ops/attention.py _bwd_dq_kernel and _bwd_dkv_kernel,
// the Pallas TPU kernels driven by _flash_bwd.  bf16 with d = 64 or 128 on
// 16-byte-aligned tensors (the training path) runs flash_bwd_dq_sm90.cu
// and flash_bwd_sm90.cu instead, as ops/attention.py flash_variant decides.
//
// Both recompute p = exp(q k^T * scale - lse) tile by tile, so the s x s
// matrix never reaches device memory, and form
// ds = p * (do v^T - corr) * scale with corr = delta - dlse per query row
// (computed by the wrapper; delta = rowsum(do * out)).  Then
//   dq = ds k           (dq kernel: a block per query tile, keys looped)
//   dk = ds^T q, dv = p^T do   (dk/dv kernel: a block per key tile of one
//                        K/V head, looping over the query heads of its
//                        GQA group and the query tiles from the causal
//                        lower bound, so dk/dv come out [b, sk, hk, d]
//                        summed over the group without atomics).
// As the TPU kernels do: dq, dk, dv accumulate in fp32 and round once at
// the end; p is rounded to do's dtype before p^T do and ds to q's / k's
// dtype before its products.
//
// What bounds them on an H100: operations.  At the training shape (b = 8,
// s = 2048, 14 heads, d = 128, causal) dq is 3 products, 180 GFLOP
// against 294 MB, and dk/dv 4 products, 240 GFLOP against 352 MB: at
// 989 TFLOP/s and 3.35 TB/s the products take twice the time the bytes
// do.  So the bf16 kernels run every product on the tensor cores
// (mma.sync m16n8k16, bf16 operands, fp32 accumulation) with fragments
// laid out as in flash_fwd.cu.  fp32, and bf16 head dims the tensor-core
// kernels do not take, run on the CUDA cores in fp32.
//
// Masking is by selection: a row that saw no key has lse = -1e30, and
// exp(s - lse) is +inf there, so p is chosen as 0 (never multiplied by a
// 0/1 mask) wherever the key is not visible (global positions, col <=
// row, keys past sk) or the row's lse <= -5e29.  Such rows give zero
// gradient.  Tile bounds use floor division of possibly negative numbers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kDeadLse = kNegInf * 0.5f;

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

// Last key tile (exclusive) any row of query tile qi may see.
__device__ __forceinline__ int key_tile_end(int causal, int q_off, int kv_off,
                                            int qi, int bq, int bk, int nkt) {
  if (!causal) return nkt;
  const int row_max = q_off - kv_off + (qi + 1) * bq - 1;
  return max(0, min(floor_div(row_max, bk) + 1, nkt));
}

// First query tile whose last row may see key tile ki's first key.
__device__ __forceinline__ int query_tile_begin(int causal, int q_off,
                                                int kv_off, int ki, int bq,
                                                int bk, int nqt) {
  if (!causal) return 0;
  return max(0, min(floor_div(kv_off + ki * bk - q_off, bq), nqt));
}

// ---------------------------------------------------------------------------
// CUDA-core kernels (float32, and bf16 shapes the tensor-core kernels do
// not take).  32 rows per block, four threads per row, each holding every
// fourth float4 of the row (as flash_fwd.cu's CUDA-core kernel).
// ---------------------------------------------------------------------------

constexpr int kBQ = 32;
constexpr int kBK = 32;
constexpr int kSub = 4;
constexpr int kThreads = kBQ * kSub;

// Sum over the four threads of a row.  The butterfly gives every one of
// them the same bits.
__device__ __forceinline__ float row_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x;
}

template <typename T, int NCH>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ corr, T* __restrict__ dq,
                        int h, int hk, int sq, int sk, int d, int q_off,
                        int kv_off, int causal, float scale) {
  constexpr int DP = 16 * NCH;
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
  const int grow = q_off + qrow;
  const long long q_base = (((long long)bi * sq + qrow) * h + hi) * d;

  float qr[NCH][4], dor[NCH][4], acc[NCH][4];
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int dd = (sub + kSub * c) * 4 + e;
      const bool ok = row_ok && dd < d;
      qr[c][e] = ok ? to_float(q[q_base + dd]) : 0.f;
      dor[c][e] = ok ? to_float(dout[q_base + dd]) : 0.f;
      acc[c][e] = 0.f;
    }
  }
  const float lse_r = row_ok ? lse[(long long)bh * sq + qrow] : kNegInf;
  const float corr_r = row_ok ? corr[(long long)bh * sq + qrow] : 0.f;
  const bool live = lse_r > kDeadLse;

  const int nkt = (sk + kBK - 1) / kBK;
  const int hi_t = key_tile_end(causal, q_off, kv_off, qi, kBQ, kBK, nkt);
  for (int kt = 0; kt < hi_t; ++kt) {
    __syncthreads();
    for (int i = threadIdx.x; i < kBK * DP; i += kThreads) {
      const int j = i / DP;
      const int dd = i - j * DP;
      const int key = kt * kBK + j;
      float kx = 0.f, vx = 0.f;
      if (key < sk && dd < d) {
        const long long src = (((long long)bi * sk + key) * hk + kh) * d + dd;
        kx = to_float(k[src]);
        vx = to_float(v[src]);
      }
      k_tile[i] = kx;
      v_tile[i] = vx;
    }
    __syncthreads();

    for (int j = 0; j < kBK; ++j) {
      const float4* kr = reinterpret_cast<const float4*>(k_tile + j * DP);
      const float4* vr = reinterpret_cast<const float4*>(v_tile + j * DP);
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        const float4 kx = kr[sub + kSub * c];
        const float4 vx = vr[sub + kSub * c];
        s += qr[c][0] * kx.x + qr[c][1] * kx.y + qr[c][2] * kx.z +
             qr[c][3] * kx.w;
        dp += dor[c][0] * vx.x + dor[c][1] * vx.y + dor[c][2] * vx.z +
              dor[c][3] * vx.w;
      }
      s = row_sum(s);
      dp = row_sum(dp);
      const int key = kt * kBK + j;
      const bool vis =
          live && key < sk && (!causal || kv_off + key <= grow);
      const float p = vis ? expf(s * scale - lse_r) : 0.f;
      const float ds = round_to<T>(p * (dp - corr_r) * scale);
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        const float4 kx = kr[sub + kSub * c];
        acc[c][0] += ds * kx.x;
        acc[c][1] += ds * kx.y;
        acc[c][2] += ds * kx.z;
        acc[c][3] += ds * kx.w;
      }
    }
  }

  if (!row_ok) return;
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int dd = (sub + kSub * c) * 4 + e;
      if (dd < d) dq[q_base + dd] = from_float<T>(acc[c][e]);
    }
  }
}

template <typename T, int NCH>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ corr, T* __restrict__ dk,
                         T* __restrict__ dv, int h, int hk, int sq, int sk,
                         int d, int q_off, int kv_off, int causal,
                         float scale) {
  constexpr int DP = 16 * NCH;
  extern __shared__ __align__(16) float smem[];
  float* q_tile = smem;               // [kBQ][DP]
  float* do_tile = smem + kBQ * DP;   // [kBQ][DP]
  float* lse_s = smem + 2 * kBQ * DP; // [kBQ]
  float* corr_s = lse_s + kBQ;        // [kBQ]

  const int bkh = blockIdx.x;
  const int bi = bkh / hk;
  const int kh = bkh - bi * hk;
  const int group = h / hk;
  const int ki = blockIdx.y;
  const int row = threadIdx.x / kSub;
  const int sub = threadIdx.x % kSub;
  const int key = ki * kBK + row;
  const bool key_ok = key < sk;
  const int gcol = kv_off + key;
  const long long k_base = (((long long)bi * sk + key) * hk + kh) * d;

  float kr[NCH][4], vr[NCH][4], dka[NCH][4], dva[NCH][4];
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int dd = (sub + kSub * c) * 4 + e;
      const bool ok = key_ok && dd < d;
      kr[c][e] = ok ? to_float(k[k_base + dd]) : 0.f;
      vr[c][e] = ok ? to_float(v[k_base + dd]) : 0.f;
      dka[c][e] = 0.f;
      dva[c][e] = 0.f;
    }
  }

  const int nqt = (sq + kBQ - 1) / kBQ;
  const int lo = query_tile_begin(causal, q_off, kv_off, ki, kBQ, kBK, nqt);
  for (int gi = 0; gi < group; ++gi) {
    const int hi = kh * group + gi;
    const long long bh = (long long)bi * h + hi;
    for (int qt = lo; qt < nqt; ++qt) {
      __syncthreads();
      for (int i = threadIdx.x; i < kBQ * DP; i += kThreads) {
        const int j = i / DP;
        const int dd = i - j * DP;
        const int qrow = qt * kBQ + j;
        float qx = 0.f, dx = 0.f;
        if (qrow < sq && dd < d) {
          const long long src =
              (((long long)bi * sq + qrow) * h + hi) * d + dd;
          qx = to_float(q[src]);
          dx = to_float(dout[src]);
        }
        q_tile[i] = qx;
        do_tile[i] = dx;
      }
      if (threadIdx.x < kBQ) {
        const int qrow = qt * kBQ + threadIdx.x;
        lse_s[threadIdx.x] = qrow < sq ? lse[bh * sq + qrow] : kNegInf;
        corr_s[threadIdx.x] = qrow < sq ? corr[bh * sq + qrow] : 0.f;
      }
      __syncthreads();

      for (int i = 0; i < kBQ; ++i) {
        const float4* qx4 = reinterpret_cast<const float4*>(q_tile + i * DP);
        const float4* dx4 = reinterpret_cast<const float4*>(do_tile + i * DP);
        float s = 0.f, dp = 0.f;
#pragma unroll
        for (int c = 0; c < NCH; ++c) {
          const float4 qx = qx4[sub + kSub * c];
          const float4 dx = dx4[sub + kSub * c];
          s += kr[c][0] * qx.x + kr[c][1] * qx.y + kr[c][2] * qx.z +
               kr[c][3] * qx.w;
          dp += vr[c][0] * dx.x + vr[c][1] * dx.y + vr[c][2] * dx.z +
                vr[c][3] * dx.w;
        }
        s = row_sum(s);
        dp = row_sum(dp);
        const int qrow = qt * kBQ + i;
        const float lse_i = lse_s[i];
        const bool vis = key_ok && qrow < sq && lse_i > kDeadLse &&
                         (!causal || gcol <= q_off + qrow);
        const float p = vis ? expf(s * scale - lse_i) : 0.f;
        const float pr = round_to<T>(p);
        const float ds = round_to<T>(p * (dp - corr_s[i]) * scale);
#pragma unroll
        for (int c = 0; c < NCH; ++c) {
          const float4 qx = qx4[sub + kSub * c];
          const float4 dx = dx4[sub + kSub * c];
          dva[c][0] += pr * dx.x;
          dva[c][1] += pr * dx.y;
          dva[c][2] += pr * dx.z;
          dva[c][3] += pr * dx.w;
          dka[c][0] += ds * qx.x;
          dka[c][1] += ds * qx.y;
          dka[c][2] += ds * qx.z;
          dka[c][3] += ds * qx.w;
        }
      }
    }
  }

  if (!key_ok) return;
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int dd = (sub + kSub * c) * 4 + e;
      if (dd < d) {
        dk[k_base + dd] = from_float<T>(dka[c][e]);
        dv[k_base + dd] = from_float<T>(dva[c][e]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Tensor-core kernels (bf16, d = 16 * NK, NK <= 8).  mma.sync m16n8k16
// fragment layout (lane = 4 * g + t): A and C rows g and g + 8, columns
// 2t, 2t + 1 (A also 2t + 8, 2t + 9); B column g, rows 2t, 2t + 1 and
// 2t + 8, 2t + 9.  Tiles are staged row-major with rows padded by 16
// bytes, so the 32-bit fragment reads are free of bank conflicts.  A B
// operand read along a staged tile's columns (K in ds k, do and q in the
// dk/dv products) is gathered as two bf16 values per register.
// ---------------------------------------------------------------------------

constexpr int kTcRows = 64;  // 4 warps x 16 rows
constexpr int kTcThreads = 128;

__device__ __forceinline__ unsigned ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// Two bf16 values a stride apart, `p[0]` in the low half.
__device__ __forceinline__ unsigned gather2(const __nv_bfloat16* p,
                                            int stride) {
  return (unsigned)__bfloat16_as_ushort(p[0]) |
         ((unsigned)__bfloat16_as_ushort(p[stride]) << 16);
}

__device__ __forceinline__ void mma_16816(float c[4], const unsigned a[4],
                                          const unsigned b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Stage `rows` rows of a [.., n, heads, D] tensor (row r = position
// base + r of head `head`, zeros past n) into a [rows][D + 8] tile.
template <int D>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src,
                                           int rows, long long bi, int n,
                                           int heads, int head, int base) {
  constexpr int KS = D + 8;
  for (int i = threadIdx.x; i < rows * (D / 8); i += kTcThreads) {
    const int r = i / (D / 8);
    const int c = i - r * (D / 8);
    const int pos = base + r;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (pos < n)
      x = *reinterpret_cast<const uint4*>(
          src + ((bi * n + pos) * heads + head) * D + 8 * c);
    *reinterpret_cast<uint4*>(dst + r * KS + 8 * c) = x;
  }
}

template <int NK>
__global__ void __launch_bounds__(kTcThreads)
    flash_bwd_dq_tc_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           const __nv_bfloat16* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ corr,
                           __nv_bfloat16* __restrict__ dq, int h, int hk,
                           int sq, int sk, int q_off, int kv_off, int causal,
                           float scale) {
  constexpr int D = 16 * NK;
  constexpr int KS = D + 8;
  constexpr int BK = 64;
  constexpr int NT = BK / 8;   // key n-tiles of S per tile
  constexpr int KT = BK / 16;  // key k-steps of dS K per tile
  __shared__ __align__(16) __nv_bfloat16 k_s[BK * KS];
  __shared__ __align__(16) __nv_bfloat16 v_s[BK * KS];

  const int bh = blockIdx.x;
  const int bi = bh / h;
  const int hi = bh - bi * h;
  const int kh = hi / (h / hk);
  const int qi = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int row0 = qi * kTcRows + warp * 16 + g;  // rows row0, row0 + 8

  unsigned qa[NK][4], da[NK][4];
#pragma unroll
  for (int kk = 0; kk < NK; ++kk) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      const long long off =
          (((long long)bi * sq + row) * h + hi) * D + 16 * kk + 2 * t;
      const bool ok = row < sq;
      qa[kk][r] = ok ? ld32(q + off) : 0u;
      qa[kk][2 + r] = ok ? ld32(q + off + 8) : 0u;
      da[kk][r] = ok ? ld32(dout + off) : 0u;
      da[kk][2 + r] = ok ? ld32(dout + off + 8) : 0u;
    }
  }
  float lse_r[2], corr_r[2];
  bool live[2];
  int grow[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    lse_r[r] = row < sq ? lse[(long long)bh * sq + row] : kNegInf;
    corr_r[r] = row < sq ? corr[(long long)bh * sq + row] : 0.f;
    live[r] = lse_r[r] > kDeadLse;
    grow[r] = q_off + row;
  }
  float acc[2 * NK][4];
#pragma unroll
  for (int n = 0; n < 2 * NK; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  const int nkt = (sk + BK - 1) / BK;
  const int hi_t = key_tile_end(causal, q_off, kv_off, qi, kTcRows, BK, nkt);
  for (int kt = 0; kt < hi_t; ++kt) {
    __syncthreads();
    stage_rows<D>(k_s, k, BK, bi, sk, hk, kh, kt * BK);
    stage_rows<D>(v_s, v, BK, bi, sk, hk, kh, kt * BK);
    __syncthreads();

    // dS for this warp's 16 rows, one 8-key n-tile at a time, packed as
    // the A fragments of dS K (n-tiles 2kk and 2kk + 1 form k-step kk).
    unsigned dsa[KT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      float s[4] = {0.f, 0.f, 0.f, 0.f};
      float dp[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) {
        const int off = (8 * j + g) * KS + 16 * kk + 2 * t;
        const unsigned bk2[2] = {ld32(k_s + off), ld32(k_s + off + 8)};
        const unsigned bv2[2] = {ld32(v_s + off), ld32(v_s + off + 8)};
        mma_16816(s, qa[kk], bk2);
        mma_16816(dp, da[kk], bv2);
      }
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int key = kt * BK + 8 * j + 2 * t + (e & 1);
        const bool vis = live[r] && key < sk &&
                         (!causal || kv_off + key <= grow[r]);
        const float p = vis ? expf(s[e] * scale - lse_r[r]) : 0.f;
        ds[e] = p * (dp[e] - corr_r[r]) * scale;
      }
      dsa[j >> 1][(j & 1) * 2] = pack_bf16(ds[0], ds[1]);
      dsa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }
    // dq += dS K: B[key][dim] = K[key][dim], gathered down K's rows.
#pragma unroll
    for (int n = 0; n < 2 * NK; ++n) {
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
        const __nv_bfloat16* kc = k_s + (16 * kk + 2 * t) * KS + 8 * n + g;
        const unsigned b[2] = {gather2(kc, KS), gather2(kc + 8 * KS, KS)};
        mma_16816(acc[n], dsa[kk], b);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= sq) continue;
    __nv_bfloat16* dst = dq + (((long long)bi * sq + row) * h + hi) * D;
#pragma unroll
    for (int n = 0; n < 2 * NK; ++n)
      *reinterpret_cast<unsigned*>(dst + 8 * n + 2 * t) =
          pack_bf16(acc[n][2 * r], acc[n][2 * r + 1]);
  }
}

constexpr int kTcBQ = 64;  // query rows per staged tile of the dk/dv kernel

template <int NK>
constexpr size_t dkv_tc_smem() {
  return (size_t)(2 * kTcRows + 2 * kTcBQ) * (16 * NK + 8) *
             sizeof(__nv_bfloat16) +
         2 * kTcBQ * sizeof(float);
}

template <int NK>
__global__ void __launch_bounds__(kTcThreads)
    flash_bwd_dkv_tc_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v,
                            const __nv_bfloat16* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ corr,
                            __nv_bfloat16* __restrict__ dk,
                            __nv_bfloat16* __restrict__ dv, int h, int hk,
                            int sq, int sk, int q_off, int kv_off,
                            int causal, float scale) {
  constexpr int D = 16 * NK;
  constexpr int KS = D + 8;
  constexpr int NTQ = kTcBQ / 8;   // query n-tiles of S^T per tile
  constexpr int KTQ = kTcBQ / 16;  // query k-steps of P^T do per tile
  extern __shared__ __align__(16) __nv_bfloat16 tc_smem[];
  __nv_bfloat16* k_s = tc_smem;                 // [64][KS]
  __nv_bfloat16* v_s = k_s + kTcRows * KS;      // [64][KS]
  __nv_bfloat16* q_s = v_s + kTcRows * KS;      // [kTcBQ][KS]
  __nv_bfloat16* do_s = q_s + kTcBQ * KS;       // [kTcBQ][KS]
  float* lse_s = reinterpret_cast<float*>(do_s + kTcBQ * KS);
  float* corr_s = lse_s + kTcBQ;

  const int bkh = blockIdx.x;
  const int bi = bkh / hk;
  const int kh = bkh - bi * hk;
  const int group = h / hk;
  const int ki = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wrow = warp * 16 + g;            // tile rows wrow, wrow + 8
  const int key0 = ki * kTcRows + wrow;      // this thread's keys
  const int gcol[2] = {kv_off + key0, kv_off + key0 + 8};

  stage_rows<D>(k_s, k, kTcRows, bi, sk, hk, kh, ki * kTcRows);
  stage_rows<D>(v_s, v, kTcRows, bi, sk, hk, kh, ki * kTcRows);

  float dka[2 * NK][4], dva[2 * NK][4];
#pragma unroll
  for (int n = 0; n < 2 * NK; ++n) {
    dka[n][0] = dka[n][1] = dka[n][2] = dka[n][3] = 0.f;
    dva[n][0] = dva[n][1] = dva[n][2] = dva[n][3] = 0.f;
  }

  const int nqt = (sq + kTcBQ - 1) / kTcBQ;
  const int lo =
      query_tile_begin(causal, q_off, kv_off, ki, kTcBQ, kTcRows, nqt);
  for (int gi = 0; gi < group; ++gi) {
    const int hi = kh * group + gi;
    const long long bh = (long long)bi * h + hi;
    for (int qt = lo; qt < nqt; ++qt) {
      __syncthreads();  // every warp is done with the previous q tile
      stage_rows<D>(q_s, q, kTcBQ, bi, sq, h, hi, qt * kTcBQ);
      stage_rows<D>(do_s, dout, kTcBQ, bi, sq, h, hi, qt * kTcBQ);
      if (threadIdx.x < kTcBQ) {
        const int qrow = qt * kTcBQ + threadIdx.x;
        lse_s[threadIdx.x] = qrow < sq ? lse[bh * sq + qrow] : kNegInf;
        corr_s[threadIdx.x] = qrow < sq ? corr[bh * sq + qrow] : 0.f;
      }
      __syncthreads();

      // S^T = K Q^T and dP^T = V do^T for this warp's 16 keys, one 8-row
      // n-tile of queries at a time; P^T and dS^T packed as A fragments.
      unsigned pa[KTQ][4], dsa[KTQ][4];
#pragma unroll
      for (int j = 0; j < NTQ; ++j) {
        float st[4] = {0.f, 0.f, 0.f, 0.f};
        float dpt[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kk = 0; kk < NK; ++kk) {
          const int ao = wrow * KS + 16 * kk + 2 * t;
          const unsigned ak[4] = {ld32(k_s + ao), ld32(k_s + ao + 8 * KS),
                                  ld32(k_s + ao + 8),
                                  ld32(k_s + ao + 8 * KS + 8)};
          const unsigned av[4] = {ld32(v_s + ao), ld32(v_s + ao + 8 * KS),
                                  ld32(v_s + ao + 8),
                                  ld32(v_s + ao + 8 * KS + 8)};
          const int bo = (8 * j + g) * KS + 16 * kk + 2 * t;
          const unsigned bq2[2] = {ld32(q_s + bo), ld32(q_s + bo + 8)};
          const unsigned bd2[2] = {ld32(do_s + bo), ld32(do_s + bo + 8)};
          mma_16816(st, ak, bq2);
          mma_16816(dpt, av, bd2);
        }
        float p[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const int c = 8 * j + 2 * t + (e & 1);
          const int qrow = qt * kTcBQ + c;
          const float lse_i = lse_s[c];
          const bool vis = key0 + 8 * r < sk && qrow < sq &&
                           lse_i > kDeadLse &&
                           (!causal || gcol[r] <= q_off + qrow);
          p[e] = vis ? expf(st[e] * scale - lse_i) : 0.f;
          ds[e] = p[e] * (dpt[e] - corr_s[c]) * scale;
        }
        pa[j >> 1][(j & 1) * 2] = pack_bf16(p[0], p[1]);
        pa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
        dsa[j >> 1][(j & 1) * 2] = pack_bf16(ds[0], ds[1]);
        dsa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
      }
      // dv += P^T do and dk += dS^T q: B[qrow][dim], gathered down the
      // staged rows.
#pragma unroll
      for (int n = 0; n < 2 * NK; ++n) {
#pragma unroll
        for (int kk = 0; kk < KTQ; ++kk) {
          const int co = (16 * kk + 2 * t) * KS + 8 * n + g;
          const unsigned bd[2] = {gather2(do_s + co, KS),
                                  gather2(do_s + co + 8 * KS, KS)};
          const unsigned bq[2] = {gather2(q_s + co, KS),
                                  gather2(q_s + co + 8 * KS, KS)};
          mma_16816(dva[n], pa[kk], bd);
          mma_16816(dka[n], dsa[kk], bq);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    if (key >= sk) continue;
    const long long base = (((long long)bi * sk + key) * hk + kh) * D;
#pragma unroll
    for (int n = 0; n < 2 * NK; ++n) {
      *reinterpret_cast<unsigned*>(dk + base + 8 * n + 2 * t) =
          pack_bf16(dka[n][2 * r], dka[n][2 * r + 1]);
      *reinterpret_cast<unsigned*>(dv + base + 8 * n + 2 * t) =
          pack_bf16(dva[n][2 * r], dva[n][2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *corr;
  void *dq, *dk, *dv;
  int b, h, hk, sq, sk, d, q_off, kv_off, causal;
  float scale;
  cudaStream_t stream;
};

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, int NCH>
cudaError_t launch_cc(const Args& a, bool dkv) {
  const int DP = 16 * NCH;
  if (!dkv) {
    const size_t smem = 2 * (size_t)kBK * DP * sizeof(float);
    auto kernel = flash_bwd_dq_kernel<T, NCH>;
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    dim3 grid(a.b * a.h, (a.sq + kBQ - 1) / kBQ);
    kernel<<<grid, kThreads, smem, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
        a.corr, static_cast<T*>(a.dq), a.h, a.hk, a.sq, a.sk, a.d, a.q_off,
        a.kv_off, a.causal, a.scale);
    return cudaGetLastError();
  }
  const size_t smem = (2 * (size_t)kBQ * DP + 2 * kBQ) * sizeof(float);
  auto kernel = flash_bwd_dkv_kernel<T, NCH>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(a.b * a.hk, (a.sk + kBK - 1) / kBK);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.corr, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.h, a.hk, a.sq,
      a.sk, a.d, a.q_off, a.kv_off, a.causal, a.scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_cc(const Args& a, bool dkv) {
  const int nch = (a.d + 15) / 16;
  if (nch <= 1) return launch_cc<T, 1>(a, dkv);
  if (nch <= 2) return launch_cc<T, 2>(a, dkv);
  if (nch <= 4) return launch_cc<T, 4>(a, dkv);
  if (nch <= 8) return launch_cc<T, 8>(a, dkv);
  if (nch <= 16) return launch_cc<T, 16>(a, dkv);
  return cudaErrorInvalidValue;
}

template <int NK>
cudaError_t launch_tc(const Args& a, bool dkv) {
  typedef const __nv_bfloat16* In;
  if (!dkv) {
    dim3 grid(a.b * a.h, (a.sq + kTcRows - 1) / kTcRows);
    flash_bwd_dq_tc_kernel<NK><<<grid, kTcThreads, 0, a.stream>>>(
        static_cast<In>(a.q), static_cast<In>(a.k), static_cast<In>(a.v),
        static_cast<In>(a.dout), a.lse, a.corr,
        static_cast<__nv_bfloat16*>(a.dq), a.h, a.hk, a.sq, a.sk, a.q_off,
        a.kv_off, a.causal, a.scale);
    return cudaGetLastError();
  }
  const size_t smem = dkv_tc_smem<NK>();
  auto kernel = flash_bwd_dkv_tc_kernel<NK>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(a.b * a.hk, (a.sk + kTcRows - 1) / kTcRows);
  kernel<<<grid, kTcThreads, smem, a.stream>>>(
      static_cast<In>(a.q), static_cast<In>(a.k), static_cast<In>(a.v),
      static_cast<In>(a.dout), a.lse, a.corr,
      static_cast<__nv_bfloat16*>(a.dk), static_cast<__nv_bfloat16*>(a.dv),
      a.h, a.hk, a.sq, a.sk, a.q_off, a.kv_off, a.causal, a.scale);
  return cudaGetLastError();
}

cudaError_t dispatch_tc(const Args& a, bool dkv) {
  switch (a.d / 16) {
    case 1: return launch_tc<1>(a, dkv);
    case 2: return launch_tc<2>(a, dkv);
    case 3: return launch_tc<3>(a, dkv);
    case 4: return launch_tc<4>(a, dkv);
    case 5: return launch_tc<5>(a, dkv);
    case 6: return launch_tc<6>(a, dkv);
    case 7: return launch_tc<7>(a, dkv);
    case 8: return launch_tc<8>(a, dkv);
  }
  return cudaErrorInvalidValue;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

cudaError_t run(const Args& a, int dtype, bool dkv) {
  if (a.b <= 0 || (dkv ? a.sk : a.sq) <= 0) return cudaGetLastError();
  if (a.d <= 0 || a.d > 256 || a.h <= 0 || a.hk <= 0 || a.h % a.hk != 0 ||
      a.sq < 0 || a.sk < 0)
    return cudaErrorInvalidValue;
  if (dtype == 0) return dispatch_cc<float>(a, dkv);
  if (dtype != 1) return cudaErrorInvalidValue;
  const bool aligned = aligned16(a.q) && aligned16(a.k) && aligned16(a.v) &&
                       aligned16(a.dout) &&
                       aligned16(dkv ? a.dk : a.dq) &&
                       (!dkv || aligned16(a.dv));
  if (a.d % 16 == 0 && a.d <= 128 && aligned) return dispatch_tc(a, dkv);
  return dispatch_cc<__nv_bfloat16>(a, dkv);
}

}  // namespace

// q/do/dq: [b, sq, h, d]; k/v/dk/dv: [b, sk, hk, d]; lse, corr: [b * h,
// sq] float32 (corr = rowsum(do * out) - dlse).  dtype: 0 = float32,
// 1 = bfloat16.  Each returns a cudaError_t.
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* corr, void* dq, int b, int h, int hk,
                            int sq, int sk, int d, int q_off, int kv_off,
                            int causal, float scale, int dtype,
                            void* stream) {
  const Args a{q, k, v, dout, static_cast<const float*>(lse),
               static_cast<const float*>(corr), dq, nullptr, nullptr,
               b, h, hk, sq, sk, d, q_off, kv_off, causal, scale,
               static_cast<cudaStream_t>(stream)};
  return run(a, dtype, false);
}

extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* corr, void* dk, void* dv, int b,
                             int h, int hk, int sq, int sk, int d, int q_off,
                             int kv_off, int causal, float scale, int dtype,
                             void* stream) {
  const Args a{q, k, v, dout, static_cast<const float*>(lse),
               static_cast<const float*>(corr), nullptr, dk, dv,
               b, h, hk, sq, sk, d, q_off, kv_off, causal, scale,
               static_cast<cudaStream_t>(stream)};
  return run(a, dtype, true);
}
