// Flash-attention forward for Hopper: TMA-fed wgmma, bf16 with head dim 64
// or 128.  Same function as flash_fwd.cu's kernels: the output and the
// per-row logsumexp, masked in global positions.
//
// Replaces: ray_tpu/ops/attention.py _fwd_kernel, the Pallas TPU kernel
// driven by _flash_fwd, for the shapes both main paths use (Llama-2-7B
// serving and the 0.9B training config: bf16, d = 128).  fp32, other head
// dims and misaligned tensors stay on flash_fwd.cu.
//
// What bounds it on an H100: operations at training lengths (b = 8, s =
// 2048, 14 heads, d = 128, causal: 120 GFLOP against 240 MB), bytes and
// operations of one order at a 1,024-token prefill.  So the design feeds
// the tensor cores from shared memory without a register round trip:
//
//  - A block of two warpgroups (256 threads) owns 128 query rows of one
//    (batch, head), 64 rows per warpgroup.  Blocks run head by head, each
//    head's query tiles heaviest first, so the causal tail is light tiles
//    and the blocks on the card at once share a few heads' K/V in L2.
//  - Q (128 x d) is loaded once by TMA; K and V tiles of 128 keys go
//    through a ring of two stages, each load completing on its stage's
//    "full" mbarrier.  One thread issues tile j + 1 before the warpgroups
//    compute tile j, once the stage's "empty" mbarrier shows every thread
//    done with tile j - 1; no block-wide barrier.  (A third stage with a
//    staggered start, as in flash_bwd_sm90.cu, and software-pipelining
//    P V behind the next Q K^T both measured slower on the H100.)
//    Tensor maps describe the [b, s, h, d] tensors directly (sm90.cuh), so
//    rows past sq / sk arrive as zeros and GQA reads K/V head
//    h / (h_q / h_kv) in place.  At d = 128: Q 32 KB + 2 x (K 32 KB +
//    V 32 KB) = 160 KB of shared memory.
//  - S = Q K^T is one chain of m64n128k16 wgmma per warpgroup with both
//    operands K-major in shared memory; O += P V takes P from registers
//    (the S accumulator packs into A fragments pairwise) and V from shared
//    memory with the transpose bit, so nothing is transposed or gathered.
//  - The online softmax runs on the accumulator fragments: the row max
//    of the raw scores over the four threads of a row, then p = 2^(s c -
//    m c) with c = scale * log2(e), one FFMA and one ex2.approx per
//    score (the exponentials, 64 per thread per tile on the special-
//    function units, are the softmax's largest cost).  It masks only tiles
//    that straddle the diagonal or the sk edge (a masked score is -inf, so
//    its p is exactly 0), and rounds p to bf16 for P V as the TPU kernel
//    casts p to v's dtype.  lse = m scale + ln(l).
//
// As flash_fwd.cu: the causal tile bound floor((q_off - kv_off + last
// row) / 128) + 1, the running max seeded with -1e30, so a row that saw no
// key ends with out = 0 and lse = -1e30 exactly; a block whose rows see no
// key at all writes that and issues no load.
//
// Also here: wgmma_tile_test, one 64 x N x 64 product through the same
// TMA, descriptor and wgmma code, for the card tests.

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int kBQ = 128;  // query rows per block (two warpgroups of 64)
constexpr int kBK = 128;  // keys per K/V tile
constexpr int kStages = 2;  // K/V ring
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Smem {
  static constexpr int kQ = kBQ * D * 2;
  static constexpr int kKV = kBK * D * 2;  // one of K, V
  static constexpr int kStage = 2 * kKV;
  static constexpr size_t kBytes = kQ + kStages * kStage + 1024;  // + align
};

__device__ __forceinline__ char* align1024(char* p) {
  const uint32_t a = smem_u32(p);
  return p + ((1024 - (a & 1023)) & 1023);
}

// Key tiles (exclusive end) visible to block-local rows up to `last_row`.
__device__ __forceinline__ int key_tile_end(int causal, int q_off, int kv_off,
                                            int last_row, int nkt) {
  if (!causal) return nkt;
  return max(0, min(floor_div(q_off - kv_off + last_row, kBK) + 1, nkt));
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          __nv_bfloat16* __restrict__ out,
                          float* __restrict__ lse, int h, int hk, int sq,
                          int sk, int q_off, int kv_off, int causal,
                          float scale) {
  using S = Smem<D>;
  const float scale_log2 = scale * kLog2e;
  extern __shared__ char smem_raw[];
  // Q; per stage "full" (its K/V tile arrived) and "empty" (every thread
  // is done with it).
  __shared__ __align__(8) uint64_t bars[1 + 2 * kStages];
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + kStages;
  char* q_s = align1024(smem_raw);
  char* kv_s = q_s + S::kQ;  // stage st: K at st * kStage, V after it

  // One (batch x head) after another, its query tiles heaviest first:
  // the blocks on the card at once share a few heads' K/V in L2.
  const int nq = (sq + kBQ - 1) / kBQ;
  const int bh = blockIdx.x / nq;
  const int bi = bh / h;
  const int hi = bh - bi * h;
  const int kh = hi / (h / hk);
  const int qi = nq - 1 - (blockIdx.x - bh * nq);
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  // This thread's rows: row0 (accumulator values e < 2) and row0 + 8.
  const int row0 = qi * kBQ + wg * 64 + ((tid >> 5) & 3) * 16 + g;

  const int nkt = (sk + kBK - 1) / kBK;
  const int hi_t =
      key_tile_end(causal, q_off, kv_off, qi * kBQ + kBQ - 1, nkt);
  const int wg_hi =
      key_tile_end(causal, q_off, kv_off, qi * kBQ + wg * 64 + 63, nkt);

  if (hi_t == 0) {  // no row of the block sees a key: no load at all
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= sq) continue;
      __nv_bfloat16* dst = out + (((long long)bi * sq + row) * h + hi) * D;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<unsigned*>(dst + 8 * n + 2 * t) = 0u;
      if (t == 0) lse[(long long)bh * sq + row] = kNegInf;
    }
    return;
  }

  // K/V tile kt into its stage, once the tile kStages before it is done.
  // Thread 0 issues; only its warpgroup ever waits for the other, so the
  // two may drift a tile apart and overlap one's softmax with the other's
  // products.
  auto load_kv = [&](int kt) {
    const int st = kt % kStages;
    if (kt >= kStages) mbar_wait(&empty[st], (kt / kStages - 1) & 1);
    char* dst = kv_s + st * S::kStage;
    mbar_expect_tx(&full[st], S::kStage);
    tma_load_rows<D>(dst, &tm_k, &full[st], kBK, kh, kt * kBK, bi);
    tma_load_rows<D>(dst + S::kKV, &tm_v, &full[st], kBK, kh, kt * kBK, bi);
  };
  if (tid == 0) {
    mbar_init(&bars[0], 1);
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kThreads);
    }
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(&bars[0], S::kQ);
    tma_load_rows<D>(q_s, &tm_q, &bars[0], kBQ, hi, qi * kBQ, bi);
    for (int kt = 0; kt < kStages - 1 && kt < hi_t; ++kt) load_kv(kt);
  }

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  const uint32_t q_addr = smem_u32(q_s);
  mbar_wait(&bars[0], 0);

  for (int kt = 0; kt < hi_t; ++kt) {
    const int st = kt % kStages;
    if (tid == 0 && kt + kStages - 1 < hi_t) load_kv(kt + kStages - 1);
    // Every thread waits for every tile and releases it, even past its
    // warpgroup's causal bound, so no thread runs a ring ahead.
    mbar_wait(&full[st], (kt / kStages) & 1);
    if (kt >= wg_hi) {
      mbar_arrive(&empty[st]);
      continue;
    }
    const uint32_t k_addr = smem_u32(kv_s + st * S::kStage);
    const uint32_t v_addr = k_addr + S::kKV;

    // S = Q K^T for this warpgroup's 64 rows and the tile's 128 keys.
    float s[kBK / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<kBK>(s, desc_kmajor(q_addr, kBQ, wg * 64, kk),
                    desc_kmajor(k_addr, kBK, 0, kk), kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // Row max of the raw scores; mask only a tile that crosses the
    // diagonal or the sk edge for some row of this warpgroup.  A masked
    // score is -inf, so its p is exactly 0; the running max stays finite
    // (seeded with -1e30).
    const int key0 = kt * kBK;
    const bool edge =
        key0 + kBK > sk ||
        (causal && kv_off + key0 + kBK - 1 > q_off + qi * kBQ + wg * 64);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[4 * j + e];
        if (edge) {
          const int key = key0 + 8 * j + 2 * t + (e & 1);
          const bool vis =
              key < sk &&
              (!causal || kv_off + key <= q_off + row0 + 8 * (e >> 1));
          x = vis ? x : -INFINITY;
        }
        s[4 * j + e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2], ms[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = exp2_approx((m[r] - mx[r]) * scale_log2);
      m[r] = mx[r];
      ms[r] = mx[r] * scale_log2;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[4 * n] *= alpha[0];
      o[4 * n + 1] *= alpha[0];
      o[4 * n + 2] *= alpha[1];
      o[4 * n + 3] *= alpha[1];
    }
    // P = exp2(S scale log2(e) - m scale log2(e)) in fp32 for the sums,
    // bf16 as the A operand of P V.
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) {
      const float p = exp2_approx(s[i] * scale_log2 - ms[(i >> 1) & 1]);
      l[(i >> 1) & 1] += p;
      s[i] = p;
    }
    unsigned pa[kBK / 16][4];
    pack_a<kBK>(pa, s);

    // O += P V: V [keys, d] from shared memory, MN-major.
    wgmma_fence();
    fence_regs(o);
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      wgmma_rs<D>(o, pa[kk], desc_mnmajor(v_addr, kBK, kk), 1);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    mbar_arrive(&empty[st]);
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
    for (int n = 0; n < D / 8; ++n) {
      const float x0 = valid ? o[4 * n + 2 * r] / l_safe : 0.f;
      const float x1 = valid ? o[4 * n + 2 * r + 1] / l_safe : 0.f;
      *reinterpret_cast<unsigned*>(dst + 8 * n + 2 * t) = pack_bf16(x0, x1);
    }
    if (t == 0)
      lse[(long long)bh * sq + row] =
          (valid && l[r] > 0.f) ? m[r] * scale + logf(l_safe) : kNegInf;
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* lse, int b, int h, int hk, int sq, int sk,
                   int q_off, int kv_off, int causal, float scale,
                   cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  cudaError_t err = rows_map(&tq, q, b, sq, h, D, kBQ);
  if (sk == 0) {  // no key tile is ever loaded; an empty tensor has no base
    tk = tv = tq;
  } else {
    if (err == cudaSuccess) err = rows_map(&tk, k, b, sk, hk, D, kBK);
    if (err == cudaSuccess) err = rows_map(&tv, v, b, sk, hk, D, kBK);
  }
  auto kernel = flash_fwd_sm90_kernel<D>;
  if (err == cudaSuccess) err = allow_smem(kernel, Smem<D>::kBytes);
  if (err != cudaSuccess) return err;
  const int blocks = b * h * ((sq + kBQ - 1) / kBQ);
  kernel<<<blocks, kThreads, Smem<D>::kBytes, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), lse, h, hk, sq, sk,
      q_off, kv_off, causal, scale);
  return cudaGetLastError();
}

// One warpgroup: c[64, N] = a[64, 64] times b, where b is [N, 64] (MN =
// false: A and B K-major in shared memory) or [64, N] (MN = true: A from
// registers, B MN-major with the transpose bit).
template <int N, bool MN>
__global__ void __launch_bounds__(128)
    wgmma_tile_kernel(const __grid_constant__ CUtensorMap tm_a,
                      const __grid_constant__ CUtensorMap tm_b,
                      const __nv_bfloat16* __restrict__ a,
                      float* __restrict__ c) {
  extern __shared__ char smem_raw[];
  __shared__ __align__(8) uint64_t bar;
  char* a_s = align1024(smem_raw);
  char* b_s = a_s + 64 * 64 * 2;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int g = (tid & 31) >> 2;
  const int t = tid & 3;
  if (tid == 0) {
    mbar_init(&bar, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(&bar, 64 * 64 * 2 + N * 64 * 2);
    tma_load_rows<64>(a_s, &tm_a, &bar, 64, 0, 0, 0);
    if (MN)
      tma_load_rows<N>(b_s, &tm_b, &bar, 64, 0, 0, 0);
    else
      tma_load_rows<64>(b_s, &tm_b, &bar, N, 0, 0, 0);
  }
  unsigned af[4][4];
  const int r0 = 16 * warp + g;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r0 + 8 * (i & 1);
      const int col = 16 * kk + 2 * t + 8 * (i >> 1);
      af[kk][i] = *reinterpret_cast<const unsigned*>(a + row * 64 + col);
    }
  }
  mbar_wait(&bar, 0);
  const uint32_t a_addr = smem_u32(a_s), b_addr = smem_u32(b_s);
  float d[N / 2];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if (MN)
      wgmma_rs<N>(d, af[kk], desc_mnmajor(b_addr, 64, kk), kk > 0);
    else
      wgmma_ss<N>(d, desc_kmajor(a_addr, 64, 0, kk),
                  desc_kmajor(b_addr, N, 0, kk), kk > 0);
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(d);
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      c[(r0 + 8 * (e >> 1)) * N + 8 * j + 2 * t + (e & 1)] = d[4 * j + e];
  }
}

template <int N, bool MN>
cudaError_t launch_tile_test(const void* a, const void* b, float* c,
                             cudaStream_t stream) {
  CUtensorMap ta, tb;
  cudaError_t err = rows_map(&ta, a, 1, 64, 1, 64, 64);
  if (err == cudaSuccess)
    err = MN ? rows_map(&tb, b, 1, 64, 1, N, 64)
             : rows_map(&tb, b, 1, N, 1, 64, N);
  if (err != cudaSuccess) return err;
  const size_t smem = 64 * 64 * 2 + N * 64 * 2 + 1024;
  wgmma_tile_kernel<N, MN><<<1, 128, smem, stream>>>(
      ta, tb, static_cast<const __nv_bfloat16*>(a), c);
  return cudaGetLastError();
}

}  // namespace

// q/out: [b, sq, h, d]; k/v: [b, sk, hk, d], all bf16 and 16-byte
// aligned, d = 64 or 128; lse: [b * h, sq] float32.  Returns a
// cudaError_t (cudaErrorInvalidValue for a shape it does not take).
extern "C" int flash_fwd_sm90(const void* q, const void* k, const void* v,
                              void* out, void* lse, int b, int h, int hk,
                              int sq, int sk, int d, int q_off, int kv_off,
                              int causal, float scale, void* stream) {
  if (b <= 0 || sq <= 0) return cudaGetLastError();
  const void* ptrs[4] = {q, k, v, out};
  if (h <= 0 || hk <= 0 || h % hk != 0 || sk < 0 || !takes(d, ptrs, 4))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (d == 64)
    return launch<64>(q, k, v, out, l, b, h, hk, sq, sk, q_off, kv_off,
                      causal, scale, s);
  return launch<128>(q, k, v, out, l, b, h, hk, sq, sk, q_off, kv_off,
                     causal, scale, s);
}

// c [64, n] float32 = a [64, 64] times b (mn = 0: b is [n, 64], c = a b^T;
// mn = 1: b is [64, n], c = a b), bf16 a and b; n = 64 or 128.
extern "C" int wgmma_tile_test(const void* a, const void* b, void* c, int n,
                               int mn, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* cf = static_cast<float*>(c);
  if (n == 64)
    return mn ? launch_tile_test<64, true>(a, b, cf, s)
              : launch_tile_test<64, false>(a, b, cf, s);
  if (n == 128)
    return mn ? launch_tile_test<128, true>(a, b, cf, s)
              : launch_tile_test<128, false>(a, b, cf, s);
  return cudaErrorInvalidValue;
}
