// Flash-attention dq for Hopper: TMA-fed wgmma, bf16 with head dim 64 or
// 128.  Same function as flash_bwd.cu's flash_bwd_dq: dq = dS K summed over
// the keys each query row sees, with p recomputed from the saved
// logsumexp, dS = p (dP - corr) scale and dP = dO V^T.
//
// Replaces: ray_tpu/ops/attention.py _bwd_dq_kernel, the Pallas TPU kernel
// driven by _flash_bwd, for the training path's shapes (bf16, d = 128).
// fp32, other head dims and misaligned tensors stay on flash_bwd.cu.
//
// What bounds it on an H100: operations (training shape b = 8, s = 2048,
// 14 heads, d = 128, causal: 3 products, 180 GFLOP against 295 MB).  The
// design:
//
//  - A block of two warpgroups (256 threads) owns 128 query rows of one
//    (batch, head), 64 rows per warpgroup, and loads their Q and dO once
//    by TMA; each thread keeps lse and corr of its two accumulator rows in
//    registers.  Blocks run head by head, each head's query tiles heaviest
//    first, so the causal tail is light tiles and the blocks on the card
//    at once share a few heads' K/V in L2.
//  - K and V tiles of 128 keys go through a ring of two TMA stages: one
//    thread issues tile j + 1 before the warpgroups compute tile j, once
//    every thread is done with tile j - 1 (per-stage "full" and "empty"
//    mbarriers, no block-wide barrier).  At d = 128: Q 32 KB + dO 32 KB +
//    2 x (K 32 KB + V 32 KB) = 192 KB.  GQA reads K/V head h / (h_q /
//    h_kv) in place; rows past sq / sk arrive as zeros.  (64-key tiles in
//    a ring of three or four stages measured ~10 % slower on the H100.)
//  - The two warpgroups run their first tile staggered (warpgroup 1
//    starts once warpgroup 0 has formed its P), so one's exponentials
//    overlap the other's products instead of both waiting on the same
//    (released earlier or later, or not at all, it measured slower).
//  - S = Q K^T and dP = dO V^T are m64n128k16 wgmma chains with both
//    operands K-major in shared memory; dP is issued before the
//    exponentials of S, so P is formed while dP is in flight.  P = 2^(S
//    scale log2(e) - lse log2(e)) (ex2.approx), dS = P (dP - corr) scale,
//    rounded to bf16 as the TPU kernel rounds it and packed into A
//    fragments.
//  - dQ += dS K takes dS from registers and the same K tile from shared
//    memory read MN-major (the transpose bit, the 64-column boxes LBO
//    apart): no operand is gathered.  dQ accumulates in fp32 registers
//    (64 x d per warpgroup) and rounds once at the end.
//
// Masking is by selection, as flash_bwd.cu: p = 0 wherever the key is not
// visible (global positions, col <= row, keys past sk) or the row's lse
// <= -5e29, never a product with a 0/1 mask (a row that saw no key has
// lse = -1e30 and exp2 would give +inf).  Only tiles that cross the
// diagonal or the sk edge test positions.  A row that sees no key comes
// out exactly 0; a block whose rows see no key writes zeros and issues no
// load.

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int kBQ = 128;    // query rows per block (two warpgroups of 64)
constexpr int kBK = 128;    // keys per K/V tile
constexpr int kStages = 2;  // K/V ring, one tile issued ahead
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;
constexpr float kDeadLse = kNegInf * 0.5f;
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Smem {
  static constexpr int kQ = kBQ * D * 2;   // one of Q, dO
  static constexpr int kKV = kBK * D * 2;  // one of K, V
  static constexpr int kStage = 2 * kKV;
  static constexpr size_t kBytes = 2 * kQ + kStages * kStage + 1024;
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
    flash_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                             const __grid_constant__ CUtensorMap tm_k,
                             const __grid_constant__ CUtensorMap tm_v,
                             const __grid_constant__ CUtensorMap tm_do,
                             const float* __restrict__ lse,
                             const float* __restrict__ corr,
                             __nv_bfloat16* __restrict__ dq, int h, int hk,
                             int sq, int sk, int q_off, int kv_off,
                             int causal, float scale) {
  using S = Smem<D>;
  extern __shared__ char smem_raw[];
  // Q and dO; per stage "full" (its K/V tile arrived) and "empty" (every
  // thread is done with it).
  __shared__ __align__(8) uint64_t qdo_bar, full[kStages], empty[kStages];
  char* q_s = align1024(smem_raw);
  char* do_s = q_s + S::kQ;
  char* kv_s = do_s + S::kQ;  // stage st: K at st * kStage, V after it

  // One (batch x head) after another, its query tiles heaviest first.
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
  const int wrow = qi * kBQ + wg * 64;  // this warpgroup's first row
  // This thread's rows: row0 (accumulator values e < 2) and row0 + 8.
  const int row0 = wrow + ((tid >> 5) & 3) * 16 + g;

  const int nkt = (sk + kBK - 1) / kBK;
  const int hi_t =
      key_tile_end(causal, q_off, kv_off, qi * kBQ + kBQ - 1, nkt);
  const int wg_hi = key_tile_end(causal, q_off, kv_off, wrow + 63, nkt);

  if (hi_t == 0) {  // no row of the block sees a key: no load at all
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= sq) continue;
      __nv_bfloat16* dst = dq + (((long long)bi * sq + row) * h + hi) * D;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<unsigned*>(dst + 8 * n + 2 * t) = 0u;
    }
    return;
  }

  // K/V tile kt into its stage, once the tile kStages before it is done.
  // Thread 0 issues; only its warpgroup ever waits for the other, so the
  // two may drift a tile apart.
  auto load_kv = [&](int kt) {
    const int st = kt % kStages;
    if (kt >= kStages) mbar_wait(&empty[st], (kt / kStages - 1) & 1);
    char* dst = kv_s + st * S::kStage;
    mbar_expect_tx(&full[st], S::kStage);
    tma_load_rows<D>(dst, &tm_k, &full[st], kBK, kh, kt * kBK, bi);
    tma_load_rows<D>(dst + S::kKV, &tm_v, &full[st], kBK, kh, kt * kBK, bi);
  };
  if (tid == 0) {
    mbar_init(&qdo_bar, 1);
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kThreads);
    }
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(&qdo_bar, 2 * S::kQ);
    tma_load_rows<D>(q_s, &tm_q, &qdo_bar, kBQ, hi, qi * kBQ, bi);
    tma_load_rows<D>(do_s, &tm_do, &qdo_bar, kBQ, hi, qi * kBQ, bi);
    load_kv(0);
  }

  // lse (pre-scaled by log2(e)) and corr of this thread's two rows; a row
  // past sq is dead, as a row that saw no key.
  float lse2[2], corr_r[2];
  bool live[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    const long long at = (long long)bh * sq + row;
    const float l = row < sq ? lse[at] : kNegInf;
    live[r] = l > kDeadLse;
    lse2[r] = l * kLog2e;
    corr_r[r] = row < sq ? corr[at] : 0.f;
  }
  float dqa[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dqa[i] = 0.f;
  const uint32_t q_addr = smem_u32(q_s), do_addr = smem_u32(do_s);
  const float scale_log2 = scale * kLog2e;
  mbar_wait(&qdo_bar, 0);

  if (wg == 1) stagger_wait();
  for (int kt = 0; kt < hi_t; ++kt) {
    const int st = kt % kStages;
    if (tid == 0 && kt + 1 < hi_t) load_kv(kt + 1);
    // Every thread waits for every tile and releases it, even past its
    // warpgroup's causal bound, so no thread runs a ring ahead.
    mbar_wait(&full[st], (kt / kStages) & 1);
    if (kt == 0 && wg == 0 && kt >= wg_hi) stagger_release();
    if (kt < wg_hi) {  // else no key of the tile is visible to these rows
      const uint32_t k_addr = smem_u32(kv_s + st * S::kStage);
      const uint32_t v_addr = k_addr + S::kKV;

      // S = Q K^T and dP = dO V^T: this warpgroup's 64 rows x 128 keys, two
      // groups, so P is computed while dP is still in flight.
      float s[kBK / 2], dp[kBK / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<kBK>(s, desc_kmajor(q_addr, kBQ, wg * 64, kk),
                      desc_kmajor(k_addr, kBK, 0, kk), kk > 0);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<kBK>(dp, desc_kmajor(do_addr, kBQ, wg * 64, kk),
                      desc_kmajor(v_addr, kBK, 0, kk), kk > 0);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(s);

      // P, selected: mask only a tile that crosses the diagonal or the sk
      // edge for some row of this warpgroup.
      const int key0 = kt * kBK;
      const bool edge = key0 + kBK > sk ||
                        (causal && kv_off + key0 + kBK - 1 > q_off + wrow);
#pragma unroll
      for (int jj = 0; jj < kBK / 8; ++jj) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          bool keep = live[r];
          if (edge) {
            const int key = key0 + 8 * jj + 2 * t + (e & 1);
            keep = keep && key < sk &&
                   (!causal || kv_off + key <= q_off + row0 + 8 * r);
          }
          const int i = 4 * jj + e;
          s[i] = keep ? exp2_approx(s[i] * scale_log2 - lse2[r]) : 0.f;
        }
      }
      if (kt == 0 && wg == 0) stagger_release();  // P of tile 0 is done
      wgmma_wait<0>();
      fence_regs(dp);

      // dS = P (dP - corr) scale, as A fragments of dS K.
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i)
        dp[i] = s[i] * (dp[i] - corr_r[(i >> 1) & 1]) * scale;
      unsigned dsa[kBK / 16][4];
      pack_a<kBK>(dsa, dp);

      // dQ += dS K (K MN-major).
      wgmma_fence();
      fence_regs(dqa);
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        wgmma_rs<D>(dqa, dsa[kk], desc_mnmajor(k_addr, kBK, kk), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dqa);
    }
    mbar_arrive(&empty[st]);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= sq) continue;
    __nv_bfloat16* dst = dq + (((long long)bi * sq + row) * h + hi) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<unsigned*>(dst + 8 * n + 2 * t) =
          pack_bf16(dqa[4 * n + 2 * r], dqa[4 * n + 2 * r + 1]);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* corr,
                   void* dq, int b, int h, int hk, int sq, int sk, int q_off,
                   int kv_off, int causal, float scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err = rows_map(&tq, q, b, sq, h, D, kBQ);
  if (err == cudaSuccess) err = rows_map(&tdo, dout, b, sq, h, D, kBQ);
  if (sk == 0) {  // no key tile is ever loaded; an empty tensor has no base
    tk = tv = tq;
  } else {
    if (err == cudaSuccess) err = rows_map(&tk, k, b, sk, hk, D, kBK);
    if (err == cudaSuccess) err = rows_map(&tv, v, b, sk, hk, D, kBK);
  }
  auto kernel = flash_bwd_dq_sm90_kernel<D>;
  if (err == cudaSuccess) err = allow_smem(kernel, Smem<D>::kBytes);
  if (err != cudaSuccess) return err;
  const int blocks = b * h * ((sq + kBQ - 1) / kBQ);
  kernel<<<blocks, kThreads, Smem<D>::kBytes, stream>>>(
      tq, tk, tv, tdo, lse, corr, static_cast<__nv_bfloat16*>(dq), h, hk, sq,
      sk, q_off, kv_off, causal, scale);
  return cudaGetLastError();
}

}  // namespace

// q/do/dq: [b, sq, h, d]; k/v: [b, sk, hk, d], all bf16 and 16-byte
// aligned, d = 64 or 128; lse, corr: [b * h, sq] float32 (corr =
// rowsum(do * out) - dlse).  Returns a cudaError_t
// (cudaErrorInvalidValue for a shape it does not take).
extern "C" int flash_bwd_dq_sm90(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* corr, void* dq, int b, int h,
                                 int hk, int sq, int sk, int d, int q_off,
                                 int kv_off, int causal, float scale,
                                 void* stream) {
  if (b <= 0 || sq <= 0) return cudaGetLastError();
  const void* ptrs[5] = {q, k, v, dout, dq};
  if (h <= 0 || hk <= 0 || h % hk != 0 || sk < 0 || !takes(d, ptrs, 5))
    return cudaErrorInvalidValue;
  const float* l = static_cast<const float*>(lse);
  const float* c = static_cast<const float*>(corr);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64)
    return launch<64>(q, k, v, dout, l, c, dq, b, h, hk, sq, sk, q_off,
                      kv_off, causal, scale, s);
  return launch<128>(q, k, v, dout, l, c, dq, b, h, hk, sq, sk, q_off,
                     kv_off, causal, scale, s);
}
