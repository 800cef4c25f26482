// Flash-attention dk/dv for Hopper: TMA-fed wgmma, bf16 with head dim 64
// or 128.  Same function as flash_bwd.cu's flash_bwd_dkv: dk = ds^T q and
// dv = p^T do per K/V head, summed over its GQA group's query heads,
// with p recomputed from the saved logsumexp.
//
// Replaces: ray_tpu/ops/attention.py _bwd_dkv_kernel, the Pallas TPU
// kernel driven by _flash_bwd, for the training path's shapes (bf16,
// d = 128).  fp32, other head dims and misaligned tensors stay on
// flash_bwd.cu; dq has its own Hopper kernel, flash_bwd_dq_sm90.cu.
//
// What bounds it on an H100: operations (training shape b = 8, s = 2048,
// 14 heads, d = 128, causal: 4 products, 240 GFLOP against 352 MB).  The
// design:
//
//  - A block of two warpgroups (256 threads) owns 128 keys of one (batch,
//    K/V head), 64 keys per warpgroup, and loads their K and V once by
//    TMA.  It loops over the group's query heads and, for each, the query
//    tiles of 64 rows from the causal lower bound; a warpgroup skips the
//    tiles before its own 64 keys' bound.  Blocks run head by head, each
//    head's key blocks in order (the first have the most query tiles), so
//    the blocks on the card at once share a few heads' Q and dO in L2.
//  - Q and dO tiles go through a ring of three TMA stages: one thread
//    issues tile j + 1 before the warpgroups compute tile j, once every
//    thread is done with tile j - 2 (per-stage "full" and "empty"
//    mbarriers, no block-wide barrier).  The tile's lse and corr (64
//    floats each) are plain loads issued a tile ahead, stored to the stage
//    and published on its "full" mbarrier.  At d = 128: K 32 KB + V 32 KB
//    + 3 x (Q 16 KB + dO 16 KB) = 160 KB.
//  - The two warpgroups run their first tile staggered (warpgroup 1
//    starts once warpgroup 0 has formed its P^T), and the ring lets them
//    stay a fraction of a tile apart: one's exponentials overlap the
//    other's products instead of both waiting on the same.  Inside a
//    warpgroup, P^T is formed while dP^T is in flight and dS^T while dV's
//    product is.
//  - S^T = K Q^T and dP^T = V dO^T are m64n64k16 wgmma chains with both
//    operands K-major in shared memory.  P^T = 2^(S^T scale log2(e) -
//    lse log2(e)) (ex2.approx) and dS^T = P^T (dP^T - corr) scale, with
//    lse and corr per column.  dV += P^T dO and dK += dS^T Q take P^T and dS^T from
//    registers (accumulators packed into A fragments) and dO, Q from
//    shared memory with the transpose bit: no operand is gathered.
//  - dK and dV accumulate in fp32 registers (64 x d per warpgroup) and
//    round once at the end; p is rounded to do's dtype and ds to q's
//    before their products, as the TPU kernels round them.
//
// Masking is by selection, as flash_bwd.cu: p = 0 wherever the key is not
// visible (global positions, col <= row, keys past sk) or the row's lse
// <= -5e29, never a product with a 0/1 mask (a row that saw no key has
// lse = -1e30 and exp2 would give +inf).  A block whose keys no query row
// sees writes zeros and issues no load.

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int kBKey = 128;  // keys per block (two warpgroups of 64)
constexpr int kBQ = 64;     // query rows per tile
constexpr int kStages = 3;  // Q/dO ring, one tile issued ahead
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;
constexpr float kDeadLse = kNegInf * 0.5f;
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Smem {
  static constexpr int kKV = kBKey * D * 2;  // one of K, V
  static constexpr int kQ = kBQ * D * 2;     // one of Q, dO
  static constexpr int kStage = 2 * kQ;
  static constexpr size_t kBytes = 2 * kKV + kStages * kStage + 1024;
};

__device__ __forceinline__ char* align1024(char* p) {
  const uint32_t a = smem_u32(p);
  return p + ((1024 - (a & 1023)) & 1023);
}

// First query tile whose last row may see the key at block-local
// position `key`.
__device__ __forceinline__ int query_tile_begin(int causal, int q_off,
                                                int kv_off, int key,
                                                int nqt) {
  if (!causal) return 0;
  return max(0, min(floor_div(kv_off + key - q_off, kBQ), nqt));
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                              const __grid_constant__ CUtensorMap tm_k,
                              const __grid_constant__ CUtensorMap tm_v,
                              const __grid_constant__ CUtensorMap tm_do,
                              const float* __restrict__ lse,
                              const float* __restrict__ corr,
                              __nv_bfloat16* __restrict__ dk,
                              __nv_bfloat16* __restrict__ dv, int h, int hk,
                              int sq, int sk, int q_off, int kv_off,
                              int causal, float scale) {
  using S = Smem<D>;
  extern __shared__ char smem_raw[];
  // K/V; per stage "full" (Q, dO, lse and corr arrived) and "empty"
  // (every thread is done with it).
  __shared__ __align__(8) uint64_t kv_bar, full[kStages], empty[kStages];
  __shared__ __align__(16) float lse_s[kStages][kBQ];
  __shared__ __align__(16) float corr_s[kStages][kBQ];
  char* k_s = align1024(smem_raw);
  char* v_s = k_s + S::kKV;
  char* qdo_s = v_s + S::kKV;  // stage st: Q at st * kStage, dO after it

  // One (batch x K/V head) after another, its key blocks in order (the
  // first have the most query tiles): the blocks on the card at once share
  // a few heads' Q and dO in L2.
  const int nk = (sk + kBKey - 1) / kBKey;
  const int bkh = blockIdx.x / nk;
  const int bi = bkh / hk;
  const int kh = bkh - bi * hk;
  const int group = h / hk;
  const int ki = blockIdx.x - bkh * nk;
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wkey = ki * kBKey + wg * 64;  // this warpgroup's first key
  // This thread's keys: key0 (accumulator values e < 2) and key0 + 8.
  const int key0 = wkey + ((tid >> 5) & 3) * 16 + g;

  const int nqt = (sq + kBQ - 1) / kBQ;
  const int lo = query_tile_begin(causal, q_off, kv_off, ki * kBKey, nqt);
  const int wg_lo = query_tile_begin(causal, q_off, kv_off, wkey, nqt);
  const int per_head = nqt - lo;
  const int n_tiles = group * per_head;

  if (n_tiles == 0) {  // no query row sees these keys: no load at all
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = key0 + 8 * r;
      if (key >= sk) continue;
      const long long base = (((long long)bi * sk + key) * hk + kh) * D;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        *reinterpret_cast<unsigned*>(dk + base + 8 * n + 2 * t) = 0u;
        *reinterpret_cast<unsigned*>(dv + base + 8 * n + 2 * t) = 0u;
      }
    }
    return;
  }

  // Tile j of the loop: query head kh * group + j / per_head, query tile
  // lo + j % per_head, in stage j % kStages.  Its Q and dO arrive by TMA,
  // issued by thread 0; its lse and corr by plain loads of 128 threads
  // (0-63 lse, 128-191 corr), stored to the stage and published by their
  // arrivals on the stage's "full" mbarrier beside the TMA bytes.  Every
  // thread arrives on the stage's "empty" mbarrier when done with it; the
  // next tile into the stage waits for that.  No block-wide barrier: only
  // the issuing threads ever wait for the other warpgroup, so the two may
  // drift a tile apart and overlap one's exponentials with the other's
  // products.
  const bool row_loader = (tid & 127) < kBQ;
  const int c_ld = tid & (kBQ - 1);
  float* row_dst = (wg == 0 ? &lse_s[0][0] : &corr_s[0][0]) + c_ld;
  auto row_value = [&](int j) {
    const int gi = j / per_head;
    const int qrow = (lo + j - gi * per_head) * kBQ + c_ld;
    const long long at = ((long long)bi * h + kh * group + gi) * sq + qrow;
    if (wg == 0) return qrow < sq ? lse[at] : kNegInf;
    return qrow < sq ? corr[at] : 0.f;
  };
  auto wait_free = [&](int j) {  // the tile kStages before j is done
    if (j >= kStages)
      mbar_wait(&empty[j % kStages], (j / kStages - 1) & 1);
  };
  auto load_tile = [&](int j) {
    const int gi = j / per_head;
    const int qt = lo + j - gi * per_head;
    uint64_t* bar = &full[j % kStages];
    char* dst = qdo_s + (j % kStages) * S::kStage;
    wait_free(j);
    mbar_expect_tx(bar, S::kStage);
    tma_load_rows<D>(dst, &tm_q, bar, kBQ, kh * group + gi, qt * kBQ, bi);
    tma_load_rows<D>(dst + S::kQ, &tm_do, bar, kBQ, kh * group + gi,
                     qt * kBQ, bi);
  };
  auto store_rows = [&](int j, float value) {
    wait_free(j);
    row_dst[(j % kStages) * kBQ] = value;
    mbar_arrive(&full[j % kStages]);
  };

  if (tid == 0) {
    mbar_init(&kv_bar, 1);
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], 1 + 2 * kBQ);  // expect_tx + the row loaders
      mbar_init(&empty[i], kThreads);
    }
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(&kv_bar, 2 * S::kKV);
    tma_load_rows<D>(k_s, &tm_k, &kv_bar, kBKey, kh, ki * kBKey, bi);
    tma_load_rows<D>(v_s, &tm_v, &kv_bar, kBKey, kh, ki * kBKey, bi);
    load_tile(0);
  }
  if (row_loader) store_rows(0, row_value(0));

  float dka[D / 2], dva[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;
  const uint32_t k_addr = smem_u32(k_s), v_addr = smem_u32(v_s);
  const float scale_log2 = scale * kLog2e;
  const bool keys_edge = wkey + 64 > sk;
  mbar_wait(&kv_bar, 0);

  if (wg == 1) stagger_wait();
  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % kStages;
    const int qt = lo + j % per_head;
    const int next = j + 1;  // the tile to issue now
    const bool more = next < n_tiles;
    if (tid == 0 && more) load_tile(next);
    float next_row = 0.f;
    if (row_loader && more) next_row = row_value(next);  // lands meanwhile

    // Every thread waits for every tile and releases it, even one before
    // its warpgroup's causal bound, so no thread runs a ring ahead.
    mbar_wait(&full[st], (j / kStages) & 1);
    if (j == 0 && wg == 0 && qt < wg_lo) stagger_release();
    if (qt >= wg_lo) {  // else no key of this warpgroup is visible
      const uint32_t q_addr = smem_u32(qdo_s + st * S::kStage);
      const uint32_t do_addr = q_addr + S::kQ;

      // S^T = K Q^T and dP^T = V dO^T: this warpgroup's 64 keys x 64 rows,
      // two groups, so P^T is computed while dP^T is still in flight.
      float s[kBQ / 2], dp[kBQ / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<kBQ>(s, desc_kmajor(k_addr, kBKey, wg * 64, kk),
                      desc_kmajor(q_addr, kBQ, 0, kk), kk > 0);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<kBQ>(dp, desc_kmajor(v_addr, kBKey, wg * 64, kk),
                      desc_kmajor(do_addr, kBQ, 0, kk), kk > 0);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(s);

      // P^T, selected: mask only a tile that crosses the diagonal or the
      // sk edge.
      const bool edge =
          keys_edge || (causal && kv_off + wkey + 63 > q_off + qt * kBQ);
#pragma unroll
      for (int jj = 0; jj < kBQ / 8; ++jj) {
        const int c = 8 * jj + 2 * t;  // this thread's columns c, c + 1
        const float2 lse2 = *reinterpret_cast<const float2*>(&lse_s[st][c]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float lse_c = (e & 1) ? lse2.y : lse2.x;
          bool keep = lse_c > kDeadLse;  // rows past sq carry -1e30
          if (edge) {
            const int key = key0 + 8 * (e >> 1);
            keep = keep && key < sk &&
                   (!causal ||
                    kv_off + key <= q_off + qt * kBQ + c + (e & 1));
          }
          const int i = 4 * jj + e;
          s[i] = keep ? exp2_approx(s[i] * scale_log2 - lse_c * kLog2e) : 0.f;
        }
      }
      unsigned pa[kBQ / 16][4];
      pack_a<kBQ>(pa, s);
      if (j == 0 && wg == 0) stagger_release();  // P^T of tile 0 is done
      wgmma_wait<0>();
      fence_regs(dp);

      // dV += P^T dO (dO MN-major) runs while dS^T is formed.
      wgmma_fence();
      fence_regs(dva);
#pragma unroll
      for (int kk = 0; kk < kBQ / 16; ++kk)
        wgmma_rs<D>(dva, pa[kk], desc_mnmajor(do_addr, kBQ, kk), 1);
      wgmma_commit();
#pragma unroll
      for (int jj = 0; jj < kBQ / 8; ++jj) {
        const float2 corr2 =
            *reinterpret_cast<const float2*>(&corr_s[st][8 * jj + 2 * t]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * jj + e;
          dp[i] = s[i] * (dp[i] - ((e & 1) ? corr2.y : corr2.x)) * scale;
        }
      }
      unsigned dsa[kBQ / 16][4];
      pack_a<kBQ>(dsa, dp);

      // dK += dS^T Q (Q MN-major).
      wgmma_fence();
      fence_regs(dka);
#pragma unroll
      for (int kk = 0; kk < kBQ / 16; ++kk)
        wgmma_rs<D>(dka, dsa[kk], desc_mnmajor(q_addr, kBQ, kk), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dva);
      fence_regs(dka);
    }
    mbar_arrive(&empty[st]);
    if (row_loader && more) store_rows(next, next_row);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    if (key >= sk) continue;
    const long long base = (((long long)bi * sk + key) * hk + kh) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<unsigned*>(dk + base + 8 * n + 2 * t) =
          pack_bf16(dka[4 * n + 2 * r], dka[4 * n + 2 * r + 1]);
      *reinterpret_cast<unsigned*>(dv + base + 8 * n + 2 * t) =
          pack_bf16(dva[4 * n + 2 * r], dva[4 * n + 2 * r + 1]);
    }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* corr,
                   void* dk, void* dv, int b, int h, int hk, int sq, int sk,
                   int q_off, int kv_off, int causal, float scale,
                   cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err = rows_map(&tk, k, b, sk, hk, D, kBKey);
  if (err == cudaSuccess) err = rows_map(&tv, v, b, sk, hk, D, kBKey);
  if (sq == 0) {  // no query tile is ever loaded; an empty tensor has no base
    tq = tdo = tk;
  } else {
    if (err == cudaSuccess) err = rows_map(&tq, q, b, sq, h, D, kBQ);
    if (err == cudaSuccess) err = rows_map(&tdo, dout, b, sq, h, D, kBQ);
  }
  auto kernel = flash_bwd_dkv_sm90_kernel<D>;
  if (err == cudaSuccess) err = allow_smem(kernel, Smem<D>::kBytes);
  if (err != cudaSuccess) return err;
  const int blocks = b * hk * ((sk + kBKey - 1) / kBKey);
  kernel<<<blocks, kThreads, Smem<D>::kBytes, stream>>>(
      tq, tk, tv, tdo, lse, corr, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), h, hk, sq, sk, q_off, kv_off, causal,
      scale);
  return cudaGetLastError();
}

}  // namespace

// q/do: [b, sq, h, d]; k/v/dk/dv: [b, sk, hk, d], all bf16 and 16-byte
// aligned, d = 64 or 128; lse, corr: [b * h, sq] float32 (corr =
// rowsum(do * out) - dlse).  Returns a cudaError_t
// (cudaErrorInvalidValue for a shape it does not take).
extern "C" int flash_bwd_dkv_sm90(const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const void* lse, const void* corr,
                                  void* dk, void* dv, int b, int h, int hk,
                                  int sq, int sk, int d, int q_off,
                                  int kv_off, int causal, float scale,
                                  void* stream) {
  if (b <= 0 || sk <= 0) return cudaGetLastError();
  const void* ptrs[6] = {q, k, v, dout, dk, dv};
  if (h <= 0 || hk <= 0 || h % hk != 0 || sq < 0 || !takes(d, ptrs, 6))
    return cudaErrorInvalidValue;
  const float* l = static_cast<const float*>(lse);
  const float* c = static_cast<const float*>(corr);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64)
    return launch<64>(q, k, v, dout, l, c, dk, dv, b, h, hk, sq, sk, q_off,
                      kv_off, causal, scale, s);
  return launch<128>(q, k, v, dout, l, c, dk, dv, b, h, hk, sq, sk, q_off,
                     kv_off, causal, scale, s);
}
