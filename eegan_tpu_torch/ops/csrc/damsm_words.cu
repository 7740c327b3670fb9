// DAMSM word-region similarity, forward and both backward passes, for
// Hopper (sm_90a).
//
// Replaces the three TPU kernels of eegan_tpu/ops/damsm_pallas.py:
//   damsm_words_fwd              <- _kernel         (words_similarity_fused)
//   damsm_dr_pair + damsm_dr_sum <- _bwd_dr_kernel  (_words_sim_bwd, dR pass)
//   damsm_dw_pair + damsm_dw_sum <- _bwd_dw_kernel  (_words_sim_bwd, dW pass)
//
// For one (image i, text t) pair, with R = regions[i] (S, D), W = words[t]
// (L, D) and the first len_t words valid:
//
//   A      = R W^T                                  (S, L)
//   attn1  = softmax over words l of A, invalid words masked to -1e9
//   attn2  = softmax over regions s of gamma1 * attn1  (the reference's
//            quirk: gamma1 scales the probabilities, DAMSM_losses.py:42-54)
//   C      = attn2^T R                              (L, D)
//   cos_l  = <W_l, C_l> / max(|W_l| |C_l|, eps)
//   sim    = log(max(sum_l mask_l exp(gamma2 cos_l), eps))
//
// and the backward of sim, from dsim[i, t], recomputes all of it (nothing of
// the forward is saved) and gives dR = dA W + attn2 dC (summed over texts)
// and dW = dW_direct + dA^T R (summed over images), with dA, dC the
// gradients at A and C (derivation: damsm_pallas.py:125-165).
//
// Bound: float32 operations. The products are 4 S L D flops per pair in the
// forward, 10 S L D in the dR pass (A, C and dA recomputed, then two
// products into dR) and 8 S L D in the dW pass, counted over the valid words
// only; the inputs are a few MB. The least time is those flops over the
// card's float32 rate (67 TFLOP/s on an H100 SXM, outside the tensor cores).
//
// Design. The TPU kernel packs a tile of texts into the lane dimension and
// needs block-diagonal 0/1 matmuls (bd, gsum) and a one-hot column select
// only because Mosaic cannot reshape lanes; here a block indexes its own
// text and image. The per-group stabiliser of the TPU kernel is not needed
// either: the row max over one text's words is exact.
//
// * The pair's forward (pair_attend), shared by all three passes' pair
//   blocks, runs over the text's n valid words only (rounded up to NQ, a
//   multiple of 4, a template parameter chosen per block). Its products
//   (A = R W^T, C = attn2^T R; the backward adds da2 = R dC^T) keep
//   register tiles: a thread owns up to four regions x NQ words (or four
//   columns x NQ words), so each float4 of R read from the L2 (9.5 MB for
//   32 images, held in the 50 MB L2) feeds 4 NQ multiply-adds or more, and
//   the next one is loaded before they run. The softmaxes, cosines and Z
//   are group-wide: a word group of WG lanes (NQ rounded up to a power of
//   2) takes a region row, and the reductions are shuffles in the group or
//   fixed-order sums of 256 partials in shared memory.
// * forward, damsm_words_fwd: one block per pair (Bt x Bi = 1024 blocks at
//   the train shape); W, C and one (S, LP) grid (attn2 overwrites attn1) in
//   shared memory, 64.7 KB at that shape. Two blocks share an SM: the
//   registers (128 a thread) allow no third, and capping them at 80 for
//   three blocks spills and runs slower.
// * The two backward passes each take two launches, with no atomics: the
//   same bits on every launch. Their pair blocks (pair_grad) run the pair's
//   forward and backward down to dA and dC; W, C/dC and three (S, LP) grids
//   (attn1, attn2, da2/dA) are in shared memory, 112.5 KB at the train
//   shape, so two blocks fit on an SM.
//   - dR: damsm_dr_pair writes dA and attn2 (n x S) and dC (n x D) to a
//     float32 scratch of 4 Bi Bt L (2 SP + D) bytes (68.8 MB at (32, 32,
//     289, 20, 256)); damsm_dr_sum, one block per image and 64 x 64 tile of
//     (S, D) (640 blocks), sums dR = sum_t (dA_t W_t + attn2_t dC_t) over
//     the texts in index order, a product with K = 2 n_t per text staged in
//     shared memory, 4 x 4 outputs per thread, each output written once.
//   - dW: damsm_dw_pair folds the cosine's direct term into the product
//     and writes P = dA + (dcos / den) attn2 (S x NQ) and kappa = dcos cos /
//     |W|^2 (n) to a float32 scratch of 4 Bi Bt (S LT + L) bytes (23.8 MB at
//     the train shape); damsm_dw_sum, one block per text and 64-column tile
//     of D (128 blocks), sums P_i^T R_i over the images in index order, a
//     product with M = n_t, N = 64 and K = Bi S (9,248) staged by cp.async
//     in two buffers of 64 regions, then subtracts (sum_i kappa_i) W_t and
//     writes each output once. 64 columns rather than 32 (256 blocks, which
//     fill the SMs) halve the reads of P, and measure faster.
// Products run on the CUDA cores in float32. A padded word gets zero
// attention and is skipped; dW is written 0 there.
//
// C interface: eegan_damsm_words_{fwd,bwd_dr,bwd_dw}(...) return
// cudaGetLastError() after the launches (0 = launched), or
// cudaErrorInvalidValue for a shape outside the limits (D % 4 == 0,
// D <= 256, L <= 32) or a plan that does not cover the layout.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr float kEps = 1e-8f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---------------------------------------------------------------------------
// The per-pair code, one block per (text, image) pair over the text's valid
// words: the forward, and the first pass of dR and of dW.
// ---------------------------------------------------------------------------

// Layout of the pair blocks' shared memory and the scratches: LT = L rounded
// up to 4, the rows of the (LT, D) tiles; LP, the row stride of the (S, LP)
// grids; SP, the row stride of dR's (L, SP) planes. LP and SP come from the
// launch plans (ops/damsm.py:fwd_launch_plan, dr_launch_plan,
// dw_launch_plan).
struct Dims {
  int Bi, Bt, S, L, D;
  int LT, LP, DP, SP;
};

Dims make_dims(int Bi, int Bt, int S, int L, int D, int LP, int SP) {
  Dims d;
  d.Bi = Bi;
  d.Bt = Bt;
  d.S = S;
  d.L = L;
  d.D = D;
  d.LT = (L + 3) / 4 * 4;
  d.LP = LP;
  d.DP = D + 4;
  d.SP = SP;
  return d;
}

__device__ __forceinline__ unsigned group_mask(int width) {
  const int lane = threadIdx.x & 31;
  return width == 32 ? 0xffffffffu
                     : ((1u << width) - 1u) << (lane & ~(width - 1));
}

__device__ __forceinline__ float group_sum(float v, int width, unsigned m) {
  for (int o = width >> 1; o > 0; o >>= 1) v += __shfl_xor_sync(m, v, o);
  return v;
}

__device__ __forceinline__ float group_max(float v, int width, unsigned m) {
  for (int o = width >> 1; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(m, v, o));
  return v;
}

// out[s, l] = <R[s], M[l]> for RS regions s = s0 + 64a and the NQ words l.
// The four lanes of a region split D in float4 columns j = q mod 4; each
// thread keeps RS x NQ sums in registers, so a float4 of R (from the L2)
// feeds 4 NQ multiply-adds and a float4 of M (a shared-memory broadcast)
// 4 RS. The lanes' parts are added by two shuffles; lane q writes l = q mod 4.
template <int NQ, int RS>
__device__ __forceinline__ void dr_rows_tile(const float* __restrict__ R,
                                             const float* M, float* out,
                                             int s0, int q, const Dims& d) {
  float acc[RS][NQ];
#pragma unroll
  for (int a = 0; a < RS; ++a)
#pragma unroll
    for (int l = 0; l < NQ; ++l) acc[a][l] = 0.0f;
  const float4* r4[RS];
#pragma unroll
  for (int a = 0; a < RS; ++a)
    r4[a] = reinterpret_cast<const float4*>(R + (int64_t)(s0 + 64 * a) * d.D);
  const int D4 = d.D >> 2;
  // The next column's loads are issued before this one's multiply-adds.
  float4 v[RS];
#pragma unroll
  for (int a = 0; a < RS; ++a) v[a] = __ldg(r4[a] + (q < D4 ? q : 0));
  for (int j = q; j < D4; j += 4) {
    float4 vn[RS];
#pragma unroll
    for (int a = 0; a < RS; ++a)
      vn[a] = __ldg(r4[a] + (j + 4 < D4 ? j + 4 : j));
#pragma unroll
    for (int l = 0; l < NQ; ++l) {
      const float4 m = *reinterpret_cast<const float4*>(M + l * d.DP + 4 * j);
#pragma unroll
      for (int a = 0; a < RS; ++a) {
        float x = fmaf(v[a].x, m.x, acc[a][l]);
        x = fmaf(v[a].y, m.y, x);
        x = fmaf(v[a].z, m.z, x);
        acc[a][l] = fmaf(v[a].w, m.w, x);
      }
    }
#pragma unroll
    for (int a = 0; a < RS; ++a) v[a] = vn[a];
  }
  const unsigned gm = group_mask(4);
#pragma unroll
  for (int a = 0; a < RS; ++a) {
#pragma unroll
    for (int l = 0; l < NQ; ++l) {
      float v = acc[a][l];
      v += __shfl_xor_sync(gm, v, 1);
      v += __shfl_xor_sync(gm, v, 2);
      if ((l & 3) == q) out[(s0 + 64 * a) * d.LP + l] = v;
    }
  }
}

// out[s, l] = <R[s], M[l]> for all S regions and the NQ words: 64 regions
// per round and thread quad, two at a time, the odd last one alone.
template <int NQ>
__device__ void dr_rows(const float* __restrict__ R, const float* M,
                        float* out, const Dims& d) {
  const int q = threadIdx.x & 3;
  int s0 = threadIdx.x >> 2;
  if constexpr (NQ <= 16)
    for (; s0 + 192 < d.S; s0 += 256) dr_rows_tile<NQ, 4>(R, M, out, s0, q, d);
  for (; s0 + 64 < d.S; s0 += 128) dr_rows_tile<NQ, 2>(R, M, out, s0, q, d);
  if (s0 < d.S) dr_rows_tile<NQ, 1>(R, M, out, s0, q, d);
}

// C[l, c] = sum_s P[s, l] R[s, c] for the NQ words: a thread owns CW
// neighbouring columns (4, or 2 where 4 NQ sums would not fit in registers)
// and every KS-th region; KS neighbouring lanes share the columns and add
// their parts by shuffles. A vector of R feeds CW NQ multiply-adds, a
// float4 of P (a broadcast) 4 CW; the next region's load is issued before
// this one's multiply-adds.
template <int NQ>
__device__ void dr_cols(const float* __restrict__ R, const float* P, float* C,
                        const Dims& d) {
  constexpr int CW = NQ <= 20 ? 4 : 2;
  using Vec = typename std::conditional<CW == 4, float4, float2>::type;
  const int ncol = d.D / CW;
  int KS = 32;  // largest power of 2 <= min(32, kThreads / ncol)
  while (KS * ncol > kThreads) KS >>= 1;
  const int cp = threadIdx.x / KS;
  const int ks = threadIdx.x & (KS - 1);
  if (cp >= ncol) return;  // whole groups of KS lanes
  float acc[NQ][CW];
#pragma unroll
  for (int l = 0; l < NQ; ++l)
#pragma unroll
    for (int c = 0; c < CW; ++c) acc[l][c] = 0.0f;
  const Vec* rc = reinterpret_cast<const Vec*>(R) + cp;
  Vec v = __ldg(rc + (int64_t)(ks < d.S ? ks : 0) * ncol);
  for (int s = ks; s < d.S; s += KS) {
    const Vec vn = __ldg(rc + (int64_t)(s + KS < d.S ? s + KS : s) * ncol);
    const float* vf = reinterpret_cast<const float*>(&v);
    const float4* p = reinterpret_cast<const float4*>(P + s * d.LP);
#pragma unroll
    for (int q4 = 0; q4 < NQ / 4; ++q4) {
      const float4 a = p[q4];
      const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int c = 0; c < CW; ++c) acc[4 * q4 + e][c] += av[e] * vf[c];
    }
    v = vn;
  }
  const unsigned gm = group_mask(KS);
#pragma unroll
  for (int l = 0; l < NQ; ++l) {
    Vec out;
    float* of = reinterpret_cast<float*>(&out);
#pragma unroll
    for (int c = 0; c < CW; ++c) {
      float x = acc[l][c];
      for (int o = 1; o < KS; o <<= 1) x += __shfl_xor_sync(gm, x, o);
      of[c] = x;
    }
    if ((l & (KS - 1)) == ks)
      *reinterpret_cast<Vec*>(C + l * d.DP + CW * cp) = out;
  }
}

// Per-word statistics of a pair, in shared memory (32 floats each); wn2 =
// max(|W_l|^2, eps^2) only where dW needs it (else null).
struct PairStats {
  float *cos, *den, *cn2, *row, *wn2;
};

// Word groups of the softmaxes: WG = NQ rounded up to a power of 2 lanes
// per region row; lane l of a group is word l, NSUB region rows per pass.
template <int NQ>
struct WordGroups {
  static constexpr int WG = NQ <= 4 ? 4 : NQ <= 8 ? 8 : NQ <= 16 ? 16 : 32;
  static constexpr int NSUB = kThreads / WG;
};

// The forward of one (text, image) pair over its n valid words, rounded up
// to NQ (a multiple of 4), as far as the per-word cosines: sW <- W (0 for
// l >= n), sP1 <- attn1, sP2 <- attn2, sC <- C = attn2^T R (0 for the padded
// words) and, per valid word, st.cos, st.den, st.cn2 and st.row = exp(gamma2
// cos). sP2 may be sP1: attn2 then overwrites attn1 in place (each element
// is read and written by the same thread). red holds kThreads partials.
// Ends with a barrier.
template <int NQ>
__device__ void pair_attend(const float* __restrict__ R,
                            const float* __restrict__ W, int n, float gamma1,
                            float gamma2, const Dims& d, float* sW,
                            float* sC, float* sP1, float* sP2, float* red,
                            const PairStats& st) {
  const int tid = threadIdx.x;
  constexpr int WG = WordGroups<NQ>::WG;
  constexpr int NSUB = WordGroups<NQ>::NSUB;
  const int l = tid & (WG - 1);
  const int sub = tid / WG;
  const unsigned wm = group_mask(WG);
  const int D4 = d.D >> 2;

  for (int k = tid; k < NQ * D4; k += kThreads) {
    const int r = k / D4;
    const int c = k - r * D4;
    // The address stays in bounds even if the load is issued for r >= n.
    float4 v =
        __ldg(reinterpret_cast<const float4*>(W + (r < n ? r : 0) * d.D) + c);
    if (r >= n) v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    *reinterpret_cast<float4*>(sW + r * d.DP + 4 * c) = v;
  }
  __syncthreads();

  // A = R W^T.
  dr_rows<NQ>(R, sW, sP1, d);
  __syncthreads();

  // attn1: softmax over the n valid words of each region (a padded word's
  // exp(-1e9 - max) is exactly 0 in the reference, 0 here).
  for (int s = sub; s < d.S; s += NSUB) {
    float* p = sP1 + s * d.LP;
    const float a = l < n ? p[l] : -INFINITY;
    const float mx = group_max(a, WG, wm);
    const float e = l < n ? expf(a - mx) : 0.0f;
    const float sum = group_sum(e, WG, wm);
    if (l < NQ) p[l] = l < n ? e / sum : 0.0f;
  }
  __syncthreads();

  // attn2: softmax over the regions of gamma1 * attn1, word by word; the
  // NSUB rows of a word's column sums go through red in a fixed order.
  {
    float mx = -INFINITY;
    if (l < n)
      for (int s = sub; s < d.S; s += NSUB)
        mx = fmaxf(mx, gamma1 * sP1[s * d.LP + l]);
    red[sub * WG + l] = mx;
    __syncthreads();
    mx = -INFINITY;
    for (int k = 0; k < NSUB; ++k) mx = fmaxf(mx, red[k * WG + l]);
    __syncthreads();
    float sum = 0.0f;
    if (l < n)
      for (int s = sub; s < d.S; s += NSUB) {
        const float e = expf(gamma1 * sP1[s * d.LP + l] - mx);
        sP2[s * d.LP + l] = e;
        sum += e;
      }
    red[sub * WG + l] = sum;
    __syncthreads();
    sum = 0.0f;
    for (int k = 0; k < NSUB; ++k) sum += red[k * WG + l];
    if (l < NQ)
      for (int s = sub; s < d.S; s += NSUB)
        sP2[s * d.LP + l] = l < n ? sP2[s * d.LP + l] / sum : 0.0f;
  }
  __syncthreads();

  // C = attn2^T R (0 for the padded words).
  dr_cols<NQ>(R, sP2, sC, d);
  __syncthreads();

  // Cosines: G lanes per word.
  {
    const int G = kThreads / WG < 32 ? kThreads / WG : 32;
    const int wl = tid / G;
    const int k = tid & (G - 1);
    if (wl < n) {
      float wc = 0.0f, ww = 0.0f, cc = 0.0f;
      for (int c = k; c < d.D; c += G) {
        const float a = sW[wl * d.DP + c];
        const float b = sC[wl * d.DP + c];
        wc += a * b;
        ww += a * a;
        cc += b * b;
      }
      const unsigned gm = group_mask(G);
      wc = group_sum(wc, G, gm);
      ww = group_sum(ww, G, gm);
      cc = group_sum(cc, G, gm);
      if (k == 0) {
        const float den = fmaxf(sqrtf(ww) * sqrtf(cc), kEps);
        const float cs = wc / den;
        st.cos[wl] = cs;
        st.den[wl] = den;
        st.cn2[wl] = fmaxf(cc, kEps * kEps);
        st.row[wl] = expf(gamma2 * cs);
        if (st.wn2 != nullptr) st.wn2[wl] = fmaxf(ww, kEps * kEps);
      }
    }
  }
  __syncthreads();
}

// Shared-memory layout of a pair block: sW and sC (LT, DP), then the (S, LP)
// grids (three for the backward passes, one for the forward), kThreads
// floats of partials and `stats` 32-float arrays of per-word statistics
// (four; five for dW, which adds wn2).
size_t pair_smem_floats(const Dims& d, int grids, int stats) {
  return (size_t)2 * d.LT * d.DP + (size_t)grids * d.S * d.LP + kThreads +
         (size_t)stats * 32;
}

// A backward pair block's shared memory: sW (LT, DP) words, 0 for l >= n;
// sC (LT, DP) C, then dC; the (S, LP) grids sP1 (A, then attn1), sP2
// (attn2) and sX (da2, then dA); kThreads partials; the statistics, with
// wn2 for dW only.
struct PairSmem {
  float *sW, *sC, *sP1, *sP2, *sX, *red;
  PairStats st;
};

__device__ PairSmem backward_smem(const Dims& d, bool with_wn2) {
  extern __shared__ float4 smem4[];
  PairSmem m;
  m.sW = reinterpret_cast<float*>(smem4);
  m.sC = m.sW + d.LT * d.DP;
  m.sP1 = m.sC + d.LT * d.DP;
  m.sP2 = m.sP1 + d.S * d.LP;
  m.sX = m.sP2 + d.S * d.LP;
  m.red = m.sX + d.S * d.LP;
  float* st = m.red + kThreads;
  m.st = PairStats{st, st + 32, st + 64, st + 96,
                   with_wn2 ? st + 128 : nullptr};
  return m;
}

// The backward of one (text t, image i) pair, for n valid words rounded up
// to NQ (a multiple of 4), down to dA: the pair's forward (pair_attend),
// then m.sC <- dC and m.sX <- dA (0 for l >= n). Returns Z, the sum of the
// valid words' rows. Ends with a barrier.
template <int NQ>
__device__ float pair_grad(const float* __restrict__ R,
                           const float* __restrict__ W, int n, float g,
                           float gamma1, float gamma2, const Dims& d,
                           const PairSmem& m) {
  float *sW = m.sW, *sC = m.sC, *sP1 = m.sP1, *sP2 = m.sP2, *sX = m.sX;
  float* red = m.red;
  const PairStats& st = m.st;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  constexpr int WG = WordGroups<NQ>::WG;
  constexpr int NSUB = WordGroups<NQ>::NSUB;
  const int l = tid & (WG - 1);
  const int sub = tid / WG;
  const unsigned wm = group_mask(WG);
  const int D4 = d.D >> 2;

  pair_attend<NQ>(R, W, n, gamma1, gamma2, d, sW, sC, sP1, sP2, red, st);

  // Z = sum of the valid words' rows, in every warp; dC in place of C.
  const float Z = warp_sum(lane < n ? st.row[lane] : 0.0f);
  for (int k = tid; k < NQ * D4; k += kThreads) {
    const int r = k / D4;
    const int c = k - r * D4;
    float4* cv = reinterpret_cast<float4*>(sC + r * d.DP + 4 * c);
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (r < n) {
      const float dcos = g * st.row[r] * gamma2 / fmaxf(Z, kEps);
      const float4 w = *reinterpret_cast<const float4*>(sW + r * d.DP + 4 * c);
      const float4 cc = *cv;
      const float den = st.den[r], cs = st.cos[r], cn2 = st.cn2[r];
      v.x = dcos * (w.x / den - cs * cc.x / cn2);
      v.y = dcos * (w.y / den - cs * cc.y / cn2);
      v.z = dcos * (w.z / den - cs * cc.z / cn2);
      v.w = dcos * (w.w / den - cs * cc.w / cn2);
    }
    *cv = v;
  }
  __syncthreads();

  // da2 = R dC^T.
  dr_rows<NQ>(R, sC, sX, d);
  __syncthreads();

  // Back through the softmax over regions: colsum_l = sum_s attn2 da2 (the
  // same fixed-order reduction as attn2's), then per region row
  // da1 = gamma1 attn2 (da2 - colsum) and, through the softmax over words,
  // dA = attn1 (da1 - sum_l attn1 da1).
  {
    float cs = 0.0f;
    if (l < n)
      for (int s = sub; s < d.S; s += NSUB)
        cs += sP2[s * d.LP + l] * sX[s * d.LP + l];
    red[sub * WG + l] = cs;
    __syncthreads();
    cs = 0.0f;
    for (int k = 0; k < NSUB; ++k) cs += red[k * WG + l];
    for (int s = sub; s < d.S; s += NSUB) {
      const int j = s * d.LP + l;
      float a1 = 0.0f, da1 = 0.0f;
      if (l < n) {
        a1 = sP1[j];
        da1 = gamma1 * (sP2[j] * (sX[j] - cs));
      }
      const float rs = group_sum(a1 * da1, WG, wm);
      if (l < n) sX[j] = a1 * (da1 - rs);
    }
  }
  __syncthreads();
  return Z;
}

// One pair of the dR pass: writes the pair's dA and attn2 (n rows of S, word
// major) and dC (n rows of D) to the scratch; damsm_dr_sum makes dR of them.
template <int NQ>
__device__ void dr_pair(const float* __restrict__ R,
                        const float* __restrict__ W, int n, float g,
                        float gamma1, float gamma2, const Dims& d,
                        float* __restrict__ oA, float* __restrict__ oG,
                        float* __restrict__ oC) {
  const PairSmem m = backward_smem(d, false);
  pair_grad<NQ>(R, W, n, g, gamma1, gamma2, d, m);
  const int tid = threadIdx.x;
  const int D4 = d.D >> 2;
  // Copy out, word major: dA and attn2 (s fastest), dC.
  for (int k = tid; k < n * d.S; k += kThreads) {
    const int r = k / d.S;
    const int s = k - r * d.S;
    oA[r * d.SP + s] = m.sX[s * d.LP + r];
    oG[r * d.SP + s] = m.sP2[s * d.LP + r];
  }
  for (int k = tid; k < n * D4; k += kThreads) {
    const int r = k / D4;
    const int c = k - r * D4;
    reinterpret_cast<float4*>(oC + r * d.D)[c] =
        *reinterpret_cast<const float4*>(m.sC + r * d.DP + 4 * c);
  }
}

// One pair of the dW pass. The cosine's direct term joins the product
// (dcos_l / den_l C_l = sum_s dcos_l / den_l attn2[s, l] R[s]), so the pair
// writes P = dA + (dcos / den) attn2, region major (S rows of NQ floats, 0
// for l >= n, as damsm_dw_sum stages them), and kappa_l = dcos_l cos_l /
// wn2_l (n floats); dW_t[l] = sum_i (P_i^T R_i)[l] - (sum_i kappa_i[l]) W_t[l].
template <int NQ>
__device__ void dw_pair(const float* __restrict__ R,
                        const float* __restrict__ W, int n, float g,
                        float gamma1, float gamma2, const Dims& d,
                        float* __restrict__ oP, float* __restrict__ oK) {
  const PairSmem m = backward_smem(d, true);
  const float Z = pair_grad<NQ>(R, W, n, g, gamma1, gamma2, d, m);
  const int tid = threadIdx.x;
  float* coef = m.red;  // dcos / den per word (the partials are free now)
  if (tid < NQ) {
    float c = 0.0f;
    if (tid < n) {
      const float dcos = g * m.st.row[tid] * gamma2 / fmaxf(Z, kEps);
      c = dcos / m.st.den[tid];
      oK[tid] = dcos * m.st.cos[tid] / m.st.wn2[tid];
    }
    coef[tid] = c;
  }
  __syncthreads();
  constexpr int Q4 = NQ / 4;
  for (int k = tid; k < d.S * Q4; k += kThreads) {
    const int s = k / Q4;
    const int q = 4 * (k - s * Q4);
    const float4 a = *reinterpret_cast<const float4*>(m.sX + s * d.LP + q);
    const float4 b = *reinterpret_cast<const float4*>(m.sP2 + s * d.LP + q);
    const float4 c = *reinterpret_cast<const float4*>(coef + q);
    float4 v;
    v.x = q + 0 < n ? a.x + c.x * b.x : 0.0f;
    v.y = q + 1 < n ? a.y + c.y * b.y : 0.0f;
    v.z = q + 2 < n ? a.z + c.z * b.z : 0.0f;
    v.w = q + 3 < n ? a.w + c.w * b.w : 0.0f;
    reinterpret_cast<float4*>(oP)[k] = v;
  }
}

// Calls FN<NQ>(...) with NQ = n rounded up to 4 (0 < n <= 32): the pair
// code is instantiated for 8 word counts and each block takes its text's.
#define EEGAN_WORDS_SWITCH(n, FN, ...)  \
  switch (((n) + 3) / 4) {              \
    case 1: FN<4>(__VA_ARGS__); break;  \
    case 2: FN<8>(__VA_ARGS__); break;  \
    case 3: FN<12>(__VA_ARGS__); break; \
    case 4: FN<16>(__VA_ARGS__); break; \
    case 5: FN<20>(__VA_ARGS__); break; \
    case 6: FN<24>(__VA_ARGS__); break; \
    case 7: FN<28>(__VA_ARGS__); break; \
    case 8: FN<32>(__VA_ARGS__); break; \
  }

// The forward: grid (Bt, Bi), one block per pair. One (S, LP) grid (attn2
// overwrites attn1), 64.7 KB at the train shape (L = 20). A text with no
// valid word gets log(eps), as the reference's masked sum of 0 does.
template <int NQ>
__device__ void fwd_pair(const float* __restrict__ R,
                         const float* __restrict__ W, int n, float gamma1,
                         float gamma2, const Dims& d,
                         float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* sW = reinterpret_cast<float*>(smem4);  // (LT, DP) words
  float* sC = sW + d.LT * d.DP;                 // (LT, DP) C
  float* sP = sC + d.LT * d.DP;                 // (S, LP) attn1, then attn2
  float* red = sP + d.S * d.LP;                 // kThreads partials
  const PairStats st{red + kThreads, red + kThreads + 32,
                     red + kThreads + 64, red + kThreads + 96, nullptr};
  pair_attend<NQ>(R, W, n, gamma1, gamma2, d, sW, sC, sP, sP, red, st);
  const int tid = threadIdx.x;
  if (tid < 32) {  // Z as dR's pass sums it: the valid words' rows, a warp
    const float Z = warp_sum(tid < n ? st.row[tid] : 0.0f);
    if (tid == 0) *out = logf(fmaxf(Z, kEps));
  }
}

__global__ void __launch_bounds__(kThreads, 2) damsm_words_fwd(
    const float* __restrict__ regions, const float* __restrict__ words,
    const int* __restrict__ lens, float* __restrict__ sims, Dims d,
    float gamma1, float gamma2) {
  const int t = blockIdx.x;
  const int i = blockIdx.y;
  const int n = min(max(lens[t], 0), d.L);
  float* out = sims + (int64_t)i * d.Bt + t;
  if (n == 0) {
    if (threadIdx.x == 0) *out = logf(kEps);
    return;
  }
  const float* R = regions + (int64_t)i * d.S * d.D;
  const float* W = words + (int64_t)t * d.L * d.D;
  EEGAN_WORDS_SWITCH(n, fwd_pair, R, W, n, gamma1, gamma2, d, out)
}

// dR pass 1: grid (Bt, Bi), one block per pair; two blocks fit on an SM
// while the shared memory allows (L <= 20 at S = 289, D = 256).
__global__ void __launch_bounds__(kThreads, 2) damsm_dr_pair(
    const float* __restrict__ regions, const float* __restrict__ words,
    const int* __restrict__ lens, const float* __restrict__ dsim,
    float* __restrict__ scratch, Dims d, float gamma1, float gamma2) {
  const int t = blockIdx.x;
  const int i = blockIdx.y;
  const int n = min(max(lens[t], 0), d.L);
  if (n == 0) return;  // no valid word: the pair adds nothing to dR
  const float* R = regions + (int64_t)i * d.S * d.D;
  const float* W = words + (int64_t)t * d.L * d.D;
  const float g = dsim[(int64_t)i * d.Bt + t];
  const int64_t slot = ((int64_t)i * d.Bt + t) * d.L;
  const int64_t plane = (int64_t)d.Bi * d.Bt * d.L * d.SP;
  float* oA = scratch + slot * d.SP;
  float* oG = oA + plane;
  float* oC = scratch + 2 * plane + slot * d.D;
  EEGAN_WORDS_SWITCH(n, dr_pair, R, W, n, g, gamma1, gamma2, d, oA, oG, oC)
}

// Pass 2: grid (ceil(D/kSumD), ceil(S/64), Bi). dR[i] for a 64 x kSumD
// tile of (s, d) = sum over the texts t in order, and over each text's valid
// words, of dA[i,t][l, s] W[t][l, d] + attn2[i,t][l, s] dC[i,t][l, d]: a
// product with K = 2 n_t per text, staged in shared memory ([k][s] and
// [k][d]); a thread owns 4 x (kSumD / 16) outputs. Few registers, so several
// blocks share an SM and hide each other's loads. Each output is written
// once: no atomics.
constexpr int kSumS = 64;
constexpr int kSumD = 64;
constexpr int kSumH = kSumD / 64;  // float4 columns of a thread

__global__ void __launch_bounds__(kThreads) damsm_dr_sum(
    const float* __restrict__ words, const int* __restrict__ lens,
    const float* __restrict__ scratch, float* __restrict__ dR, Dims d) {
  __shared__ __align__(16) float sa[2 * 32][kSumS];  // [k][s]
  __shared__ __align__(16) float sb[2 * 32][kSumD];  // [k][d]
  const int d0 = blockIdx.x * kSumD;
  const int s0 = blockIdx.y * kSumS;
  const int i = blockIdx.z;
  const int tx = threadIdx.x & 15;  // d = d0 + 4 tx + 64 h, h < kSumH
  const int ty = threadIdx.x >> 4;  // s = s0 + 4 ty + p, p < 4
  const int64_t plane = (int64_t)d.Bi * d.Bt * d.L * d.SP;
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float acc[4][4 * kSumH];
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int q = 0; q < 4 * kSumH; ++q) acc[p][q] = 0.0f;

  for (int t = 0; t < d.Bt; ++t) {
    const int n = min(max(lens[t], 0), d.L);
    if (n == 0) continue;
    const int64_t slot = ((int64_t)i * d.Bt + t) * d.L;
    const float* gA = scratch + slot * d.SP;
    const float* gG = gA + plane;
    const float* gC = scratch + 2 * plane + slot * d.D;
    const float* gW = words + (int64_t)t * d.L * d.D;
    // Row k of both tiles per step (16 float4 of sa, 16 kSumH of sb);
    // out-of-tile addresses fall back to a row start, in bounds even if the
    // load is issued.
    for (int k = threadIdx.x; k < 2 * n * 16; k += kThreads) {
      const int row = k >> 4;
      const int c4 = 4 * (k & 15);
      const int wrow = row < n ? row : row - n;
      const bool oka = s0 + c4 < d.SP;
      const float4 va = __ldg(reinterpret_cast<const float4*>(
          (row < n ? gA : gG) + (int64_t)wrow * d.SP + (oka ? s0 + c4 : 0)));
      float4 vb[kSumH];
#pragma unroll
      for (int h = 0; h < kSumH; ++h) {
        const int dc = d0 + 64 * h + c4;
        vb[h] = __ldg(reinterpret_cast<const float4*>(
            (row < n ? gW : gC) + (int64_t)wrow * d.D + (dc < d.D ? dc : 0)));
      }
      *reinterpret_cast<float4*>(&sa[row][c4]) = oka ? va : zero;
#pragma unroll
      for (int h = 0; h < kSumH; ++h)
        *reinterpret_cast<float4*>(&sb[row][64 * h + c4]) =
            d0 + 64 * h + c4 < d.D ? vb[h] : zero;
    }
    __syncthreads();
    for (int k = 0; k < 2 * n; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&sa[k][4 * ty]);
      const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int h = 0; h < kSumH; ++h) {
        const float4 b =
            *reinterpret_cast<const float4*>(&sb[k][64 * h + 4 * tx]);
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int p = 0; p < 4; ++p)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[p][4 * h + q] += av[p] * bv[q];
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int s = s0 + 4 * ty + p;
    if (s >= d.S) continue;
#pragma unroll
    for (int h = 0; h < kSumH; ++h) {
      const int dc = d0 + 4 * tx + 64 * h;
      if (dc < d.D)
        *reinterpret_cast<float4*>(dR + ((int64_t)i * d.S + s) * d.D + dc) =
            make_float4(acc[p][4 * h], acc[p][4 * h + 1], acc[p][4 * h + 2],
                        acc[p][4 * h + 3]);
    }
  }
}

// dW pass 1: grid (Bt, Bi), one block per pair, as damsm_dr_pair. The
// scratch holds, per pair (t major), S rows of NQ floats of P in a slot of
// S LT floats, then, after all the slots, L floats of kappa per pair.
__global__ void __launch_bounds__(kThreads, 2) damsm_dw_pair(
    const float* __restrict__ regions, const float* __restrict__ words,
    const int* __restrict__ lens, const float* __restrict__ dsim,
    float* __restrict__ scratch, Dims d, float gamma1, float gamma2) {
  const int t = blockIdx.x;
  const int i = blockIdx.y;
  const int n = min(max(lens[t], 0), d.L);
  if (n == 0) return;  // no valid word: damsm_dw_sum writes dW_t = 0
  const float* R = regions + (int64_t)i * d.S * d.D;
  const float* W = words + (int64_t)t * d.L * d.D;
  const float g = dsim[(int64_t)i * d.Bt + t];
  const int64_t slot = (int64_t)t * d.Bi + i;
  float* oP = scratch + slot * d.S * d.LT;
  float* oK = scratch + (int64_t)d.Bi * d.Bt * d.S * d.LT + slot * d.L;
  EEGAN_WORDS_SWITCH(n, dw_pair, R, W, n, g, gamma1, gamma2, d, oP, oK)
}

// dW pass 2: grid (ceil(D / kDwTile), Bt), one block per text and tile of
// kDwTile columns. Its dynamic shared memory (dw_sum_floats) holds two
// stages of kDwChunk regions: P rows (kDwChunk, NQ) and R columns
// (kDwChunk, kDwTile), filled by cp.async while the other stage is summed;
// after the loop the warps' partial sums take their place.
constexpr int kDwTile = 64;   // columns of D per block
constexpr int kDwChunk = 64;  // regions per stage

size_t dw_sum_floats(const Dims& d) {
  const size_t stages = (size_t)2 * kDwChunk * (d.LT + kDwTile);
  const size_t partials = (size_t)kWarps * d.LT * kDwTile;
  return stages > partials ? stages : partials;
}

// 16 bytes from global to shared memory, asynchronously; zeros if !ok (src
// must be a valid address all the same).
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// dW_t for the block's tile, n valid words rounded up to NQ: the product
// sum_i P_i^T R_i (M = NQ, N = kDwTile, K = Bi S) over the chunks of
// kDwChunk regions, images and regions in index order. Warp w takes regions
// w, w + kWarps, ... of each chunk; a lane keeps its kDwTile / 32 columns
// for all NQ words in registers, fed by one float4 of P (a broadcast) per 4
// words and one float of R per column. The warps' sums are then added in
// warp order, (sum_i kappa_i) W_t is subtracted, and each output of the
// tile is written once (0 at the padded words).
template <int NQ>
__device__ void dw_sum_block(const float* __restrict__ regions,
                             const float* __restrict__ W,
                             const float* __restrict__ P,
                             const float* __restrict__ K, int n,
                             const Dims& d, float* __restrict__ ksum,
                             float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* base = reinterpret_cast<float*>(smem4);
  const int p_stage = kDwChunk * d.LT;  // floats of a stage's P rows
  float* sP = base;                     // stage b at sP + b p_stage
  float* sR = base + 2 * p_stage;       // stage b at sR + b kDwChunk kDwTile
  constexpr int CPL = kDwTile / 32;  // columns per lane
  constexpr int Q4 = NQ / 4;
  constexpr int T4 = kDwTile / 4;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int d0 = blockIdx.x * kDwTile;
  const int nch = (d.S + kDwChunk - 1) / kDwChunk;
  const int total = d.Bi * nch;

  auto stage = [&](int c, int buf) {
    const int i = c / nch;
    const int s0 = (c - i * nch) * kDwChunk;
    const int rows = min(kDwChunk, d.S - s0);
    const float* gP = P + (int64_t)i * d.S * d.LT + (int64_t)s0 * NQ;
    for (int e = tid; e < rows * Q4; e += kThreads)
      cp_async16(sP + buf * p_stage + 4 * e, gP + 4 * e, true);
    const float* gR = regions + ((int64_t)i * d.S + s0) * d.D + d0;
    for (int e = tid; e < rows * T4; e += kThreads) {
      const int r = e / T4;
      const int c4 = 4 * (e - r * T4);
      const bool ok = d0 + c4 < d.D;
      cp_async16(sR + (buf * kDwChunk + r) * kDwTile + c4,
                 gR + (int64_t)r * d.D + (ok ? c4 : 0), ok);
    }
    cp_async_commit();
  };

  float acc[NQ][CPL];
#pragma unroll
  for (int l = 0; l < NQ; ++l)
#pragma unroll
    for (int j = 0; j < CPL; ++j) acc[l][j] = 0.0f;

  stage(0, 0);
  for (int c = 0; c < total; ++c) {
    const int buf = c & 1;
    if (c + 1 < total) {
      stage(c + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int rows = min(kDwChunk, d.S - (c % nch) * kDwChunk);
    const float* p = sP + buf * p_stage;
    const float* r = sR + buf * kDwChunk * kDwTile;
    for (int k = warp; k < rows; k += kWarps) {
      float rv[CPL];
#pragma unroll
      for (int j = 0; j < CPL; ++j) rv[j] = r[k * kDwTile + lane + 32 * j];
      const float4* pk = reinterpret_cast<const float4*>(p + k * NQ);
#pragma unroll
      for (int q = 0; q < Q4; ++q) {
        const float4 a = pk[q];
#pragma unroll
        for (int j = 0; j < CPL; ++j) {
          acc[4 * q + 0][j] += a.x * rv[j];
          acc[4 * q + 1][j] += a.y * rv[j];
          acc[4 * q + 2][j] += a.z * rv[j];
          acc[4 * q + 3][j] += a.w * rv[j];
        }
      }
    }
    __syncthreads();
  }

  // sum_i kappa_i, images in index order.
  if (tid < n) {
    float k = 0.0f;
    for (int i = 0; i < d.Bi; ++i) k += K[(int64_t)i * d.L + tid];
    ksum[tid] = k;
  }
  float* red = base;  // (kWarps, NQ, kDwTile) partial sums
#pragma unroll
  for (int l = 0; l < NQ; ++l)
#pragma unroll
    for (int j = 0; j < CPL; ++j)
      red[(warp * NQ + l) * kDwTile + lane + 32 * j] = acc[l][j];
  __syncthreads();
  for (int o = tid; o < d.L * kDwTile; o += kThreads) {
    const int l = o / kDwTile;
    const int cc = o - l * kDwTile;
    const int col = d0 + cc;
    if (col >= d.D) continue;
    float v = 0.0f;
    if (l < n) {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) v += red[(w * NQ + l) * kDwTile + cc];
      v -= ksum[l] * W[(int64_t)l * d.D + col];
    }
    out[(int64_t)l * d.D + col] = v;
  }
}

__global__ void __launch_bounds__(kThreads, 2) damsm_dw_sum(
    const float* __restrict__ regions, const float* __restrict__ words,
    const int* __restrict__ lens, const float* __restrict__ scratch,
    float* __restrict__ dW, Dims d) {
  __shared__ float ksum[32];  // sum_i kappa_i per word
  const int t = blockIdx.y;
  const int n = min(max(lens[t], 0), d.L);
  const float* W = words + (int64_t)t * d.L * d.D;
  const float* P = scratch + (int64_t)t * d.Bi * d.S * d.LT;
  const float* K = scratch + (int64_t)d.Bi * d.Bt * d.S * d.LT +
                   (int64_t)t * d.Bi * d.L;
  float* out = dW + (int64_t)t * d.L * d.D;
  if (n == 0) {  // no valid word: dW_t = 0
    for (int o = threadIdx.x; o < d.L * kDwTile; o += kThreads) {
      const int l = o / kDwTile;
      const int col = blockIdx.x * kDwTile + o - l * kDwTile;
      if (col < d.D) out[(int64_t)l * d.D + col] = 0.0f;
    }
    return;
  }
  EEGAN_WORDS_SWITCH(n, dw_sum_block, regions, W, P, K, n, d, ksum,
                     out)
}

cudaError_t set_smem(const void* fn, size_t bytes) {
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

bool shape_ok(int S, int L, int D) {
  return S > 0 && L > 0 && L <= 32 && D > 0 && D <= kThreads && D % 4 == 0;
}

// Dynamic shared memory and the largest shared-memory carveout for a pair
// kernel, so that two or more of its blocks share an SM.
cudaError_t set_pair_smem(const void* fn, size_t bytes) {
  const cudaError_t err = set_smem(fn, bytes);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(fn,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

// The forward. Its dynamic shared memory, which must cover
// pair_smem_floats(d, 1, 4), and LP come from the launch plan.
cudaError_t fwd(const float* r, const float* w, const int* lens, float* sims,
                Dims d, size_t smem_bytes, float g1, float g2,
                cudaStream_t s) {
  if (d.LP < d.LT || d.LP % 4 != 0 ||
      smem_bytes < pair_smem_floats(d, 1, 4) * sizeof(float) || d.Bi > 65535)
    return cudaErrorInvalidValue;
  const cudaError_t err = set_pair_smem((const void*)damsm_words_fwd,
                                        smem_bytes);
  if (err != cudaSuccess) return err;
  damsm_words_fwd<<<dim3(d.Bt, d.Bi), kThreads, smem_bytes, s>>>(
      r, w, lens, sims, d, g1, g2);
  return cudaGetLastError();
}

// The two launches of dR. The scratch (4 Bi Bt L (2 SP + D) bytes) and pass
// 1's dynamic shared memory, which must cover pair_smem_floats(d, 3, 4), come
// from the launch plan.
cudaError_t bwd_dr(const float* r, const float* w, const int* lens,
                   const float* dsim, float* dR, float* scratch, Dims d,
                   size_t smem_bytes, float g1, float g2, cudaStream_t s) {
  if (d.LP < d.LT || d.LP % 4 != 0 || d.SP < d.S || d.SP % 4 != 0 ||
      smem_bytes < pair_smem_floats(d, 3, 4) * sizeof(float) || d.Bi > 65535)
    return cudaErrorInvalidValue;
  cudaError_t err = set_pair_smem((const void*)damsm_dr_pair, smem_bytes);
  if (err != cudaSuccess) return err;
  damsm_dr_pair<<<dim3(d.Bt, d.Bi), kThreads, smem_bytes, s>>>(
      r, w, lens, dsim, scratch, d, g1, g2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid((d.D + kSumD - 1) / kSumD, (d.S + kSumS - 1) / kSumS, d.Bi);
  damsm_dr_sum<<<grid, kThreads, 0, s>>>(w, lens, scratch, dR, d);
  return cudaGetLastError();
}

// The two launches of dW. The scratch (4 Bi Bt (S LT + L) bytes), the
// tile width, which must be kDwTile, and both dynamic shared memories, which
// must cover pair_smem_floats(d, 3, 5) and dw_sum_floats(d), come from the
// launch plan.
cudaError_t bwd_dw(const float* r, const float* w, const int* lens,
                   const float* dsim, float* dW, float* scratch, Dims d,
                   size_t pair_smem, size_t sum_smem, int tile, float g1,
                   float g2, cudaStream_t s) {
  if (d.LP < d.LT || d.LP % 4 != 0 || tile != kDwTile ||
      pair_smem < pair_smem_floats(d, 3, 5) * sizeof(float) ||
      sum_smem < dw_sum_floats(d) * sizeof(float) || d.Bi > 65535 ||
      d.Bt > 65535)
    return cudaErrorInvalidValue;
  cudaError_t err = set_pair_smem((const void*)damsm_dw_pair, pair_smem);
  if (err != cudaSuccess) return err;
  damsm_dw_pair<<<dim3(d.Bt, d.Bi), kThreads, pair_smem, s>>>(
      r, w, lens, dsim, scratch, d, g1, g2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = set_smem((const void*)damsm_dw_sum, sum_smem);
  if (err != cudaSuccess) return err;
  damsm_dw_sum<<<dim3((d.D + kDwTile - 1) / kDwTile, d.Bt), kThreads,
                 sum_smem, s>>>(r, w, lens, scratch, dW, d);
  return cudaGetLastError();
}

}  // namespace

// All float32 and contiguous: regions (Bi,S,D), words (Bt,L,D), lens (Bt,)
// int32, sims and dsim (Bi,Bt), dR (Bi,S,D), dW (Bt,L,D). smem_bytes is the
// dynamic shared memory of a block, from the launch plan.

// The forward: LP and smem_bytes are the launch plan's.
extern "C" int eegan_damsm_words_fwd(const void* regions, const void* words,
                                     const void* lens, void* sims, int Bi,
                                     int Bt, int S, int L, int D, int LP,
                                     long long smem_bytes, float gamma1,
                                     float gamma2, void* stream) {
  if (!shape_ok(S, L, D) || Bi <= 0 || Bt <= 0) return cudaErrorInvalidValue;
  const Dims d = make_dims(Bi, Bt, S, L, D, LP, 0);
  return fwd(static_cast<const float*>(regions),
             static_cast<const float*>(words), static_cast<const int*>(lens),
             static_cast<float*>(sims), d, (size_t)smem_bytes, gamma1, gamma2,
             static_cast<cudaStream_t>(stream));
}

// dR: scratch is float32 of 4 Bi Bt L (2 SP + D) bytes; LP, SP and
// smem_bytes are the launch plan's.
extern "C" int eegan_damsm_words_bwd_dr(const void* regions, const void* words,
                                        const void* lens, const void* dsim,
                                        void* dR, void* scratch, int Bi,
                                        int Bt, int S, int L, int D, int LP,
                                        int SP, long long smem_bytes,
                                        float gamma1, float gamma2,
                                        void* stream) {
  if (!shape_ok(S, L, D) || Bi <= 0 || Bt <= 0) return cudaErrorInvalidValue;
  const Dims d = make_dims(Bi, Bt, S, L, D, LP, SP);
  return bwd_dr(static_cast<const float*>(regions),
                static_cast<const float*>(words), static_cast<const int*>(lens),
                static_cast<const float*>(dsim), static_cast<float*>(dR),
                static_cast<float*>(scratch), d, (size_t)smem_bytes, gamma1,
                gamma2, static_cast<cudaStream_t>(stream));
}

// dW: scratch is float32 of 4 Bi Bt (S LT + L) bytes; LP, the two shared
// memories and the tile are the launch plan's.
extern "C" int eegan_damsm_words_bwd_dw(const void* regions, const void* words,
                                        const void* lens, const void* dsim,
                                        void* dW, void* scratch, int Bi,
                                        int Bt, int S, int L, int D, int LP,
                                        long long pair_smem,
                                        long long sum_smem, int tile,
                                        float gamma1, float gamma2,
                                        void* stream) {
  if (!shape_ok(S, L, D) || Bi <= 0 || Bt <= 0) return cudaErrorInvalidValue;
  const Dims d = make_dims(Bi, Bt, S, L, D, LP, 0);
  return bwd_dw(static_cast<const float*>(regions),
                static_cast<const float*>(words), static_cast<const int*>(lens),
                static_cast<const float*>(dsim), static_cast<float*>(dW),
                static_cast<float*>(scratch), d, (size_t)pair_smem,
                (size_t)sum_smem, tile, gamma1, gamma2,
                static_cast<cudaStream_t>(stream));
}
