// DAMSM word-region similarity, forward and both backward passes, for
// Hopper (sm_90a).
//
// Replaces the three TPU kernels of eegan_tpu/ops/damsm_pallas.py:
//   damsm_words_fwd   <- _kernel          (words_similarity_fused)
//   damsm_words_bwd_dr <- _bwd_dr_kernel  (_words_sim_bwd, dR pass)
//   damsm_words_bwd_dw <- _bwd_dw_kernel  (_words_sim_bwd, dW pass)
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
// * The pair's forward (pair_attend), shared by the forward kernel and dR's
//   first pass, runs over the text's n valid words only (rounded up to NQ,
//   a multiple of 4, a template parameter chosen per block). Its products
//   (A = R W^T, C = attn2^T R; dR adds da2 = R dC^T) keep register tiles: a
//   thread owns up to four regions x NQ words (or four columns x NQ words),
//   so each float4 of R read from the L2 (9.5 MB for 32 images, held in the
//   50 MB L2) feeds 4 NQ multiply-adds or more, and the next one is loaded
//   before they run. The softmaxes, cosines and Z are group-wide: a word
//   group of WG lanes (NQ rounded up to a power of 2) takes a region row,
//   and the reductions are shuffles in the group or fixed-order sums of 256
//   partials in shared memory.
// * forward, damsm_words_fwd: one block per pair (Bt x Bi = 1024 blocks at
//   the train shape); W, C and one (S, LP) grid (attn2 overwrites attn1) in
//   shared memory, 64.7 KB at that shape. Two blocks share an SM: the
//   registers (128 a thread) allow no third, and capping them at 80 for
//   three blocks spills and runs slower.
// * dR, two launches, no atomics, deterministic:
//   - damsm_dr_pair, one block per pair, runs the pair's forward and
//     backward down to dA and dC, and writes dA and attn2 (n x S) and dC
//     (n x D) to a float32 scratch of 4 Bi Bt L (2 SP + D) bytes (68.8 MB at
//     (32, 32, 289, 20, 256)). W, C/dC and three (S, LP) grids (attn1,
//     attn2, da2/dA) are in shared memory, 112.5 KB at that shape, so two
//     blocks fit on an SM.
//   - damsm_dr_sum, one block per image and 64 x 64 tile of (S, D) (640
//     blocks), sums dR = sum_t (dA_t W_t + attn2_t dC_t) over the texts in
//     index order, a product with K = 2 n_t per text staged in shared
//     memory, 4 x 4 outputs per thread, each output written once.
// * dW: one block per text, looping over the images in order; each thread
//   keeps its column d of dW for all words in registers. It still uses one
//   block per text (32 blocks) and its own per-pair code over all L words
//   (pair_forward, pair_backward).
// Products run on the CUDA cores in float32. A padded word gets
// attn1 = 0 exactly (exp(-1e9 - max)), hence dA = 0, dcos = 0 and an exactly
// zero dW; the forward and dR skip padded words altogether.
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
constexpr float kNegInf = -1e9f;
constexpr float kEps = 1e-8f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Shape of one pair's problem and its shared-memory layout.
struct Dims {
  int S, L, D;
  int DP;  // row stride of the (LT, D) tiles: D + 4 (float4-aligned, and
           // conflict-free for the lane = word float4 reads)
  int LP;  // row stride of the (S, LT) tiles: LT + 4
};

// Per-word quantities of the current pair.
struct WordStats {
  float cos[32], den[32], wn2[32], cn2[32], row[32], dcos[32];
  float Z;
};

// out[s, l] = <R[s], M[l]> for l < L: lane = word, a warp takes four
// regions per step, the float4 loads of R are broadcast across the warp.
__device__ void rows_dot(const float* __restrict__ R, const float* M,
                         float* out, const Dims& d) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int l = lane < d.L ? lane : 0;
  const float4* m = reinterpret_cast<const float4*>(M + l * d.DP);
  const int D4 = d.D / 4;
  for (int s0 = warp * 4; s0 < d.S; s0 += kWarps * 4) {
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    const float4* r[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int s = s0 + k < d.S ? s0 + k : d.S - 1;
      r[k] = reinterpret_cast<const float4*>(R + (int64_t)s * d.D);
    }
    for (int q = 0; q < D4; ++q) {
      const float4 w = m[q];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float4 v = __ldg(r[k] + q);
        acc[k] += v.x * w.x + v.y * w.y + v.z * w.z + v.w * w.w;
      }
    }
    if (lane < d.L) {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (s0 + k < d.S) out[(s0 + k) * d.LP + lane] = acc[k];
    }
  }
}

// acc[l] += sum_s P[s, l] * R[s, dcol] for l < LT (thread = column dcol).
template <int LT>
__device__ __forceinline__ void cols_accumulate(const float* __restrict__ R,
                                                const float* P, int dcol,
                                                const Dims& d, float* acc) {
  for (int s = 0; s < d.S; ++s) {
    const float r = __ldg(R + (int64_t)s * d.D + dcol);
    const float4* p = reinterpret_cast<const float4*>(P + s * d.LP);
#pragma unroll
    for (int q = 0; q < LT / 4; ++q) {
      const float4 a = p[q];
      acc[4 * q + 0] += a.x * r;
      acc[4 * q + 1] += a.y * r;
      acc[4 * q + 2] += a.z * r;
      acc[4 * q + 3] += a.w * r;
    }
  }
}

// Loads W = words[t] into sW (rows L..LT-1 zero).
template <int LT>
__device__ void load_words(const float* __restrict__ words, int t,
                           const Dims& d, float* sW) {
  for (int i = threadIdx.x; i < LT * d.D; i += kThreads) {
    const int l = i / d.D;
    const int c = i - l * d.D;
    sW[l * d.DP + c] =
        l < d.L ? words[((int64_t)t * d.L + l) * d.D + c] : 0.0f;
  }
}

// The forward of one pair: sP1 <- attn1, sP2 <- attn2, sC <- C (columns and
// rows l >= L zero), st <- cos, norms, row, Z. Starts and ends with a
// barrier-separated state.
template <int LT>
__device__ void pair_forward(const float* __restrict__ R, int len,
                             float gamma1, float gamma2, const Dims& d,
                             const float* sW, float* sC, float* sP1,
                             float* sP2, WordStats& st) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  rows_dot(R, sW, sP1, d);
  __syncthreads();

  // Softmax over the words of each region (masked), in place.
  for (int s = tid; s < d.S; s += kThreads) {
    float* p = sP1 + s * d.LP;
    float mx = -INFINITY;
    for (int l = 0; l < d.L; ++l) mx = fmaxf(mx, l < len ? p[l] : kNegInf);
    float sum = 0.0f;
    for (int l = 0; l < d.L; ++l) {
      const float e = expf((l < len ? p[l] : kNegInf) - mx);
      p[l] = e;
      sum += e;
    }
    for (int l = 0; l < d.L; ++l) p[l] = p[l] / sum;
    for (int l = d.L; l < LT; ++l) p[l] = 0.0f;
  }
  __syncthreads();

  // Softmax over the regions of gamma1 * attn1, one warp per word.
  for (int l = warp; l < LT; l += kWarps) {
    if (l >= d.L) {
      for (int s = lane; s < d.S; s += 32) sP2[s * d.LP + l] = 0.0f;
      continue;
    }
    float mx = -INFINITY;
    for (int s = lane; s < d.S; s += 32)
      mx = fmaxf(mx, gamma1 * sP1[s * d.LP + l]);
    mx = warp_max(mx);
    float sum = 0.0f;
    for (int s = lane; s < d.S; s += 32)
      sum += expf(gamma1 * sP1[s * d.LP + l] - mx);
    sum = warp_sum(sum);
    for (int s = lane; s < d.S; s += 32)
      sP2[s * d.LP + l] = expf(gamma1 * sP1[s * d.LP + l] - mx) / sum;
  }
  __syncthreads();

  // Context C = attn2^T R, thread = column.
  for (int c = tid; c < d.D; c += kThreads) {
    float acc[LT];
#pragma unroll
    for (int l = 0; l < LT; ++l) acc[l] = 0.0f;
    cols_accumulate<LT>(R, sP2, c, d, acc);
#pragma unroll
    for (int l = 0; l < LT; ++l) sC[l * d.DP + c] = acc[l];
  }
  __syncthreads();

  // Cosine and the masked exp, one warp per word.
  for (int l = warp; l < d.L; l += kWarps) {
    float wc = 0.0f, ww = 0.0f, cc = 0.0f;
    for (int c = lane; c < d.D; c += 32) {
      const float a = sW[l * d.DP + c];
      const float b = sC[l * d.DP + c];
      wc += a * b;
      ww += a * a;
      cc += b * b;
    }
    wc = warp_sum(wc);
    ww = warp_sum(ww);
    cc = warp_sum(cc);
    if (lane == 0) {
      const float den = fmaxf(sqrtf(ww) * sqrtf(cc), kEps);
      const float cs = wc / den;
      st.cos[l] = cs;
      st.den[l] = den;
      st.wn2[l] = fmaxf(ww, kEps * kEps);
      st.cn2[l] = fmaxf(cc, kEps * kEps);
      st.row[l] = l < len ? expf(gamma2 * cs) : 0.0f;
    }
  }
  __syncthreads();
  if (tid == 0) {
    float z = 0.0f;
    for (int l = 0; l < d.L; ++l) z += st.row[l];
    st.Z = z;
  }
  __syncthreads();
}

// The backward of one pair down to dA, from g = dsim[i, t]:
// st.dcos, sdC <- dC, sP3 <- dA. Needs pair_forward's results.
template <int LT>
__device__ void pair_backward(const float* __restrict__ R, float g,
                              float gamma1, float gamma2, const Dims& d,
                              const float* sW, const float* sC,
                              const float* sP1, const float* sP2, float* sdC,
                              float* sP3, WordStats& st) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  if (tid < LT)
    st.dcos[tid] = tid < d.L ? g * st.row[tid] * gamma2 / fmaxf(st.Z, kEps)
                             : 0.0f;
  __syncthreads();
  for (int i = tid; i < LT * d.D; i += kThreads) {
    const int l = i / d.D;
    const int c = i - l * d.D;
    float v = 0.0f;
    if (l < d.L)
      v = st.dcos[l] * (sW[l * d.DP + c] / st.den[l] -
                        st.cos[l] * sC[l * d.DP + c] / st.cn2[l]);
    sdC[l * d.DP + c] = v;
  }
  __syncthreads();

  // da2 = R dC^T, then back through the softmax over regions.
  rows_dot(R, sdC, sP3, d);
  __syncthreads();
  for (int l = warp; l < LT; l += kWarps) {
    if (l >= d.L) {
      for (int s = lane; s < d.S; s += 32) sP3[s * d.LP + l] = 0.0f;
      continue;
    }
    float colsum = 0.0f;
    for (int s = lane; s < d.S; s += 32)
      colsum += sP2[s * d.LP + l] * sP3[s * d.LP + l];
    colsum = warp_sum(colsum);
    // da1 = gamma1 * dG, dG = attn2 * (da2 - colsum).
    for (int s = lane; s < d.S; s += 32) {
      const int j = s * d.LP + l;
      sP3[j] = gamma1 * (sP2[j] * (sP3[j] - colsum));
    }
  }
  __syncthreads();
  // Back through the softmax over words: dA = attn1 * (da1 - <attn1, da1>).
  for (int s = tid; s < d.S; s += kThreads) {
    const float* a = sP1 + s * d.LP;
    float* p = sP3 + s * d.LP;
    float rowsum = 0.0f;
    for (int l = 0; l < d.L; ++l) rowsum += a[l] * p[l];
    for (int l = 0; l < d.L; ++l) p[l] = a[l] * (p[l] - rowsum);
  }
  __syncthreads();
}

size_t smem_floats(int LT, const Dims& d, int n_tiles, int n_grids) {
  return (size_t)n_tiles * LT * d.DP + (size_t)n_grids * d.S * d.LP;
}

// ---------------------------------------------------------------------------
// The forward and dR's first pass, one block per (text, image) pair over the
// text's valid words; then damsm_dr_sum, one block per (image, 64x64 tile).
// ---------------------------------------------------------------------------

// Layout of the pair blocks' shared memory and dR's scratch: LT = L rounded
// up to 4, the rows of the (LT, D) tiles; LP, the row stride of the (S, LP)
// grids; SP, the row stride of the scratch's (L, SP) planes. LP and SP come
// from the launch plans (ops/damsm.py:fwd_launch_plan, dr_launch_plan).
struct DrDims {
  int Bi, Bt, S, L, D;
  int LT, LP, DP, SP;
};

DrDims make_dr_dims(int Bi, int Bt, int S, int L, int D, int LP, int SP) {
  DrDims d;
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
                                             int s0, int q, const DrDims& d) {
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
                        float* out, const DrDims& d) {
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
                        const DrDims& d) {
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

// Per-word statistics of a pair, in shared memory (32 floats each).
struct PairStats {
  float *cos, *den, *cn2, *row;
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
                            float gamma2, const DrDims& d, float* sW,
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
      }
    }
  }
  __syncthreads();
}

// Shared-memory layout of a pair block: sW and sC (LT, DP), then the (S, LP)
// grids (three for dR, one for the forward), kThreads floats of partials and
// four 32-float arrays of per-word statistics.
size_t pair_smem_floats(const DrDims& d, int grids) {
  return (size_t)2 * d.LT * d.DP + (size_t)grids * d.S * d.LP + kThreads +
         4 * 32;
}

// One (text t, image i) pair of the dR pass, for n valid words rounded up to
// NQ (a multiple of 4). Writes the pair's dA and attn2 (n rows of S, word
// major) and dC (n rows of D) to the scratch; damsm_dr_sum makes dR of them.
template <int NQ>
__device__ void dr_pair(const float* __restrict__ R,
                        const float* __restrict__ W, int n, float g,
                        float gamma1, float gamma2, const DrDims& d,
                        float* __restrict__ oA, float* __restrict__ oG,
                        float* __restrict__ oC) {
  extern __shared__ float4 smem4[];
  float* sW = reinterpret_cast<float*>(smem4);  // (LT, DP) words, 0 for l >= n
  float* sC = sW + d.LT * d.DP;                 // (LT, DP) C, then dC
  float* sP1 = sC + d.LT * d.DP;                // (S, LP) A, then attn1
  float* sP2 = sP1 + d.S * d.LP;                // (S, LP) attn2
  float* sX = sP2 + d.S * d.LP;                 // (S, LP) da2, then dA
  float* red = sX + d.S * d.LP;                 // kThreads partials
  const PairStats st{red + kThreads, red + kThreads + 32,
                     red + kThreads + 64, red + kThreads + 96};
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

  // Copy out, word major: dA and attn2 (s fastest), dC.
  for (int k = tid; k < n * d.S; k += kThreads) {
    const int r = k / d.S;
    const int s = k - r * d.S;
    oA[r * d.SP + s] = sX[s * d.LP + r];
    oG[r * d.SP + s] = sP2[s * d.LP + r];
  }
  for (int k = tid; k < n * D4; k += kThreads) {
    const int r = k / D4;
    const int c = k - r * D4;
    reinterpret_cast<float4*>(oC + r * d.D)[c] =
        *reinterpret_cast<const float4*>(sC + r * d.DP + 4 * c);
  }
}

// The forward: grid (Bt, Bi), one block per pair. One (S, LP) grid (attn2
// overwrites attn1), 64.7 KB at the train shape (L = 20). A text with no
// valid word gets log(eps), as the reference's masked sum of 0 does.
template <int NQ>
__device__ void fwd_pair(const float* __restrict__ R,
                         const float* __restrict__ W, int n, float gamma1,
                         float gamma2, const DrDims& d,
                         float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* sW = reinterpret_cast<float*>(smem4);  // (LT, DP) words
  float* sC = sW + d.LT * d.DP;                 // (LT, DP) C
  float* sP = sC + d.LT * d.DP;                 // (S, LP) attn1, then attn2
  float* red = sP + d.S * d.LP;                 // kThreads partials
  const PairStats st{red + kThreads, red + kThreads + 32,
                     red + kThreads + 64, red + kThreads + 96};
  pair_attend<NQ>(R, W, n, gamma1, gamma2, d, sW, sC, sP, sP, red, st);
  const int tid = threadIdx.x;
  if (tid < 32) {  // Z as dR's pass sums it: the valid words' rows, a warp
    const float Z = warp_sum(tid < n ? st.row[tid] : 0.0f);
    if (tid == 0) *out = logf(fmaxf(Z, kEps));
  }
}

__global__ void __launch_bounds__(kThreads, 2) damsm_words_fwd(
    const float* __restrict__ regions, const float* __restrict__ words,
    const int* __restrict__ lens, float* __restrict__ sims, DrDims d,
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
  switch ((n + 3) / 4) {
#define EEGAN_FWD_CASE(Q)                                \
  case Q:                                                \
    fwd_pair<4 * Q>(R, W, n, gamma1, gamma2, d, out);    \
    break;
    EEGAN_FWD_CASE(1)
    EEGAN_FWD_CASE(2)
    EEGAN_FWD_CASE(3)
    EEGAN_FWD_CASE(4)
    EEGAN_FWD_CASE(5)
    EEGAN_FWD_CASE(6)
    EEGAN_FWD_CASE(7)
    EEGAN_FWD_CASE(8)
#undef EEGAN_FWD_CASE
  }
}

// dR pass 1: grid (Bt, Bi), one block per pair; two blocks fit on an SM
// while the shared memory allows (L <= 20 at S = 289, D = 256).
__global__ void __launch_bounds__(kThreads, 2) damsm_dr_pair(
    const float* __restrict__ regions, const float* __restrict__ words,
    const int* __restrict__ lens, const float* __restrict__ dsim,
    float* __restrict__ scratch, DrDims d, float gamma1, float gamma2) {
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
  switch ((n + 3) / 4) {
#define EEGAN_DR_CASE(Q)                                                     \
  case Q:                                                                    \
    dr_pair<4 * Q>(R, W, n, g, gamma1, gamma2, d, oA, oG, oC);               \
    break;
    EEGAN_DR_CASE(1)
    EEGAN_DR_CASE(2)
    EEGAN_DR_CASE(3)
    EEGAN_DR_CASE(4)
    EEGAN_DR_CASE(5)
    EEGAN_DR_CASE(6)
    EEGAN_DR_CASE(7)
    EEGAN_DR_CASE(8)
#undef EEGAN_DR_CASE
  }
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
    const float* __restrict__ scratch, float* __restrict__ dR, DrDims d) {
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

template <int LT>
__global__ void __launch_bounds__(kThreads) damsm_words_bwd_dw(
    const float* __restrict__ regions, const float* __restrict__ words,
    const int* __restrict__ lens, const float* __restrict__ dsim,
    float* __restrict__ dW, int Bi, int Bt, Dims d, float gamma1,
    float gamma2) {
  extern __shared__ float4 smem4[];
  float* sW = reinterpret_cast<float*>(smem4);
  float* sC = sW + LT * d.DP;
  float* sdC = sC + LT * d.DP;
  float* sP1 = sdC + LT * d.DP;
  float* sP2 = sP1 + d.S * d.LP;
  float* sP3 = sP2 + d.S * d.LP;
  __shared__ WordStats st;
  const int t = blockIdx.x;
  const int c = threadIdx.x;  // this thread's column of dW (D <= kThreads)
  const int len = lens[t];

  float acc[LT];
#pragma unroll
  for (int l = 0; l < LT; ++l) acc[l] = 0.0f;

  load_words<LT>(words, t, d, sW);
  __syncthreads();
  for (int i = 0; i < Bi; ++i) {
    const float* R = regions + (int64_t)i * d.S * d.D;
    pair_forward<LT>(R, len, gamma1, gamma2, d, sW, sC, sP1, sP2, st);
    pair_backward<LT>(R, dsim[(int64_t)i * Bt + t], gamma1, gamma2, d, sW, sC,
                      sP1, sP2, sdC, sP3, st);
    if (c < d.D) {
      // The cosine's direct term, then dA^T R.
#pragma unroll
      for (int l = 0; l < LT; ++l) {
        if (l < d.L)
          acc[l] += st.dcos[l] * (sC[l * d.DP + c] / st.den[l] -
                                  st.cos[l] * sW[l * d.DP + c] / st.wn2[l]);
      }
      cols_accumulate<LT>(R, sP3, c, d, acc);
    }
    __syncthreads();
  }
  if (c < d.D) {
#pragma unroll
    for (int l = 0; l < LT; ++l)
      if (l < d.L) dW[((int64_t)t * d.L + l) * d.D + c] = acc[l];
  }
}

cudaError_t set_smem(const void* fn, size_t bytes) {
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

Dims make_dims(int S, int L, int D, int LT) {
  Dims d;
  d.S = S;
  d.L = L;
  d.D = D;
  d.DP = D + 4;
  d.LP = LT + 4;
  return d;
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
// pair_smem_floats(d, 1), and LP come from the launch plan.
cudaError_t fwd(const float* r, const float* w, const int* lens, float* sims,
                DrDims d, size_t smem_bytes, float g1, float g2,
                cudaStream_t s) {
  if (d.LP < d.LT || d.LP % 4 != 0 ||
      smem_bytes < pair_smem_floats(d, 1) * sizeof(float) || d.Bi > 65535)
    return cudaErrorInvalidValue;
  const cudaError_t err = set_pair_smem((const void*)damsm_words_fwd,
                                        smem_bytes);
  if (err != cudaSuccess) return err;
  damsm_words_fwd<<<dim3(d.Bt, d.Bi), kThreads, smem_bytes, s>>>(
      r, w, lens, sims, d, g1, g2);
  return cudaGetLastError();
}

// The two launches of dR. The scratch (4 Bi Bt L (2 SP + D) bytes) and pass
// 1's dynamic shared memory, which must cover pair_smem_floats(d, 3), come
// from the launch plan.
cudaError_t bwd_dr(const float* r, const float* w, const int* lens,
                   const float* dsim, float* dR, float* scratch, DrDims d,
                   size_t smem_bytes, float g1, float g2, cudaStream_t s) {
  if (d.LP < d.LT || d.LP % 4 != 0 || d.SP < d.S || d.SP % 4 != 0 ||
      smem_bytes < pair_smem_floats(d, 3) * sizeof(float) || d.Bi > 65535)
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

template <int LT>
cudaError_t bwd_dw(const float* r, const float* w, const int* lens,
                   const float* dsim, float* dW, int Bi, int Bt, int S, int L,
                   int D, size_t bytes, float g1, float g2, cudaStream_t s) {
  const Dims d = make_dims(S, L, D, LT);
  if (bytes < smem_floats(LT, d, 3, 3) * sizeof(float))
    return cudaErrorInvalidValue;
  cudaError_t err = set_smem((const void*)damsm_words_bwd_dw<LT>, bytes);
  if (err != cudaSuccess) return err;
  damsm_words_bwd_dw<LT><<<Bt, kThreads, bytes, s>>>(r, w, lens, dsim, dW, Bi,
                                                      Bt, d, g1, g2);
  return cudaGetLastError();
}

}  // namespace

#define EEGAN_DAMSM_DISPATCH(FN, ...)                   \
  if (!shape_ok(S, L, D)) return cudaErrorInvalidValue; \
  if (L <= 8) return FN<8>(__VA_ARGS__);                \
  if (L <= 16) return FN<16>(__VA_ARGS__);              \
  if (L <= 24) return FN<24>(__VA_ARGS__);              \
  return FN<32>(__VA_ARGS__);

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
  const DrDims d = make_dr_dims(Bi, Bt, S, L, D, LP, 0);
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
  const DrDims d = make_dr_dims(Bi, Bt, S, L, D, LP, SP);
  return bwd_dr(static_cast<const float*>(regions),
                static_cast<const float*>(words), static_cast<const int*>(lens),
                static_cast<const float*>(dsim), static_cast<float*>(dR),
                static_cast<float*>(scratch), d, (size_t)smem_bytes, gamma1,
                gamma2, static_cast<cudaStream_t>(stream));
}

extern "C" int eegan_damsm_words_bwd_dw(const void* regions, const void* words,
                                        const void* lens, const void* dsim,
                                        void* dW, int Bi, int Bt, int S, int L,
                                        int D, long long smem_bytes,
                                        float gamma1, float gamma2,
                                        void* stream) {
  EEGAN_DAMSM_DISPATCH(bwd_dw, static_cast<const float*>(regions),
                       static_cast<const float*>(words),
                       static_cast<const int*>(lens),
                       static_cast<const float*>(dsim),
                       static_cast<float*>(dW), Bi, Bt, S, L, D,
                       (size_t)smem_bytes, gamma1, gamma2,
                       static_cast<cudaStream_t>(stream))
}
