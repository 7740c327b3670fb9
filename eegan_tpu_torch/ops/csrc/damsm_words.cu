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
// products into dR) and 8 S L D in the dW pass; the inputs are a few MB.
// The least time is those flops over the card's float32 rate (67 TFLOP/s on
// an H100 SXM, outside the tensor cores).
//
// Design. The TPU kernel packs a tile of texts into the lane dimension and
// needs block-diagonal 0/1 matmuls (bd, gsum) and a one-hot column select
// only because Mosaic cannot reshape lanes; here a block indexes its own
// text and image, and a softmax over one text's words is a plain loop. The
// per-group stabiliser of the TPU kernel is not needed either: the row max
// over one text's words is exact.
//
// * forward: one block per pair (Bi*Bt blocks). W, C and the (S, L) logits
//   and probabilities sit in shared memory; R is read from global memory
//   (9.5 MB for 32 images, held in the 50 MB L2).
// * dR: one block per image, looping over the texts in order; it owns its
//   image's dR rows, so it adds each text's part with a plain read-add-write
//   and no other block touches them. Deterministic, no atomics, no
//   (Bi, Bt, S, D) partial buffer.
// * dW: one block per text, looping over the images in order; each thread
//   keeps its column d of dW for all words in registers.
// Products run on the CUDA cores in float32: R W^T and R dC^T as warp rows
// (lane = word, four regions per step, float4 loads), attn2^T R and dA^T R
// and the dR sums as thread columns (thread = d). A padded word gets
// attn1 = 0 exactly (exp(-1e9 - max)), hence dA = 0, dcos = 0 and an exactly
// zero dW. Tensor cores (wgmma) and more blocks for dR/dW are later work.
//
// C interface: eegan_damsm_words_{fwd,bwd_dr,bwd_dw}(...) return
// cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a shape outside the limits (D % 4 == 0,
// D <= 256, L <= 32).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

template <int LT>
__global__ void __launch_bounds__(kThreads) damsm_words_fwd(
    const float* __restrict__ regions, const float* __restrict__ words,
    const int* __restrict__ lens, float* __restrict__ sims, int Bt, Dims d,
    float gamma1, float gamma2) {
  extern __shared__ float4 smem4[];
  float* sW = reinterpret_cast<float*>(smem4);
  float* sC = sW + LT * d.DP;
  // attn2 overwrites attn1 in place: the forward needs only one (S, LT)
  // grid, so two blocks fit on an SM.
  float* sP1 = sC + LT * d.DP;
  float* sP2 = sP1;
  __shared__ WordStats st;
  const int t = blockIdx.x;
  const int i = blockIdx.y;
  const float* R = regions + (int64_t)i * d.S * d.D;

  load_words<LT>(words, t, d, sW);
  __syncthreads();
  pair_forward<LT>(R, lens[t], gamma1, gamma2, d, sW, sC, sP1, sP2, st);
  if (threadIdx.x == 0) sims[(int64_t)i * Bt + t] = logf(fmaxf(st.Z, kEps));
}

template <int LT>
__global__ void __launch_bounds__(kThreads) damsm_words_bwd_dr(
    const float* __restrict__ regions, const float* __restrict__ words,
    const int* __restrict__ lens, const float* __restrict__ dsim,
    float* __restrict__ dR, int Bt, Dims d, float gamma1, float gamma2) {
  extern __shared__ float4 smem4[];
  float* sW = reinterpret_cast<float*>(smem4);
  float* sC = sW + LT * d.DP;
  float* sdC = sC + LT * d.DP;
  float* sP1 = sdC + LT * d.DP;
  float* sP2 = sP1 + d.S * d.LP;
  float* sP3 = sP2 + d.S * d.LP;
  __shared__ WordStats st;
  const int i = blockIdx.x;
  const float* R = regions + (int64_t)i * d.S * d.D;
  float* out = dR + (int64_t)i * d.S * d.D;

  for (int t = 0; t < Bt; ++t) {
    load_words<LT>(words, t, d, sW);
    __syncthreads();
    pair_forward<LT>(R, lens[t], gamma1, gamma2, d, sW, sC, sP1, sP2, st);
    pair_backward<LT>(R, dsim[(int64_t)i * Bt + t], gamma1, gamma2, d, sW, sC,
                      sP1, sP2, sdC, sP3, st);
    // dR[s, c] += sum_l dA[s, l] W[l, c] + attn2[s, l] dC[l, c].
    for (int c = threadIdx.x; c < d.D; c += kThreads) {
      float wv[LT], dcv[LT];
#pragma unroll
      for (int l = 0; l < LT; ++l) {
        wv[l] = sW[l * d.DP + c];
        dcv[l] = sdC[l * d.DP + c];
      }
      for (int s = 0; s < d.S; ++s) {
        const float4* a = reinterpret_cast<const float4*>(sP3 + s * d.LP);
        const float4* b = reinterpret_cast<const float4*>(sP2 + s * d.LP);
        float v = 0.0f;
#pragma unroll
        for (int q = 0; q < LT / 4; ++q) {
          const float4 x = a[q];
          const float4 y = b[q];
          v += x.x * wv[4 * q] + x.y * wv[4 * q + 1] + x.z * wv[4 * q + 2] +
               x.w * wv[4 * q + 3];
          v += y.x * dcv[4 * q] + y.y * dcv[4 * q + 1] + y.z * dcv[4 * q + 2] +
               y.w * dcv[4 * q + 3];
        }
        float* o = out + (int64_t)s * d.D + c;
        *o = t == 0 ? v : *o + v;
      }
    }
    __syncthreads();
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

template <int LT>
cudaError_t fwd(const float* r, const float* w, const int* lens, float* sims,
                int Bi, int Bt, int S, int L, int D, float g1, float g2,
                cudaStream_t s) {
  const Dims d = make_dims(S, L, D, LT);
  const size_t bytes = smem_floats(LT, d, 2, 1) * sizeof(float);
  cudaError_t err = set_smem((const void*)damsm_words_fwd<LT>, bytes);
  if (err != cudaSuccess) return err;
  damsm_words_fwd<LT><<<dim3(Bt, Bi), kThreads, bytes, s>>>(r, w, lens, sims,
                                                             Bt, d, g1, g2);
  return cudaGetLastError();
}

template <int LT>
cudaError_t bwd_dr(const float* r, const float* w, const int* lens,
                   const float* dsim, float* dR, int Bi, int Bt, int S, int L,
                   int D, float g1, float g2, cudaStream_t s) {
  const Dims d = make_dims(S, L, D, LT);
  const size_t bytes = smem_floats(LT, d, 3, 3) * sizeof(float);
  cudaError_t err = set_smem((const void*)damsm_words_bwd_dr<LT>, bytes);
  if (err != cudaSuccess) return err;
  damsm_words_bwd_dr<LT><<<Bi, kThreads, bytes, s>>>(r, w, lens, dsim, dR, Bt,
                                                      d, g1, g2);
  return cudaGetLastError();
}

template <int LT>
cudaError_t bwd_dw(const float* r, const float* w, const int* lens,
                   const float* dsim, float* dW, int Bi, int Bt, int S, int L,
                   int D, float g1, float g2, cudaStream_t s) {
  const Dims d = make_dims(S, L, D, LT);
  const size_t bytes = smem_floats(LT, d, 3, 3) * sizeof(float);
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
// int32, sims and dsim (Bi,Bt), dR (Bi,S,D), dW (Bt,L,D).
extern "C" int eegan_damsm_words_fwd(const void* regions, const void* words,
                                     const void* lens, void* sims, int Bi,
                                     int Bt, int S, int L, int D, float gamma1,
                                     float gamma2, void* stream) {
  EEGAN_DAMSM_DISPATCH(fwd, static_cast<const float*>(regions),
                       static_cast<const float*>(words),
                       static_cast<const int*>(lens),
                       static_cast<float*>(sims), Bi, Bt, S, L, D, gamma1,
                       gamma2, static_cast<cudaStream_t>(stream))
}

extern "C" int eegan_damsm_words_bwd_dr(const void* regions, const void* words,
                                        const void* lens, const void* dsim,
                                        void* dR, int Bi, int Bt, int S, int L,
                                        int D, float gamma1, float gamma2,
                                        void* stream) {
  EEGAN_DAMSM_DISPATCH(bwd_dr, static_cast<const float*>(regions),
                       static_cast<const float*>(words),
                       static_cast<const int*>(lens),
                       static_cast<const float*>(dsim),
                       static_cast<float*>(dR), Bi, Bt, S, L, D, gamma1,
                       gamma2, static_cast<cudaStream_t>(stream))
}

extern "C" int eegan_damsm_words_bwd_dw(const void* regions, const void* words,
                                        const void* lens, const void* dsim,
                                        void* dW, int Bi, int Bt, int S, int L,
                                        int D, float gamma1, float gamma2,
                                        void* stream) {
  EEGAN_DAMSM_DISPATCH(bwd_dw, static_cast<const float*>(regions),
                       static_cast<const float*>(words),
                       static_cast<const int*>(lens),
                       static_cast<const float*>(dsim),
                       static_cast<float*>(dW), Bi, Bt, S, L, D, gamma1,
                       gamma2, static_cast<cudaStream_t>(stream))
}

// Dynamic shared memory, in bytes, that a launch of the forward (kind 0) or
// a backward pass (kind 1) needs at these shapes; the wrapper checks it
// against the card's per-block limit before launching.
extern "C" long long eegan_damsm_words_smem_bytes(int kind, int S, int L,
                                                  int D) {
  const int LT = L <= 8 ? 8 : L <= 16 ? 16 : L <= 24 ? 24 : 32;
  const Dims d = make_dims(S, L, D, LT);
  const size_t floats = kind == 0 ? smem_floats(LT, d, 2, 1)
                                  : smem_floats(LT, d, 3, 3);
  return (long long)(floats * sizeof(float));
}
