// Fused BN-normalise (+ nearest-2x upsample) + mask-gated affine + ReLU,
// forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel eegan_tpu/ops/affine_pallas.py:_fwd_kernel
// (reached through affine_mask_relu -> _affine_fwd_call). It computes, per
// output element,
//
//   out[b,y,x,c] = relu((gamma[b,c]*m + 1) * (xin[b,y',x',c] - mean[c])
//                       * rsqrt(var[c] + eps) + beta[b,c]*m),
//   m = mask[b,y,x],  (y',x') = up ? (y>>1, x>>1) : (y, x)
//
// in one pass: x is read once and out written once; the upsampled
// normalised map never exists in device memory.
//
// Bound: bytes. The work is a few flops per element, so the least time is
// (|x| + |mask| + |gamma| + |beta| + |mean| + |var| + |out|) over the memory
// rate (3.35 TB/s on an H100 SXM). The train step's largest launch
// (block6.affine1, B=32, C=64, 128x128 -> 256x256, bf16) moves about 335 MB,
// 0.100 ms.
//
// Design (tensors NHWC in memory, the port's channels_last NCHW; launch plan
// from ops/affine.py:forward_launch_plan):
// * A thread owns one vector of V channels (16 bytes of x: 8 bf16 or 4
//   float32; V = 1 when C or a pointer does not allow it, so any C works) of
//   one sample, and loads its constants once, as vectors: r = rsqrt(var +
//   eps), mean, gamma, beta.
// * LANES neighbouring threads cover one pixel's C / V vectors (at most 256;
//   a wider C is split over the grid's y dimension), so a block of 256
//   threads covers 256 / LANES pixels at once and walks over its sample's
//   pixels. Each group takes U pixels per step and issues every load of the
//   step before its arithmetic (U = 4 for 4 channels a thread, 2 for 8, 1
//   with the upsample, whose pixel feeds four outputs).
// * With the upsample a group takes one low-res pixel: x is read once and
//   x-hat computed once, the mask read as two 2-pixel loads (rows 2y and
//   2y + 1), and the 2x2 output quad written as four vector stores.
// * The grid (blocks per sample, channel chunks, B) is one or two whole
//   waves of kBlocksPerSm blocks per SM: a partial wave costs as much as a
//   whole one.
// Arithmetic is float32 whatever the storage types, rounded op by op (no
// fused multiply-add) in the plain PyTorch version's order, so the ReLU
// zeros are the plain version's and those the backward kernel recomputes.
// What the TPU kernel needed for Mosaic (row tiles sized for VMEM, the
// (8,128) padding, the (B,1,C) gamma/beta reshapes) has no counterpart here.
// The kernel launches on the caller's stream and allocates nothing.
//
// C interface: eegan_affine_mask_relu_fwd(...) returns cudaGetLastError()
// after the launch (0 = launched), or cudaErrorInvalidValue for a launch
// plan that does not cover C.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "affine_io.cuh"

namespace {

using eegan_affine::Io;
using eegan_affine::store_vec;
using eegan_affine::Vec;

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 4;  // ops/affine.py:_FWD_BLOCKS_PER_SM

// Pixels a group takes per step (ops/affine.py:_fwd_unroll).
__host__ __device__ constexpr int unroll_for(bool up, int v) {
  return up ? 1 : (v <= 4 ? 4 : 2);
}

template <typename Tin, typename Tout, int V, bool UP>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm) affine_fwd(
    const Tin* __restrict__ x, const float* __restrict__ mean,
    const float* __restrict__ var, const Tin* __restrict__ gamma,
    const Tin* __restrict__ beta, const Tin* __restrict__ mask,
    Tout* __restrict__ out, int h, int w, int C, int lanes, float eps) {
  constexpr int U = unroll_for(UP, V);
  constexpr int NM = UP ? 2 : 1;  // mask values per mask load
  const int groups = kThreads / lanes;
  const int grp = threadIdx.x / lanes;
  const int j = blockIdx.y * lanes + (threadIdx.x - grp * lanes);
  if (grp >= groups || j * V >= C) return;  // no barrier follows
  const int b = blockIdx.z;
  const int c0 = j * V;
  const int hw = h * w;
  const int W = UP ? 2 * w : w;

  // This thread's constants, loaded once.
  Vec<float, V> mu, vr;
  Vec<Tin, V> ga, be;
  mu.load_if(true, mean + c0, mean);
  vr.load_if(true, var + c0, var);
  ga.load_if(true, gamma + (int64_t)b * C + c0, gamma);
  be.load_if(true, beta + (int64_t)b * C + c0, beta);
  float r[V];
#pragma unroll
  for (int e = 0; e < V; ++e) r[e] = rsqrtf(__fadd_rn(vr.get(e), eps));

  const Tin* xb = x + (int64_t)b * hw * C + c0;
  const int step = gridDim.x * groups * U;
  for (int p0 = blockIdx.x * groups * U + grp; p0 < hw; p0 += step) {
    // Every load of the step first.
    Vec<Tin, V> xr[U];
    Vec<Tin, NM> mr[U][NM];  // [u][row]: with UP, rows 2y and 2y + 1
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int p = p0 + u * groups;
      const bool pv = p < hw;
      xr[u].load_if(pv, xb + (int64_t)p * C, x);
      if constexpr (UP) {
        const int iy = p / w;
        const int ix = p - iy * w;
        const int64_t o = ((int64_t)b * 2 * h + 2 * iy) * W + 2 * ix;
        mr[u][0].load_if(pv, mask + o, mask);
        mr[u][1].load_if(pv, mask + o + W, mask);
      } else {
        mr[u][0].load_if(pv, mask + (int64_t)b * hw + p, mask);
      }
    }
    // Then x-hat, the gate and the stores.
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int p = p0 + u * groups;
      if (p >= hw) continue;
      float xh[V];
#pragma unroll
      for (int e = 0; e < V; ++e)
        xh[e] = __fmul_rn(__fsub_rn(xr[u].get(e), mu.get(e)), r[e]);
      const int iy = p / w;
      const int ix = p - iy * w;
#pragma unroll
      for (int q = 0; q < NM * NM; ++q) {
        const float m = mr[u][q >> 1].get(q & 1);
        float o[V];
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float wgt = __fadd_rn(__fmul_rn(ga.get(e), m), 1.0f);
          const float z =
              __fadd_rn(__fmul_rn(wgt, xh[e]), __fmul_rn(be.get(e), m));
          // z < 0 ? 0 : z keeps a NaN, as torch.relu and jnp.maximum do.
          o[e] = z < 0.0f ? 0.0f : z;
        }
        const int64_t op =
            UP ? ((int64_t)b * 2 * h + 2 * iy + (q >> 1)) * W + 2 * ix + (q & 1)
               : (int64_t)b * hw + p;
        store_vec<Tout, V>(out + op * C + c0, o);
      }
    }
  }
}

struct Args {
  const void *x, *gamma, *beta, *mask;
  const float *mean, *var;
  void* out;
  int B, h, w, C, lanes, chunks, nblk;
  float eps;
  cudaStream_t stream;
};

template <typename Tin, typename Tout, int V, bool UP>
cudaError_t launch(const Args& a) {
  affine_fwd<Tin, Tout, V, UP>
      <<<dim3(a.nblk, a.chunks, a.B), kThreads, 0, a.stream>>>(
          static_cast<const Tin*>(a.x), a.mean, a.var,
          static_cast<const Tin*>(a.gamma), static_cast<const Tin*>(a.beta),
          static_cast<const Tin*>(a.mask), static_cast<Tout*>(a.out), a.h,
          a.w, a.C, a.lanes, a.eps);
  return cudaGetLastError();
}

template <typename Tin, typename Tout, int V>
cudaError_t launch_up(const Args& a, int up) {
  return up ? launch<Tin, Tout, V, true>(a) : launch<Tin, Tout, V, false>(a);
}

template <typename Tin, typename Tout>
cudaError_t launch_vec(const Args& a, int vec, int unroll, int up) {
  constexpr int kVec = 16 / sizeof(Tin);
  if (vec == kVec && unroll == unroll_for(up, kVec))
    return launch_up<Tin, Tout, kVec>(a, up);
  if (vec == 1 && unroll == unroll_for(up, 1))
    return launch_up<Tin, Tout, 1>(a, up);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. Shapes: x (B,h,w,C), mask
// (B,H,W), gamma/beta (B,C) in the input dtype; mean/var (C,) float32;
// out (B,H,W,C) in the output dtype; H,W = 2h,2w when up else h,w. All
// contiguous (NHWC). The launch plan (ops/affine.py:forward_launch_plan):
// vec channels per access (1 or 16/sizeof(input); with vec > 1, C a
// multiple of vec and x, gamma, beta, mean, var and out aligned to a whole
// vector), lanes threads per pixel (at most 256), chunks of lanes vectors
// covering C, nblk blocks per sample and chunk, unroll pixels per step (the
// kernel's own rule, unroll_for). With up, mask must be aligned to two
// elements.
extern "C" int eegan_affine_mask_relu_fwd(
    const void* x, const void* mean, const void* var, const void* gamma,
    const void* beta, const void* mask, void* out, int B, int h, int w, int C,
    int up, float eps, int in_dtype, int out_dtype, int vec, int lanes,
    int chunks, int nblk, int unroll, void* stream) {
  const long long nvec = vec > 0 ? C / vec : 0;
  if (B <= 0 || B > 65535 || h <= 0 || w <= 0 ||
      (long long)h * w >= (1LL << 31) || C <= 0 || vec <= 0 || C % vec != 0 ||
      lanes < 1 || lanes > kThreads || chunks < 1 || chunks > 65535 ||
      (long long)lanes * chunks < nvec ||
      (long long)lanes * (chunks - 1) >= nvec || nblk < 1)
    return cudaErrorInvalidValue;
  const Args a{x,     gamma, beta,  mask,
               static_cast<const float*>(mean),
               static_cast<const float*>(var),
               out,   B,     h,     w,
               C,     lanes, chunks, nblk,
               eps,   static_cast<cudaStream_t>(stream)};
  if (in_dtype == 0 && out_dtype == 0)
    return launch_vec<float, float>(a, vec, unroll, up);
  if (in_dtype == 0 && out_dtype == 1)
    return launch_vec<float, __nv_bfloat16>(a, vec, unroll, up);
  if (in_dtype == 1 && out_dtype == 0)
    return launch_vec<__nv_bfloat16, float>(a, vec, unroll, up);
  if (in_dtype == 1 && out_dtype == 1)
    return launch_vec<__nv_bfloat16, __nv_bfloat16>(a, vec, unroll, up);
  return cudaErrorInvalidValue;
}
