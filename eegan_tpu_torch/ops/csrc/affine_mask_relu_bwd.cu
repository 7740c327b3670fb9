// Backward of the fused BN-normalise (+ nearest-2x upsample) + mask-gated
// affine + ReLU, for Hopper (sm_90a).
//
// Replaces the TPU kernel eegan_tpu/ops/affine_pallas.py:_bwd_kernel
// (reached through _affine_vjp_bwd). With xhat = (x - mean) * r,
// r = rsqrt(var + eps), wgt = gamma*m + 1, z = wgt*xhat + beta*m and
// g = dy * (z > 0) at each output element (b, y, x, c):
//
//   dx[b,y',x',c] = r[c] * sum of g*wgt over the 1 (or, with up, 4) output
//                   pixels that read x[b,y',x',c]
//   dmask[b,y,x]  = sum_c g * (gamma*xhat + beta)
//   dgamma[b,c]   = sum_{y,x} g*xhat*m          dbeta[b,c] = sum_{y,x} g*m
//   dmean[c]      = -r * sum_{b,y,x} g*wgt
//   dvar[c]       = -r^2/2 * sum_{b,y,x} g*wgt*xhat
//
// z is recomputed from the inputs; nothing of the forward is saved.
//
// Bound: bytes. It reads x, dy, mask, gamma, beta, mean, var once and writes
// dx and dmask once, a few flops per element: the least time is those bytes
// over the memory rate (3.35 TB/s on an H100 SXM).
//
// Design. The TPU kernel carries dgamma/dbeta over row tiles and dmean/dvar
// over its whole sequential grid. Blocks on Hopper run in no order, so those
// sums are cross-block reductions, done in two passes without atomics:
//
// * affine_bwd_main: a block covers part of one sample's low-res pixels; a
//   warp takes one low-res pixel at a time (with up, also its four output
//   pixels, so the 2x2 down-sum of dx needs no atomics) and its lanes take
//   channels c = lane + 32k, k < CPL. dmask, a sum over channels, is a warp
//   reduction. Each lane keeps its channels' four running sums (g*xhat*m,
//   g*m, g*wgt, g*wgt*xhat) in registers over all the pixels its warp
//   takes; the block adds its warps' sums in warp order in shared memory
//   and writes them to a float32 scratch, partial[b][block][4][C].
// * affine_bwd_finalize: one thread per (b, c) sums the sample's block
//   partials into dgamma/dbeta, one thread per c sums all of them into
//   dmean/dvar, in a fixed order. The result is deterministic.
//
// The "reduce at the high resolution" rule of the TPU kernel is a Mosaic
// workaround; here dvar comes from sum(g*wgt*xhat) at the output pixels,
// the same identity. Arithmetic is float32 whatever the storage types.
//
// xhat, wgt and z are rounded op by op (no fused multiply-add), in the order
// of the plain PyTorch version, so the ReLU gate (z > 0) is the same bit for
// bit: where z lies within an fp32 rounding of 0, a contracted z could fall
// on the other side and move dx by a whole dy*wgt*r.
//
// C interface: eegan_affine_mask_relu_bwd(...) returns cudaGetLastError()
// after the two launches (0 = launched).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T>
struct Io;

template <>
struct Io<float> {
  static __device__ __forceinline__ float to_f(float v) { return v; }
  static __device__ __forceinline__ float from_f(float v) { return v; }
};

template <>
struct Io<__nv_bfloat16> {
  static __device__ __forceinline__ float to_f(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  static __device__ __forceinline__ __nv_bfloat16 from_f(float v) {
    return __float2bfloat16_rn(v);
  }
};

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Tin: x, gamma, beta, mask, dx, dmask. Tout: dy (the forward's output).
template <typename Tin, typename Tout, int CPL>
__global__ void __launch_bounds__(kThreads) affine_bwd_main(
    const Tin* __restrict__ x, const float* __restrict__ mean,
    const float* __restrict__ var, const Tin* __restrict__ gamma,
    const Tin* __restrict__ beta, const Tin* __restrict__ mask,
    const Tout* __restrict__ dy, Tin* __restrict__ dx,
    Tin* __restrict__ dmask, float* __restrict__ partial, int h, int w,
    int C, int up, float eps) {
  __shared__ float red[4 * CPL * 32];
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int H = up ? 2 * h : h;
  const int W = up ? 2 * w : w;
  const int nsub = up ? 4 : 1;

  float r[CPL], mu[CPL], ga[CPL], be[CPL];
  float s_gxm[CPL], s_gm[CPL], s_gw[CPL], s_gwx[CPL];
#pragma unroll
  for (int k = 0; k < CPL; ++k) {
    const int c = lane + 32 * k;
    const bool ok = c < C;
    r[k] = ok ? rsqrtf(var[c] + eps) : 0.0f;
    mu[k] = ok ? mean[c] : 0.0f;
    ga[k] = ok ? Io<Tin>::to_f(gamma[(int64_t)b * C + c]) : 0.0f;
    be[k] = ok ? Io<Tin>::to_f(beta[(int64_t)b * C + c]) : 0.0f;
    s_gxm[k] = s_gm[k] = s_gw[k] = s_gwx[k] = 0.0f;
  }

  const int hw = h * w;
  for (int p = blockIdx.x * kWarps + warp; p < hw; p += gridDim.x * kWarps) {
    const int iy = p / w;
    const int ix = p - iy * w;
    const int64_t src = ((int64_t)b * hw + p) * C;
    float xh[CPL], gws[CPL];
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
      const int c = lane + 32 * k;
      xh[k] = c < C ? __fmul_rn(__fsub_rn(Io<Tin>::to_f(x[src + c]), mu[k]),
                                r[k])
                    : 0.0f;
      gws[k] = 0.0f;
    }
    for (int q = 0; q < nsub; ++q) {
      const int oy = up ? 2 * iy + (q >> 1) : iy;
      const int ox = up ? 2 * ix + (q & 1) : ix;
      const int64_t op = ((int64_t)b * H + oy) * W + ox;
      const float m = Io<Tin>::to_f(mask[op]);
      float dm = 0.0f;
#pragma unroll
      for (int k = 0; k < CPL; ++k) {
        const int c = lane + 32 * k;
        if (c < C) {
          const float wgt = __fadd_rn(__fmul_rn(ga[k], m), 1.0f);
          const float z =
              __fadd_rn(__fmul_rn(wgt, xh[k]), __fmul_rn(be[k], m));
          const float g = z > 0.0f ? Io<Tout>::to_f(dy[op * C + c]) : 0.0f;
          const float gw = g * wgt;
          gws[k] += gw;
          dm += g * (ga[k] * xh[k] + be[k]);
          s_gxm[k] += g * xh[k] * m;
          s_gm[k] += g * m;
          s_gw[k] += gw;
          s_gwx[k] += gw * xh[k];
        }
      }
      dm = warp_sum(dm);
      if (lane == 0) dmask[op] = Io<Tin>::from_f(dm);
    }
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
      const int c = lane + 32 * k;
      if (c < C) dx[src + c] = Io<Tin>::from_f(gws[k] * r[k]);
    }
  }

  // Block sum of the per-lane sums, warp by warp in a fixed order.
  for (int wv = 0; wv < kWarps; ++wv) {
    if (warp == wv) {
#pragma unroll
      for (int k = 0; k < CPL; ++k) {
        const int j = lane + 32 * k;
        const float v[4] = {s_gxm[k], s_gm[k], s_gw[k], s_gwx[k]};
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          float* dst = red + a * CPL * 32 + j;
          *dst = wv == 0 ? v[a] : *dst + v[a];
        }
      }
    }
    __syncthreads();
  }
  float* out = partial + ((int64_t)b * gridDim.x + blockIdx.x) * 4 * C;
  for (int i = threadIdx.x; i < 4 * C; i += kThreads) {
    const int a = i / C;
    const int c = i - a * C;
    out[i] = red[a * CPL * 32 + c];
  }
}

template <typename Tin>
__global__ void affine_bwd_finalize(const float* __restrict__ partial,
                                    const float* __restrict__ var, int B,
                                    int nblk, int C, float eps,
                                    Tin* __restrict__ dgamma,
                                    Tin* __restrict__ dbeta,
                                    float* __restrict__ dmean,
                                    float* __restrict__ dvar) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < B * C) {
    const int b = i / C;
    const int c = i - b * C;
    float sg = 0.0f, sb = 0.0f;
    for (int k = 0; k < nblk; ++k) {
      const float* p = partial + ((int64_t)b * nblk + k) * 4 * C;
      sg += p[c];
      sb += p[C + c];
    }
    dgamma[i] = Io<Tin>::from_f(sg);
    dbeta[i] = Io<Tin>::from_f(sb);
  } else if (i < B * C + C) {
    const int c = i - B * C;
    float sw = 0.0f, swx = 0.0f;
    for (int k = 0; k < B * nblk; ++k) {
      const float* p = partial + (int64_t)k * 4 * C;
      sw += p[2 * C + c];
      swx += p[3 * C + c];
    }
    const float r = rsqrtf(var[c] + eps);
    dmean[c] = -r * sw;
    dvar[c] = -0.5f * r * r * swx;
  }
}

template <typename Tin, typename Tout, int CPL>
cudaError_t launch(const void* x, const float* mean, const float* var,
                   const void* gamma, const void* beta, const void* mask,
                   const void* dy, void* dx, void* dmask, void* dgamma,
                   void* dbeta, float* dmean, float* dvar, float* partial,
                   int B, int h, int w, int C, int up, float eps, int nblk,
                   cudaStream_t stream) {
  affine_bwd_main<Tin, Tout, CPL><<<dim3(nblk, B), kThreads, 0, stream>>>(
      static_cast<const Tin*>(x), mean, var, static_cast<const Tin*>(gamma),
      static_cast<const Tin*>(beta), static_cast<const Tin*>(mask),
      static_cast<const Tout*>(dy), static_cast<Tin*>(dx),
      static_cast<Tin*>(dmask), partial, h, w, C, up, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n = B * C + C;
  affine_bwd_finalize<Tin><<<(n + 255) / 256, 256, 0, stream>>>(
      partial, var, B, nblk, C, eps, static_cast<Tin*>(dgamma),
      static_cast<Tin*>(dbeta), dmean, dvar);
  return cudaGetLastError();
}

template <typename Tin, typename Tout>
cudaError_t launch_cpl(int C, const void* x, const float* mean,
                       const float* var, const void* gamma, const void* beta,
                       const void* mask, const void* dy, void* dx, void* dmask,
                       void* dgamma, void* dbeta, float* dmean, float* dvar,
                       float* partial, int B, int h, int w, int up, float eps,
                       int nblk, cudaStream_t s) {
#define EEGAN_AFFINE_BWD_CASE(N)                                              \
  if (C <= 32 * N)                                                            \
    return launch<Tin, Tout, N>(x, mean, var, gamma, beta, mask, dy, dx,      \
                                dmask, dgamma, dbeta, dmean, dvar, partial, B, \
                                h, w, C, up, eps, nblk, s);
  EEGAN_AFFINE_BWD_CASE(1)
  EEGAN_AFFINE_BWD_CASE(2)
  EEGAN_AFFINE_BWD_CASE(4)
  EEGAN_AFFINE_BWD_CASE(8)
  EEGAN_AFFINE_BWD_CASE(16)
#undef EEGAN_AFFINE_BWD_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. in_dtype is that of x, gamma,
// beta, mask (and of dx, dmask, dgamma, dbeta); out_dtype that of dy.
// Shapes (all contiguous, NHWC): x, dx (B,h,w,C); mask, dmask (B,H,W);
// dy (B,H,W,C); gamma, beta, dgamma, dbeta (B,C); mean, var, dmean, dvar
// (C,) float32; partial: float32 scratch of B*nblk*4*C. H,W = 2h,2w when up
// else h,w. C <= 512. The grid is (nblk, B).
extern "C" int eegan_affine_mask_relu_bwd(
    const void* x, const void* mean, const void* var, const void* gamma,
    const void* beta, const void* mask, const void* dy, void* dx, void* dmask,
    void* dgamma, void* dbeta, void* dmean, void* dvar, void* partial, int B,
    int h, int w, int C, int up, float eps, int in_dtype, int out_dtype,
    int nblk, void* stream) {
  const float* mn = static_cast<const float*>(mean);
  const float* vr = static_cast<const float*>(var);
  float* dm = static_cast<float*>(dmean);
  float* dv = static_cast<float*>(dvar);
  float* part = static_cast<float*>(partial);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == 0 && out_dtype == 0)
    return launch_cpl<float, float>(C, x, mn, vr, gamma, beta, mask, dy, dx,
                                    dmask, dgamma, dbeta, dm, dv, part, B, h, w,
                                    up, eps, nblk, s);
  if (in_dtype == 0 && out_dtype == 1)
    return launch_cpl<float, __nv_bfloat16>(C, x, mn, vr, gamma, beta, mask,
                                            dy, dx, dmask, dgamma, dbeta, dm,
                                            dv, part, B, h, w, up, eps, nblk,
                                            s);
  if (in_dtype == 1 && out_dtype == 0)
    return launch_cpl<__nv_bfloat16, float>(C, x, mn, vr, gamma, beta, mask,
                                            dy, dx, dmask, dgamma, dbeta, dm,
                                            dv, part, B, h, w, up, eps, nblk,
                                            s);
  if (in_dtype == 1 && out_dtype == 1)
    return launch_cpl<__nv_bfloat16, __nv_bfloat16>(
        C, x, mn, vr, gamma, beta, mask, dy, dx, dmask, dgamma, dbeta, dm, dv,
        part, B, h, w, up, eps, nblk, s);
  return cudaErrorInvalidValue;
}
