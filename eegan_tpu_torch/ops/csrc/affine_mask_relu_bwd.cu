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
// dx, dmask and the four small gradients once, a few flops per element: the
// least time is those bytes over the memory rate (3.35 TB/s on an H100 SXM).
//
// Design: two launches on one stream, affine_bwd with grid (nblk, B) and 256
// threads, then affine_bwd_finalize.
//
// * Wide accesses. A thread takes V channels at a time (8 bf16 or 4 float32,
//   one 16-byte access; dy in float32 under bf16 x takes two), VPL vectors
//   per pixel. A group of LANES lanes (a power of 2, at most 32) covers one
//   low-res pixel's C channels, so a warp covers 32 / LANES pixels at once:
//   at C = 32 in bf16, 4 lanes per pixel and 8 pixels per warp. A C that is
//   not a multiple of the vector (37) takes V = 1 of the same kernel.
// * Loads in flight. A group takes U low-res pixels per step (U = 1 with the
//   upsample, whose pixel has four output pixels; else 4 when a lane holds at
//   most 8 channels and 2 when it holds more) and issues every x, mask and dy
//   load of the step before any gate is evaluated; dy is loaded
//   unconditionally.
// * dmask, a sum over channels, is a shuffle reduction over the LANES lanes
//   of a group; the group's first lane stores it, so a warp's stores are
//   neighbouring pixels.
// * Cross-block sums without float atomics. Each lane keeps its channels'
//   four running sums (g*xhat*m, g*m, g*wgt, g*wgt*xhat) over its pixels;
//   a block adds its groups' sums (shuffles, then warps in order in shared
//   memory) and writes them to a float32 scratch, partial[b][block][4][C].
//   affine_bwd_finalize, one block of 32 warps per 32 channels, then sums
//   sample b's partials in block order into dgamma/dbeta (warp w takes the
//   samples w, w + 32, ...), each warp adds its samples' sums of g*wgt and
//   g*wgt*xhat in sample order, and the first warp adds the warps' in warp
//   order into dmean/dvar. Every sum has a fixed order: the result is deterministic, and
//   no state outlives a call.
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
// after the launches (0 = launched), or cudaErrorInvalidValue for a launch
// plan (ops/affine.py:backward_launch_plan) that does not cover C.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "affine_io.cuh"

namespace {

using eegan_affine::Io;
using eegan_affine::store_vec;
using eegan_affine::Vec;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

// Low-res pixels a group takes per step: more bytes in flight where the
// registers allow.
__device__ constexpr int unroll_for(bool up, int ch) {
  return up ? 1 : (ch <= 8 ? 4 : 2);
}

__device__ __forceinline__ unsigned group_mask(int width) {
  const int lane = threadIdx.x & 31;
  return width == 32 ? 0xffffffffu
                     : ((1u << width) - 1u) << (lane & ~(width - 1));
}

// Tin: x, gamma, beta, mask, dx, dmask, dgamma, dbeta. Tout: dy (the
// forward's output). V channels per vector, VPL vectors per lane and pixel,
// UP: the nearest-2x upsample.
template <typename Tin, typename Tout, int V, int VPL, bool UP>
__global__ void __launch_bounds__(kThreads, V* VPL <= 8 ? 2 : 1) affine_bwd(
    const Tin* __restrict__ x, const float* __restrict__ mean,
    const float* __restrict__ var, const Tin* __restrict__ gamma,
    const Tin* __restrict__ beta, const Tin* __restrict__ mask,
    const Tout* __restrict__ dy, Tin* __restrict__ dx,
    Tin* __restrict__ dmask, float* __restrict__ partial, int h, int w,
    int C, int lanes, float eps) {
  constexpr int CH = V * VPL;  // channels of a lane
  constexpr int NSUB = UP ? 4 : 1;
  constexpr int U = unroll_for(UP, CH);
  __shared__ float red[4 * 512];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b = blockIdx.y;
  const int nblk = gridDim.x;
  const int j = lane & (lanes - 1);  // this lane's place in its group
  const int grp = tid / lanes;
  const int groups = kThreads / lanes;
  const int nvec = C / V;
  const int H = UP ? 2 * h : h;
  const int W = UP ? 2 * w : w;
  const int hw = h * w;
  const unsigned gm = group_mask(lanes);

  // This lane's channels: c = V (j + lanes k) + e.
  float r[CH], mu[CH], ga[CH], be[CH];
  float s_gxm[CH], s_gm[CH], s_gw[CH], s_gwx[CH];
  bool okv[VPL];
#pragma unroll
  for (int k = 0; k < VPL; ++k) {
    okv[k] = j + lanes * k < nvec;
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const int c = V * (j + lanes * k) + e;
      const int i = k * V + e;
      r[i] = okv[k] ? rsqrtf(var[c] + eps) : 0.0f;
      mu[i] = okv[k] ? mean[c] : 0.0f;
      ga[i] = okv[k] ? Io<Tin>::to_f(gamma[(int64_t)b * C + c]) : 0.0f;
      be[i] = okv[k] ? Io<Tin>::to_f(beta[(int64_t)b * C + c]) : 0.0f;
      s_gxm[i] = s_gm[i] = s_gw[i] = s_gwx[i] = 0.0f;
    }
  }

  // Output pixel q of low-res pixel (iy, ix): the pixel itself, or one of
  // its four with the upsample.
  auto out_pixel = [&](int iy, int ix, int q) -> int64_t {
    return ((int64_t)b * H + (UP ? 2 * iy + (q >> 1) : iy)) * W +
           (UP ? 2 * ix + (q & 1) : ix);
  };
  const int step = nblk * groups * U;
  for (int p0 = blockIdx.x * groups * U + grp; p0 < hw; p0 += step) {
    // Every load of the step first, kept packed until its gate.
    Vec<Tin, V> xr[U][VPL];
    Vec<Tout, V> dr[U][NSUB][VPL];
    Tin mr[U][NSUB];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int p = p0 + u * groups;
      const bool pv = p < hw;
      const int iy = p / w;
      const int ix = p - iy * w;
#pragma unroll
      for (int k = 0; k < VPL; ++k) {
        const int64_t src = ((int64_t)b * hw + p) * C + V * (j + lanes * k);
        xr[u][k].load_if(pv && okv[k], x + src, x);
      }
#pragma unroll
      for (int q = 0; q < NSUB; ++q) {
        const int64_t op = out_pixel(iy, ix, q);
        mr[u][q] = pv ? mask[op] : Io<Tin>::from_f(0.0f);
#pragma unroll
        for (int k = 0; k < VPL; ++k)
          dr[u][q][k].load_if(pv && okv[k],
                              dy + op * C + V * (j + lanes * k), dy);
      }
    }
    // Then the gates and sums.
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int p = p0 + u * groups;
      const bool pv = p < hw;
      const int iy = p / w;
      const int ix = p - iy * w;
      float xh[CH], gab[CH], gws[CH], gms[CH];
#pragma unroll
      for (int i = 0; i < CH; ++i) {
        xh[i] = __fmul_rn(__fsub_rn(xr[u][i / V].get(i % V), mu[i]), r[i]);
        gab[i] = ga[i] * xh[i] + be[i];
        gws[i] = gms[i] = 0.0f;
      }
#pragma unroll
      for (int q = 0; q < NSUB; ++q) {
        const float m = Io<Tin>::to_f(mr[u][q]);
        float dm = 0.0f;
#pragma unroll
        for (int i = 0; i < CH; ++i) {
          const float wgt = __fadd_rn(__fmul_rn(ga[i], m), 1.0f);
          const float z = __fadd_rn(__fmul_rn(wgt, xh[i]), __fmul_rn(be[i], m));
          const float g = z > 0.0f ? dr[u][q][i / V].get(i % V) : 0.0f;
          gws[i] += g * wgt;
          gms[i] += g * m;
          dm += g * gab[i];
        }
        for (int o = lanes >> 1; o > 0; o >>= 1)
          dm += __shfl_xor_sync(gm, dm, o);
        if (j == 0 && pv) dmask[out_pixel(iy, ix, q)] = Io<Tin>::from_f(dm);
      }
#pragma unroll
      for (int i = 0; i < CH; ++i) {
        s_gw[i] += gws[i];
        s_gwx[i] += gws[i] * xh[i];
        s_gm[i] += gms[i];
        s_gxm[i] += gms[i] * xh[i];
      }
      if (pv) {
#pragma unroll
        for (int k = 0; k < VPL; ++k) {
          if (okv[k]) {
            float o[V];
#pragma unroll
            for (int e = 0; e < V; ++e) o[e] = gws[k * V + e] * r[k * V + e];
            store_vec<Tin, V>(
                dx + ((int64_t)b * hw + p) * C + V * (j + lanes * k), o);
          }
        }
      }
    }
  }

  // Block sum: the groups of a warp by shuffles, then the warps in order.
#pragma unroll
  for (int i = 0; i < CH; ++i) {
    for (int o = lanes; o < 32; o <<= 1) {
      s_gxm[i] += __shfl_xor_sync(0xffffffffu, s_gxm[i], o);
      s_gm[i] += __shfl_xor_sync(0xffffffffu, s_gm[i], o);
      s_gw[i] += __shfl_xor_sync(0xffffffffu, s_gw[i], o);
      s_gwx[i] += __shfl_xor_sync(0xffffffffu, s_gwx[i], o);
    }
  }
  for (int wv = 0; wv < kWarps; ++wv) {
    if (warp == wv && lane < lanes) {
#pragma unroll
      for (int k = 0; k < VPL; ++k) {
        if (!okv[k]) continue;
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const int c = V * (j + lanes * k) + e;
          const int i = k * V + e;
          const float v[4] = {s_gxm[i], s_gm[i], s_gw[i], s_gwx[i]};
#pragma unroll
          for (int a = 0; a < 4; ++a)
            red[a * C + c] = wv == 0 ? v[a] : red[a * C + c] + v[a];
        }
      }
    }
    __syncthreads();
  }
  float* own = partial + ((int64_t)b * nblk + blockIdx.x) * 4 * C;
  for (int i = tid; i < 4 * C; i += kThreads) own[i] = red[i];
}

// The cross-block sums, after affine_bwd: grid ceil(C / 32), lane = channel.
// Warp w sums the partials of the samples b = w, w + kFinWarps, ... in block
// order (dgamma, dbeta of b) and adds their sums of g*wgt and g*wgt*xhat in
// sample order; warp 0 adds the warps' in warp order (dmean, dvar). With a
// warp per sample up to B = 32, the chains of dependent L2 reads stay short.
constexpr int kFinWarps = 32;

template <typename Tin>
__global__ void __launch_bounds__(kFinWarps * 32) affine_bwd_finalize(
    const float* __restrict__ partial, const float* __restrict__ var, int B,
    int nblk, int C, float eps, Tin* __restrict__ dgamma,
    Tin* __restrict__ dbeta, float* __restrict__ dmean,
    float* __restrict__ dvar) {
  __shared__ float red[2][kFinWarps][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + lane;
  const bool ok = c < C;
  float sw = 0.0f, swx = 0.0f;
  for (int b = warp; b < B; b += kFinWarps) {
    // An idle lane reads channel 0: its address stays in bounds.
    const float* p = partial + (int64_t)b * nblk * 4 * C + (ok ? c : 0);
    float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 8
    for (int k = 0; k < nblk; ++k)
#pragma unroll
      for (int a = 0; a < 4; ++a) s[a] += p[(int64_t)k * 4 * C + a * C];
    if (ok) {
      dgamma[(int64_t)b * C + c] = Io<Tin>::from_f(s[0]);
      dbeta[(int64_t)b * C + c] = Io<Tin>::from_f(s[1]);
    }
    sw += s[2];
    swx += s[3];
  }
  red[0][warp][lane] = sw;
  red[1][warp][lane] = swx;
  __syncthreads();
  if (warp == 0 && ok) {
    float a = 0.0f, v = 0.0f;
    for (int wv = 0; wv < kFinWarps; ++wv) {
      a += red[0][wv][lane];
      v += red[1][wv][lane];
    }
    const float rc = rsqrtf(var[c] + eps);
    dmean[c] = -rc * a;
    dvar[c] = -0.5f * rc * rc * v;
  }
}

struct Args {
  const void *x, *mean, *var, *gamma, *beta, *mask, *dy;
  void *dx, *dmask, *dgamma, *dbeta, *dmean, *dvar, *partial;
  int B, h, w, C, lanes, nblk;
  float eps;
  cudaStream_t stream;
};

template <typename Tin, typename Tout, int V, int VPL, bool UP>
cudaError_t launch(const Args& a) {
  affine_bwd<Tin, Tout, V, VPL, UP>
      <<<dim3(a.nblk, a.B), kThreads, 0, a.stream>>>(
          static_cast<const Tin*>(a.x), static_cast<const float*>(a.mean),
          static_cast<const float*>(a.var), static_cast<const Tin*>(a.gamma),
          static_cast<const Tin*>(a.beta), static_cast<const Tin*>(a.mask),
          static_cast<const Tout*>(a.dy), static_cast<Tin*>(a.dx),
          static_cast<Tin*>(a.dmask), static_cast<float*>(a.partial), a.h,
          a.w, a.C, a.lanes, a.eps);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  affine_bwd_finalize<Tin><<<(a.C + 31) / 32, kFinWarps * 32, 0, a.stream>>>(
      static_cast<const float*>(a.partial), static_cast<const float*>(a.var),
      a.B, a.nblk, a.C, a.eps, static_cast<Tin*>(a.dgamma),
      static_cast<Tin*>(a.dbeta), static_cast<float*>(a.dmean),
      static_cast<float*>(a.dvar));
  return cudaGetLastError();
}

template <typename Tin, typename Tout, int V, int VPL>
cudaError_t launch_up(const Args& a, int up) {
  return up ? launch<Tin, Tout, V, VPL, true>(a)
            : launch<Tin, Tout, V, VPL, false>(a);
}

// Vectors of V channels, VPL of them per lane (channels per lane <= 16).
template <typename Tin, typename Tout, int V>
cudaError_t launch_vpl(const Args& a, int vpl, int up) {
  switch (vpl) {
    case 1:
      return launch_up<Tin, Tout, V, 1>(a, up);
    case 2:
      return launch_up<Tin, Tout, V, 2>(a, up);
    case 4:
      if constexpr (V * 4 <= 16) return launch_up<Tin, Tout, V, 4>(a, up);
      break;
    case 8:
      if constexpr (V * 8 <= 16) return launch_up<Tin, Tout, V, 8>(a, up);
      break;
    case 16:
      if constexpr (V * 16 <= 16) return launch_up<Tin, Tout, V, 16>(a, up);
      break;
  }
  return cudaErrorInvalidValue;
}

template <typename Tin, typename Tout>
cudaError_t launch_vec(const Args& a, int vec, int vpl, int up) {
  constexpr int kVmax = 16 / (int)sizeof(Tin);
  if (vec == kVmax) return launch_vpl<Tin, Tout, kVmax>(a, vpl, up);
  if (vec == 1) return launch_vpl<Tin, Tout, 1>(a, vpl, up);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. in_dtype is that of x, gamma,
// beta, mask (and of dx, dmask, dgamma, dbeta); out_dtype that of dy.
// Shapes (all contiguous, NHWC): x, dx (B,h,w,C); mask, dmask (B,H,W);
// dy (B,H,W,C); gamma, beta, dgamma, dbeta (B,C); mean, var, dmean, dvar
// (C,) float32. H,W = 2h,2w when up else h,w. C <= 512. The launch plan
// (ops/affine.py:backward_launch_plan): vec channels per access (16 bytes of
// x, or 1), lanes per pixel (a power of 2 <= 32), vpl vectors per lane, nblk
// blocks per sample; partial: float32 scratch of B*nblk*4*C. The pixels a
// group takes per step are the kernel's own (unroll_for). x, dy and dx must
// be 16-byte aligned when vec > 1.
extern "C" int eegan_affine_mask_relu_bwd(
    const void* x, const void* mean, const void* var, const void* gamma,
    const void* beta, const void* mask, const void* dy, void* dx, void* dmask,
    void* dgamma, void* dbeta, void* dmean, void* dvar, void* partial, int B,
    int h, int w, int C, int up, float eps, int in_dtype, int out_dtype,
    int vec, int lanes, int vpl, int nblk, void* stream) {
  const int ch = vec * vpl;
  const bool lanes_ok = lanes >= 1 && lanes <= 32 && (lanes & (lanes - 1)) == 0;
  if (C <= 0 || C > 512 || vec <= 0 || C % vec != 0 || !lanes_ok ||
      lanes * ch < C || ch > 16 || nblk <= 0 || B <= 0 || B > 65535)
    return cudaErrorInvalidValue;
  const Args a{x,     mean,  var,    gamma, beta,  mask,  dy,
               dx,    dmask, dgamma, dbeta, dmean, dvar,  partial,
               B,     h,     w,      C,     lanes, nblk,  eps,
               static_cast<cudaStream_t>(stream)};
  if (in_dtype == 0 && out_dtype == 0)
    return launch_vec<float, float>(a, vec, vpl, up);
  if (in_dtype == 0 && out_dtype == 1)
    return launch_vec<float, __nv_bfloat16>(a, vec, vpl, up);
  if (in_dtype == 1 && out_dtype == 0)
    return launch_vec<__nv_bfloat16, float>(a, vec, vpl, up);
  if (in_dtype == 1 && out_dtype == 1)
    return launch_vec<__nv_bfloat16, __nv_bfloat16>(a, vec, vpl, up);
  return cudaErrorInvalidValue;
}
