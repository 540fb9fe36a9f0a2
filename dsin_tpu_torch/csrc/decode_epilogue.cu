// K4: the decoder's fused epilogue + search colour transform, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel `fused_decode_epilogue` of the JAX package
// (dsin_tpu/ops/epilogue_pallas.py:152, pallas_call at :167). Bound in
// ops/epilogue.py (`fused_decode_epilogue`, built by native_build with nvcc,
// loaded with ctypes); its plain torch version is `epilogue_reference` there.
//
// Computes, for x (N, H2, W2, Cin) NHWC, float32 or bfloat16, and the host
// fold of ops/epilogue.py `fold_epilogue_params`:
//   conv = the reference's stride-2 5x5 "SAME" transposed conv to RGB, as its
//          four polyphase classes: output pixel (2i+a, 2j+b) sums the kernel
//          taps of parity class (a, b) only,
//            a = 0: kh in {1, 3} reading input rows {i-1, i}
//            a = 1: kh in {0, 2, 4} reading input rows {i-1, i, i+1}
//          (the same table for columns; _PHASE_TAPS of the Pallas kernel);
//   img  = clip(conv * img_scale + img_bias, 0, 255)   (BN x denorm affine)
//   srch = img @ st_mat + st_bias                       (search normalization
//                                                        + H1H2H3)
// and writes both (N, 2*H2, 2*W2, 3) float32 NHWC images; the decoded image
// never makes a round trip through device memory before the search map.
//
// Bound, at the main path's shape (2, 160, 612, 64) -> 2 x (2, 320, 1224, 3):
// each output pixel sums 6.25 taps on average (4, 6, 6 and 9 over the four
// classes) x 64 Cin x 3 Cout = 1,200 multiply-adds, so 2 x 2 x 391,680 px x
// 1,200 = 1.88 GFLOP, 0.028 ms at the 67 TFLOP/s fp32 rate outside the tensor
// cores; bytes 2 x (25.07 MB in + 9.40 MB for the two outputs) = 68.9 MB,
// 0.021 ms at 3.35 TB/s. Bound by operations in float32 (on the CUDA cores).
// With bfloat16 operands the input halves and the float32 FMAs stay.
//
// Design (the simple kernel that is right; tensor cores, TMA and a
// persistent schedule are later work):
//   * one thread per input position (i, j), owning its 2x2 output pixels:
//     12 float32 accumulators;
//   * a block of 32 x 8 positions stages its input rows with a one-pixel
//     halo, all Cin, widened to float32, in shared memory as Cin planes (an
//     odd plane stride spreads the staging stores over the banks; the reads
//     of a warp are 32 consecutive floats); positions outside the image stage
//     as zeros, so the ragged edges are masked here, not padded on the host;
//   * the (25*Cin, 3) weight matrix sits in shared memory as float4 rows
//     (w0, w1, w2, 0): one broadcast load feeds three FMAs;
//   * every accumulator sums its taps in _PHASE_TAPS order (input row offset
//     ascending, then column offset), Cin ascending, with fmaf: a fixed order
//     with no atomics, so the kernel is deterministic and a pixel's value
//     does not depend on the batch or the tile it falls in;
//   * bfloat16 operands are widened to float32 as they are loaded (the
//     Pallas kernel's preferred_element_type): products of bfloat16 values
//     are exact in float32; the affine, clip and search tail is float32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int K = 5;
constexpr int TILE_W = 32;                     // input columns per block
constexpr int TILE_H = 8;                      // input rows per block
constexpr int THREADS = TILE_W * TILE_H;
constexpr int HALO_W = TILE_W + 2;
constexpr int HALO_H = TILE_H + 2;
constexpr int PLANE = HALO_H * HALO_W + 1;     // odd stride per channel
constexpr int MAX_CIN = 128;                   // shared memory: 225,792 B

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Kernel index of the tap that output parity p reads at input offset o
// (-1, 0 or 1), or -1 when class p has no tap there.
__host__ __device__ constexpr int tap_index(int p, int o) {
  return p == 0 ? (o == -1 ? 1 : (o == 0 ? 3 : -1)) : 2 * (o + 1);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
decode_epilogue_kernel(const T* __restrict__ x, const T* __restrict__ wmat,
                       const float* __restrict__ img_scale,
                       const float* __restrict__ img_bias,
                       const float* __restrict__ st_mat,
                       const float* __restrict__ st_bias,
                       float* __restrict__ img, float* __restrict__ srch,
                       int h2, int w2, int cin) {
  extern __shared__ float4 smem[];
  float4* w_s = smem;                                   // 25 * cin rows
  float* x_s = reinterpret_cast<float*>(smem + K * K * cin);   // cin planes
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * TILE_W + tx;
  const int n = blockIdx.z;
  const int i0 = blockIdx.y * TILE_H, j0 = blockIdx.x * TILE_W;

  for (int e = tid; e < K * K * cin; e += THREADS) {
    w_s[e] = make_float4(widen(wmat[3 * e]), widen(wmat[3 * e + 1]),
                         widen(wmat[3 * e + 2]), 0.0f);
  }
  const T* xn = x + static_cast<size_t>(n) * h2 * w2 * cin;
  const int staged = HALO_H * HALO_W * cin;
  for (int e = tid; e < staged; e += THREADS) {
    const int c = e % cin;
    const int pos = e / cin;
    const int gi = i0 - 1 + pos / HALO_W, gj = j0 - 1 + pos % HALO_W;
    float v = 0.0f;
    if (gi >= 0 && gi < h2 && gj >= 0 && gj < w2) {
      v = widen(xn[(static_cast<size_t>(gi) * w2 + gj) * cin + c]);
    }
    x_s[c * PLANE + pos] = v;
  }
  __syncthreads();

  const int i = i0 + ty, j = j0 + tx;
  if (i >= h2 || j >= w2) return;

  float acc[2][2][3];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 2; ++b)
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) acc[a][b][ch] = 0.0f;

#pragma unroll
  for (int di = -1; di <= 1; ++di) {
#pragma unroll
    for (int dj = -1; dj <= 1; ++dj) {
      const float* xp = x_s + (ty + 1 + di) * HALO_W + (tx + 1 + dj);
#pragma unroll 4
      for (int c = 0; c < cin; ++c) {
        const float xv = xp[c * PLANE];
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          const int kh = tap_index(a, di);
          if (kh < 0) continue;
#pragma unroll
          for (int b = 0; b < 2; ++b) {
            const int kw = tap_index(b, dj);
            if (kw < 0) continue;
            const float4 wv = w_s[(kh * K + kw) * cin + c];
            acc[a][b][0] = fmaf(xv, wv.x, acc[a][b][0]);
            acc[a][b][1] = fmaf(xv, wv.y, acc[a][b][1]);
            acc[a][b][2] = fmaf(xv, wv.z, acc[a][b][2]);
          }
        }
      }
    }
  }

  float s[3], t[3], sb[3], m[9];
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    s[ch] = __ldg(img_scale + ch);
    t[ch] = __ldg(img_bias + ch);
    sb[ch] = __ldg(st_bias + ch);
  }
#pragma unroll
  for (int k = 0; k < 9; ++k) m[k] = __ldg(st_mat + k);

  const int ho = 2 * h2, wo = 2 * w2;
#pragma unroll
  for (int a = 0; a < 2; ++a) {
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      float v[3];
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        // multiply, then add: the plain version's two roundings
        v[ch] = fminf(fmaxf(__fadd_rn(__fmul_rn(acc[a][b][ch], s[ch]), t[ch]),
                            0.0f), 255.0f);
      }
      const size_t o =
          ((static_cast<size_t>(n) * ho + 2 * i + a) * wo + 2 * j + b) * 3;
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        img[o + ch] = v[ch];
        srch[o + ch] = fmaf(v[2], m[6 + ch],
                            fmaf(v[1], m[3 + ch], v[0] * m[ch])) + sb[ch];
      }
    }
  }
}

template <typename T>
int launch(const void* x, const void* wmat, const float* img_scale,
           const float* img_bias, const float* st_mat, const float* st_bias,
           float* img, float* srch, int n, int h2, int w2, int cin,
           cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(K) * K * cin * sizeof(float4) +
                      static_cast<size_t>(cin) * PLANE * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      decode_epilogue_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 block(TILE_W, TILE_H);
  const dim3 grid((w2 + TILE_W - 1) / TILE_W, (h2 + TILE_H - 1) / TILE_H, n);
  decode_epilogue_kernel<T><<<grid, block, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wmat), img_scale,
      img_bias, st_mat, st_bias, img, srch, h2, w2, cin);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launch K4 on `stream`; returns the cudaError_t of the launch (0 = queued).
// x and wmat are float32 (is_bf16 = 0) or bfloat16 (is_bf16 = 1); every
// other operand is float32. Does not synchronise and allocates nothing.
int decode_epilogue(const void* x, const void* wmat, const float* img_scale,
                    const float* img_bias, const float* st_mat,
                    const float* st_bias, float* img, float* srch, int n,
                    int h2, int w2, int cin, int is_bf16,
                    cudaStream_t stream) {
  if (n < 1 || n > 65535 || h2 < 1 || w2 < 1 || cin < 1 || cin > MAX_CIN) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (is_bf16) {
    return launch<__nv_bfloat16>(x, wmat, img_scale, img_bias, st_mat,
                                 st_bias, img, srch, n, h2, w2, cin, stream);
  }
  return launch<float>(x, wmat, img_scale, img_bias, st_mat, st_bias, img,
                       srch, n, h2, w2, cin, stream);
}

const char* decode_epilogue_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
