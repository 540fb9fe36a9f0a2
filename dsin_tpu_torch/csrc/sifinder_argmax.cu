// Fused masked-Pearson patch search with arg-max, for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernels
//   * fused_pearson_argmax         (dsin_tpu/ops/sifinder_pallas.py:113-179,
//                                   pallas_call :146, body _kernel :61-110)
//   * fused_pearson_argmax_shared  (dsin_tpu/ops/sifinder_pallas.py:306-374,
//                                   pallas_call :340)
// as ONE kernel: the side operands (y, inv_denom) take a batch stride, the
// image's own stride for the per-image search and 0 for a batch of requests
// that share one cached side image.
//
// What it computes, for every image b and every x-hat patch p:
//   score[p, n] = ((num[p, n] * inv_denom[n]) * gh[row, p]) * gw_t[p, col]
//   num[p, n]   = sum_k pk[p, k] * y[ch, row + dr, col + dc]
// over every map position n = row * Wc + col (Hc = H - ph + 1 rows,
// Wc = W - pw + 1 columns), k in (dc, ch, dr) order, and returns the best
// (value, n) per patch. Ties go to the lowest flat index, as jnp.argmax /
// torch.argmax take the first maximum. The (P, Hc, Wc) score map never
// exists in memory: 1.18 GB per image at 320x1224 with 20x24 patches.
//
// Bound on an H100 SXM at 320x1224, 20x24 patches (P = 816, K = 1440,
// Hc x Wc = 301 x 1201): 2 * P * K * Hc * Wc = 0.85 TFLOP per image of fp32
// FMA, 12.7 ms per image at the 67 TFLOP/s fp32 rate outside the tensor cores
// (700 W). Operands are about 16 MB per image (0.005 ms at 3.35 TB/s), so the
// search is bound by operations.
//
// Design. The Pallas kernel carries its running arg-max from grid step to
// grid step; CUDA blocks run in no order, so here:
//   * stage 1: a grid over (patch tile of 64, position group, image). Each
//     block walks its group's tiles of 128 consecutive flat positions; for
//     each tile it accumulates the 64 x 128 dot products in fp32 FMA, with K
//     staged through shared memory 8 deep in two alternating stages (the
//     next stage's loads are in flight while this one's FMAs run) and the
//     im2col operand gathered from y by pointer arithmetic through a
//     per-block table of tap offsets. The epilogue multiplies in the Pallas
//     order, sends positions past the map to -inf, and folds into a
//     per-thread running (value, index) with the lowest-index rule; one
//     warp-shuffle reduction per block ends it.
//   * stage 2: per (image, patch), a reduction over the position groups by
//     (value desc, index asc).
// No atomics: the result does not depend on the order blocks run in.
// Register tile 8 x 8 per thread, 128 threads, 3 blocks per SM (at 4 the
// 128-register cap spills); fp32 operands only. The tensor-core
// (wgmma/TMA) version and the bf16 rung are later work.

#include <cuda_runtime.h>
#include <climits>
#include <cmath>

namespace {

constexpr int TX = 16;                 // threads along positions
constexpr int TY = 8;                  // threads along patches
constexpr int BM = 8 * TY;             // patches per block tile (64)
constexpr int BN = 8 * TX;             // flat map positions per tile (128)
constexpr int BK = 8;                  // depth of one shared-memory stage
constexpr int THREADS = TX * TY;       // 128; each thread owns 8 x 8 scores
constexpr int MIN_BLOCKS = 3;          // per SM: <= 168 registers, no spill
constexpr int AS_STRIDE = BM + 4;      // padded row: conflict-free stores
constexpr int A_PER_THREAD = BM * BK / THREADS;
constexpr int MAX_K = 8192;            // tap-offset table in dynamic smem
static_assert(BN == THREADS, "each thread gathers one im2col column");

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

// Thread (ty, tx) owns patches ty*4 + {0..3} and BM/2 + ty*4 + {0..3} and
// positions tx*4 + {0..3} and BN/2 + tx*4 + {0..3} of the block tile, so
// that its float4 reads of shared memory are conflict-free.
__device__ __forceinline__ int patch_of(int ty, int i) {
  return (i < 4) ? ty * 4 + i : BM / 2 + ty * 4 + (i - 4);
}
__device__ __forceinline__ int position_of(int tx, int j) {
  return (j < 4) ? tx * 4 + j : BN / 2 + tx * 4 + (j - 4);
}

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
pearson_argmax_stage1(const float* __restrict__ y, long long y_bstride,
                      const float* __restrict__ pk,
                      const float* __restrict__ dnm, long long d_bstride,
                      const float* __restrict__ gh,
                      const float* __restrict__ gw_t,
                      float* __restrict__ part_val, int* __restrict__ part_idx,
                      int C, int H, int W, int ph, int pw, int P,
                      int tiles_per_group, int groups) {
  extern __shared__ int koff[];                       // K tap offsets
  __shared__ __align__(16) float As[2][BK][AS_STRIDE];  // patch tile, k-major
  __shared__ __align__(16) float Bs[2][BK][BN];         // im2col tile
  float ra[A_PER_THREAD], rb[BK];                       // the next stage

  const int K = C * ph * pw;
  const int hc = H - ph + 1, wc = W - pw + 1;
  const int n_pos = hc * wc;
  const int n_tiles = (n_pos + BN - 1) / BN;
  const int p0 = blockIdx.x * BM;
  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;

  y += b * y_bstride;
  pk += static_cast<long long>(b) * P * K;
  dnm += b * d_bstride;

  // tap k = (dc, ch, dr) -> offset inside the window at (row, col)
  const int cph = C * ph;
  for (int k = tid; k < K; k += THREADS) {
    const int dc = k / cph, rem = k - dc * cph;
    const int ch = rem / ph, dr = rem - ch * ph;
    koff[k] = ch * H * W + dr * W + dc;
  }

  float best_v[8];
  int best_i[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    best_v[i] = -INFINITY;
    best_i[i] = INT_MAX;
  }
  __syncthreads();

  const int tile_end = min((g + 1) * tiles_per_group, n_tiles);
  for (int t = g * tiles_per_group; t < tile_end; ++t) {
    const int n0 = t * BN;
    // this thread gathers column `tid` of every im2col stage
    const int my_n = n0 + tid;
    int my_base = 0;
    if (my_n < n_pos) {
      const int r = my_n / wc;
      my_base = r * W + (my_n - r * wc);
    }

    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

    // two shared-memory stages: the next stage's global loads are in flight
    // (in registers) while this stage's FMAs run
    auto load = [&](int k0) {
#pragma unroll
      for (int u = 0; u < A_PER_THREAD; ++u) {
        const int e = tid + u * THREADS;
        const int kk = e % BK, pp = e / BK;
        const int p = p0 + pp, k = k0 + kk;
        ra[u] = (p < P && k < K) ? pk[static_cast<long long>(p) * K + k] : 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        const int k = k0 + kk;
        rb[kk] = (k < K) ? y[my_base + koff[k]] : 0.f;
      }
    };
    auto store = [&](int s) {
#pragma unroll
      for (int u = 0; u < A_PER_THREAD; ++u) {
        const int e = tid + u * THREADS;
        As[s][e % BK][e / BK] = ra[u];
      }
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) Bs[s][kk][tid] = rb[kk];
    };

    load(0);
    store(0);
    __syncthreads();
    int s = 0;
    for (int k0 = 0; k0 < K; k0 += BK) {
      const bool more = k0 + BK < K;
      if (more) load(k0 + BK);
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        const float4 a0 = *reinterpret_cast<const float4*>(&As[s][kk][ty * 4]);
        const float4 a1 =
            *reinterpret_cast<const float4*>(&As[s][kk][BM / 2 + ty * 4]);
        const float4 b0 = *reinterpret_cast<const float4*>(&Bs[s][kk][tx * 4]);
        const float4 b1 =
            *reinterpret_cast<const float4*>(&Bs[s][kk][BN / 2 + tx * 4]);
        const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float bb[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
      }
      if (more) store(s ^ 1);
      __syncthreads();
      s ^= 1;
    }

    // epilogue: Pallas multiply order, ragged edge to -inf, running best
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + position_of(tx, j);
      const bool ok = n < n_pos;
      const int r = ok ? n / wc : 0;
      const int c = ok ? n - r * wc : 0;
      const float d = ok ? dnm[n] : 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int p = p0 + patch_of(ty, i);
        if (p >= P) continue;
        float s = acc[i][j] * d;
        s = s * gh[static_cast<long long>(r) * P + p];
        s = s * gw_t[static_cast<long long>(p) * wc + c];
        if (!ok) s = -INFINITY;
        if (better(s, n, best_v[i], best_i[i])) {
          best_v[i] = s;
          best_i[i] = n;
        }
      }
    }
  }

  // the TX lanes that share a patch row are one (half-)warp: butterfly
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int off = TX / 2; off >= 1; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, best_v[i], off);
      const int oi = __shfl_xor_sync(0xffffffffu, best_i[i], off);
      if (better(ov, oi, best_v[i], best_i[i])) {
        best_v[i] = ov;
        best_i[i] = oi;
      }
    }
  }
  if (tx == 0) {
    const long long row = (static_cast<long long>(b) * groups + g) * P;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int p = p0 + patch_of(ty, i);
      if (p < P) {
        part_val[row + p] = best_v[i];
        part_idx[row + p] = best_i[i];
      }
    }
  }
}

__global__ void pearson_argmax_stage2(const float* __restrict__ part_val,
                                      const int* __restrict__ part_idx,
                                      float* __restrict__ best_val,
                                      int* __restrict__ best_idx, int B, int P,
                                      int groups) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= B * P) return;
  const int b = t / P, p = t - b * P;
  float bv = -INFINITY;
  int bi = INT_MAX;
  for (int g = 0; g < groups; ++g) {
    const long long o = (static_cast<long long>(b) * groups + g) * P + p;
    const float v = part_val[o];
    const int i = part_idx[o];
    if (better(v, i, bv, bi)) {
      bv = v;
      bi = i;
    }
  }
  best_val[t] = bv;
  best_idx[t] = (bi == INT_MAX) ? 0 : bi;   // no valid position: index 0
}

}  // namespace

extern "C" {

// Flat map positions per stage-1 tile; the wrapper sizes the position groups
// (and the partial buffers) from it.
int sifinder_argmax_position_tile() { return BN; }

const char* sifinder_argmax_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launches both stages on `stream`. y: (B or 1, C, H, W) with batch stride
// y_bstride; pk: (B, P, C*ph*pw); dnm: (B or 1, Hc, Wc) with batch stride
// d_bstride; gh: (Hc, P); gw_t: (P, Wc); part_val/part_idx: (B, groups, P)
// scratch; best_val/best_idx: (B, P). Returns the launch's cudaError_t.
int sifinder_pearson_argmax(const float* y, long long y_bstride,
                            const float* pk, const float* dnm,
                            long long d_bstride, const float* gh,
                            const float* gw_t, float* part_val, int* part_idx,
                            float* best_val, int* best_idx, int B, int C,
                            int H, int W, int ph, int pw, int P,
                            int tiles_per_group, int groups, void* stream) {
  const long long K = static_cast<long long>(C) * ph * pw;
  const long long hc = H - ph + 1, wc = W - pw + 1;
  if (B <= 0 || B > 65535 || C <= 0 || P <= 0 || hc <= 0 || wc <= 0 ||
      K > MAX_K || tiles_per_group <= 0 || groups <= 0 || groups > 65535 ||
      static_cast<long long>(groups) * tiles_per_group * BN < hc * wc ||
      static_cast<long long>(C) * H * W >= INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid1((P + BM - 1) / BM, groups, B);
  pearson_argmax_stage1<<<grid1, THREADS, K * sizeof(int), s>>>(
      y, y_bstride, pk, dnm, d_bstride, gh, gw_t, part_val, part_idx, C, H, W,
      ph, pw, P, tiles_per_group, groups);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = 256;
  pearson_argmax_stage2<<<(B * P + threads - 1) / threads, threads, 0, s>>>(
      part_val, part_idx, best_val, best_idx, B, P, groups);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
