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
// each input position feeds 25 taps x 64 Cin x 3 Cout = 4,800 multiply-adds
// (1,200 per output pixel), so 195,840 positions x 4,800 = 0.94 G FMAs = 1.88
// GFLOP, 0.028 ms at the 67 TFLOP/s fp32 rate outside the tensor cores;
// bytes 25.07 MB in (12.5 MB in bfloat16) + 18.8 MB for the two outputs,
// 0.021 ms (0.013 ms) at 3.35 TB/s. Bound by operations in float32; with
// bfloat16 operands the FMAs stay float32 on the CUDA cores, so they still
// take 0.028 ms against a 0.013 ms bytes bound (a tensor-core path is later
// work).
//
// Design. The first version (one thread per position, the whole Cin tile
// staged with scalar loads before any FMA) issued one shared-memory load per
// 2.2 FMAs and overlapped nothing; it ran at 12% of the bound. This one:
//   * register tiles: a warp's 32 lanes own 32 input rows, and each lane a
//     strip of RT = 6 positions along its row, 72 float32 accumulators
//     (6 positions x 2x2 outputs x RGB). For 4 channels and one input-row
//     offset a lane loads its (RT + 2)-wide window once, as float4 along C,
//     then every tap's 12 weights (3 broadcast float4) feed 72 FMAs: per 4
//     channels 24 window loads + 75 weight loads for 1,800 FMAs;
//   * bank-conflict-free windows: lanes read 32 different rows of the halo
//     tile, and a row's stride is an odd number of 16-byte (float32) or
//     8-byte (bfloat16) units, so the 8 (16) lanes of one shared-memory
//     wavefront land on distinct banks;
//   * pipelined staging: the halo tile (34 x 26 positions) is staged in
//     chunks of 8 channels, double-buffered, by cp.async (zero-filled where
//     the position lies outside the image: the halo and the ragged edges cost
//     no branches in the loop); chunk k+1 loads while chunk k computes, and
//     each thread's source and destination offsets are worked out once. The
//     chunk keeps the input's dtype; bfloat16 is widened as it is read, which
//     is exact. Where Cin is not a multiple of 8 or x is not aligned for
//     cp.async, the same pipeline stages with ordinary loads (zero channels
//     above Cin);
//   * the weights arrive with the first chunk (cp.async, 4 channels x RGB a
//     copy) and sit in shared memory as float32, grouped as [4-channel
//     group][tap][channel][RGB]; bfloat16 weights are widened once, in
//     shared memory, when they have landed;
//   * schedule: a block is 4 warps on a 32 x 24 tile, 246 registers a
//     thread, about 60 KB of shared memory, 2 blocks an SM; the main path's
//     (2, 160, 612) grid is 5 x 26 x 2 = 260 blocks, one wave on 132 SMs (2
//     tiles on 128 of them against an even share of 1.97). The last column
//     of tiles holds 612 - 25*24 = 12 positions: the warps with nothing in
//     the image skip the FMAs, and the ragged edge is masked at the stores;
//   * stores: the tail goes through shared memory, and the block writes
//     whole output rows with float4 (a lane's own strip would touch 32
//     output rows with every store);
//   * a fixed order: each accumulator sums, with fmaf, over 4-channel groups
//     ascending, within a group its taps in _PHASE_TAPS order (input row
//     offset, then column offset), within a tap the 4 channels ascending. No
//     atomics, no dependence on the tile: a pixel's value does not depend on
//     the batch or the tile it falls in;
//   * the tail is float32: the affine multiplies then adds (__fmul_rn /
//     __fadd_rn, the plain version's two roundings), clips, and maps to the
//     search space.
// Its times on the H100, and the variants tried on the way, are in PERF.md
// (section 6, K4): before the stores went through shared memory and the
// staging offsets were worked out once, each of the two took about a fifth
// of the time; the weight loads take about an eighth.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int K = 5;
constexpr int RT = 6;                          // positions per lane
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int TILE_H = 32;                     // input rows per block (lanes)
constexpr int TILE_W = RT * WARPS;             // input columns per block
constexpr int HALO_H = TILE_H + 2;
constexpr int HALO_W = TILE_W + 2;
constexpr int CH = 8;                          // channels per staged chunk
constexpr int GROUPS = CH / 4;                 // 4-channel groups a chunk
constexpr int ROW_E = HALO_W * CH + 4;         // elements per halo row: odd
                                               // in 16 B (f32) / 8 B (bf16)
constexpr int STAGE_E = HALO_H * ROW_E;        // elements per stage
constexpr int STAGES = 2;
constexpr int TAP_W = 12;                      // floats per tap and group
constexpr int OUT_ROW = TILE_W * 6 + 4;        // floats: odd in 16 B
constexpr int OUT_BYTES = 2 * 2 * TILE_H * OUT_ROW * 4;   // both images
constexpr int MAX_CIN = 128;

__host__ __device__ constexpr int tap_index(int p, int o) {
  // Kernel index of the tap that output parity p reads at input offset o
  // (-1, 0 or 1), or -1 when class p has no tap there.
  return p == 0 ? (o == -1 ? 1 : (o == 0 ? 3 : -1)) : 2 * (o + 1);
}

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T zero_of();
template <>
__device__ __forceinline__ float zero_of<float>() { return 0.0f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() {
  return __float2bfloat16(0.0f);
}

// Four consecutive channels from shared memory, as float32.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

__device__ __forceinline__ float lane_of(const float4& v, int c) {
  return c == 0 ? v.x : (c == 1 ? v.y : (c == 2 ? v.z : v.w));
}

// Copy `bytes` (8 or 16) from global to shared memory, or zeros when
// `valid` is false (src-size 0).
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
               "l"(src), "n"(BYTES), "r"(valid ? BYTES : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

constexpr int UNITS = HALO_H * HALO_W * GROUPS;   // 4-channel units a chunk
constexpr int UNITS_PER_THREAD = (UNITS + THREADS - 1) / THREADS;

// The async path's staging: a thread copies the same units of the halo tile
// for every chunk, so where each comes from (its element offset in the
// image at channel 0, -1 outside the image, zero-filled) and where it goes
// (its offset in a stage, -1 past the tile) are worked out once.
template <typename T>
struct Stager {
  int src[UNITS_PER_THREAD];
  int dst[UNITS_PER_THREAD];

  __device__ Stager(int i0, int j0, int h2, int w2, int cin, int tid) {
#pragma unroll
    for (int m = 0; m < UNITS_PER_THREAD; ++m) {
      const int e = tid + m * THREADS;
      const int u = e % GROUPS, s = e / GROUPS;
      const int hr = s / HALO_W, hc = s - hr * HALO_W;
      const int gi = i0 - 1 + hr, gj = j0 - 1 + hc;
      const bool in = gi >= 0 && gi < h2 && gj >= 0 && gj < w2;
      src[m] = e < UNITS && in ? (gi * w2 + gj) * cin + 4 * u : -1;
      dst[m] = e < UNITS ? hr * ROW_E + hc * CH + 4 * u : -1;
    }
  }

  // Channels [c0, c0 + CH) into `buf`.
  __device__ __forceinline__ void stage(T* buf, const T* __restrict__ xn,
                                        int c0) const {
#pragma unroll
    for (int m = 0; m < UNITS_PER_THREAD; ++m) {
      if (dst[m] < 0) continue;
      const bool in = src[m] >= 0;
      cp_async<static_cast<int>(4 * sizeof(T))>(
          buf + dst[m], in ? xn + src[m] + c0 : xn, in);
    }
  }
};

// The other path's staging (Cin not a multiple of CH, or x not aligned for
// cp.async): channels [c0, c0 + CH) of the halo tile whose top-left input
// position is (i0 - 1, j0 - 1) into `dst` by ordinary loads, zeros outside
// the image and above Cin.
template <typename T>
__device__ __forceinline__ void stage_chunk(T* dst, const T* __restrict__ xn,
                                            int i0, int j0, int h2, int w2,
                                            int cin, int c0, int tid) {
  for (int e = tid; e < UNITS; e += THREADS) {
    const int u = e % GROUPS, s = e / GROUPS;
    const int hr = s / HALO_W, hc = s - hr * HALO_W;
    const int gi = i0 - 1 + hr, gj = j0 - 1 + hc;
    const bool in = gi >= 0 && gi < h2 && gj >= 0 && gj < w2;
    const int c = c0 + 4 * u;
    T* d = dst + hr * ROW_E + hc * CH + 4 * u;
    const size_t at = (static_cast<size_t>(gi) * w2 + gj) * cin + c;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      d[q] = (in && c + q < cin) ? xn[at + q] : zero_of<T>();
    }
  }
}

template <typename T, bool kAsync>
__global__ void __launch_bounds__(THREADS, 2)
decode_epilogue_kernel(const T* __restrict__ x, const T* __restrict__ wmat,
                       const float* __restrict__ img_scale,
                       const float* __restrict__ img_bias,
                       const float* __restrict__ st_mat,
                       const float* __restrict__ st_bias,
                       float* __restrict__ img, float* __restrict__ srch,
                       int h2, int w2, int cin) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int chunks = (cin + CH - 1) / CH;
  float* w_s = reinterpret_cast<float*>(smem_raw);
  T* x_s = reinterpret_cast<T*>(w_s + chunks * GROUPS * K * K * TAP_W);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = blockIdx.z;
  const int i0 = blockIdx.y * TILE_H, j0 = blockIdx.x * TILE_W;
  const T* xn = x + static_cast<size_t>(n) * h2 * w2 * cin;

  // weights as [group of 4 channels][tap][channel of the group][RGB],
  // float32. The async path copies them 3 x 4 channels at a time with the
  // first chunk (bfloat16 into a raw area, widened once it has landed)
  const int wn = chunks * GROUPS * K * K * TAP_W;
  T* w_raw = sizeof(T) == sizeof(float)
                 ? reinterpret_cast<T*>(w_s)
                 : x_s + STAGES * STAGE_E;
  if (kAsync) {
    for (int e = tid; e < wn / 4; e += THREADS) {
      const int q = e % 3, gt = e / 3, t = gt % (K * K), g = gt / (K * K);
      cp_async<static_cast<int>(4 * sizeof(T))>(
          w_raw + gt * TAP_W + 4 * q,
          wmat + (static_cast<size_t>(t) * cin + 4 * g) * 3 + 4 * q, true);
    }
  } else {
    for (int e = tid; e < wn; e += THREADS) {
      const int ch = e % 3, cc = (e / 3) & 3, t = (e / TAP_W) % (K * K);
      const int c = 4 * (e / (TAP_W * K * K)) + cc;
      w_s[e] = c < cin
          ? widen(wmat[(static_cast<size_t>(t) * cin + c) * 3 + ch]) : 0.0f;
    }
  }
  const Stager<T> stager(i0, j0, h2, w2, cin, tid);
  auto stage = [&](int k) {
    T* buf = x_s + (k % STAGES) * STAGE_E;
    if constexpr (kAsync) {
      stager.stage(buf, xn, k * CH);
    } else {
      stage_chunk<T>(buf, xn, i0, j0, h2, w2, cin, k * CH, tid);
    }
  };
  for (int k = 0; k < STAGES - 1; ++k) {        // the first chunks in flight
    if (k < chunks) stage(k);
    if (kAsync) cp_async_commit();
  }

  float acc[RT][2][2][3];
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int b = 0; b < 2; ++b)
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) acc[r][a][b][ch] = 0.0f;

  const bool active = j0 + warp * RT < w2;     // any of the strip in image
  for (int k = 0; k < chunks; ++k) {
    const int next = k + STAGES - 1;           // into the buffer freed last
    if (next < chunks) stage(next);
    if (kAsync) {
      cp_async_commit();                       // possibly empty: keeps count
      cp_async_wait<STAGES - 1>();             // chunk k has landed
    }
    __syncthreads();
    if constexpr (kAsync && sizeof(T) != sizeof(float)) {
      if (k == 0) {
        for (int e = tid; e < wn; e += THREADS) w_s[e] = widen(w_raw[e]);
        __syncthreads();
      }
    }
    if (active) {
      const T* xs = x_s + (k % STAGES) * STAGE_E + warp * RT * CH;
#pragma unroll 1
      for (int g = 0; g < GROUPS; ++g) {
        const float* wg = w_s + (GROUPS * k + g) * K * K * TAP_W;
#pragma unroll
        for (int di = -1; di <= 1; ++di) {
          float4 xw[RT + 2];
          const T* xr = xs + (lane + 1 + di) * ROW_E + 4 * g;
#pragma unroll
          for (int q = 0; q < RT + 2; ++q) xw[q] = load4(xr + q * CH);
#pragma unroll
          for (int a = 0; a < 2; ++a) {
            const int kh = tap_index(a, di);
            if (kh < 0) continue;
#pragma unroll
            for (int dj = -1; dj <= 1; ++dj) {
#pragma unroll
              for (int b = 0; b < 2; ++b) {
                const int kw = tap_index(b, dj);
                if (kw < 0) continue;
                const float4* wp =
                    reinterpret_cast<const float4*>(wg + (kh * K + kw) * TAP_W);
                const float4 w0 = wp[0], w1 = wp[1], w2v = wp[2];
                const float wv[4][3] = {{w0.x, w0.y, w0.z},
                                        {w0.w, w1.x, w1.y},
                                        {w1.z, w1.w, w2v.x},
                                        {w2v.y, w2v.z, w2v.w}};
#pragma unroll
                for (int cc = 0; cc < 4; ++cc) {
#pragma unroll
                  for (int r = 0; r < RT; ++r) {
                    const float xv = lane_of(xw[r + 1 + dj], cc);
#pragma unroll
                    for (int ch = 0; ch < 3; ++ch) {
                      acc[r][a][b][ch] =
                          fmaf(xv, wv[cc][ch], acc[r][a][b][ch]);
                    }
                  }
                }
              }
            }
          }
        }
      }
    }
    __syncthreads();                           // buffer k % STAGES is free
  }

  // The tail, into shared memory (free since the loop's last barrier) as
  // [image][a][input row of the tile][the tile's 6 * TILE_W floats of
  // output row 2i + a], then out in whole rows: a lane's own strip would
  // touch 32 output rows with every store.
  float* out_s = reinterpret_cast<float*>(smem_raw);
  float s[3], t[3], sb[3], m[9];
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    s[ch] = __ldg(img_scale + ch);
    t[ch] = __ldg(img_bias + ch);
    sb[ch] = __ldg(st_bias + ch);
  }
#pragma unroll
  for (int e = 0; e < 9; ++e) m[e] = __ldg(st_mat + e);
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    float v[RT * 2 * 3], u[RT * 2 * 3];
#pragma unroll
    for (int r = 0; r < RT; ++r) {
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        float* vp = v + (2 * r + b) * 3;
        float* up = u + (2 * r + b) * 3;
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) {
          // multiply, then add: the plain version's two roundings
          vp[ch] = fminf(fmaxf(__fadd_rn(__fmul_rn(acc[r][a][b][ch], s[ch]),
                                         t[ch]), 0.0f), 255.0f);
        }
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) {
          up[ch] = fmaf(vp[2], m[6 + ch], fmaf(vp[1], m[3 + ch],
                                               vp[0] * m[ch])) + sb[ch];
        }
      }
    }
    float4* ip = reinterpret_cast<float4*>(
        out_s + (a * TILE_H + lane) * OUT_ROW + warp * RT * 6);
    float4* sp = ip + 2 * TILE_H * OUT_ROW / 4;
#pragma unroll
    for (int q = 0; q < RT * 6 / 4; ++q) {
      ip[q] = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
      sp[q] = make_float4(u[4 * q], u[4 * q + 1], u[4 * q + 2], u[4 * q + 3]);
    }
  }
  __syncthreads();

  const int ho = 2 * h2, wo = 2 * w2;
  const int lim = 6 * min(TILE_W, w2 - j0);    // floats of a row in image
  const bool vec = (wo * 3) % 4 == 0;          // rows start 16-byte aligned
  constexpr int QS = TILE_W * 6 / 4;           // float4 of a tile row
  for (int e = tid; e < 2 * 2 * TILE_H * QS; e += THREADS) {
    const int q = e % QS, row = (e / QS) % TILE_H, a = (e / (QS * TILE_H)) & 1;
    const int img_i = e / (QS * TILE_H * 2);
    if (i0 + row >= h2 || 4 * q >= lim) continue;
    const float* src = out_s + ((img_i * 2 + a) * TILE_H + row) * OUT_ROW +
                       4 * q;
    float* dst = (img_i ? srch : img) +
        ((static_cast<size_t>(n) * ho + 2 * (i0 + row) + a) * wo + 2 * j0) *
            3 + 4 * q;
    if (vec && 4 * q + 4 <= lim) {
      *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
    } else {
      for (int c = 0; c < 4 && 4 * q + c < lim; ++c) dst[c] = src[c];
    }
  }
}

template <typename T, bool kAsync>
int launch(const void* x, const void* wmat, const float* img_scale,
           const float* img_bias, const float* st_mat, const float* st_bias,
           float* img, float* srch, int n, int h2, int w2, int cin,
           cudaStream_t stream) {
  const int chunks = (cin + CH - 1) / CH;
  const size_t wn = static_cast<size_t>(chunks) * GROUPS * K * K * TAP_W;
  const size_t smem = std::max<size_t>(
      OUT_BYTES, wn * sizeof(float) +
                     static_cast<size_t>(STAGES) * STAGE_E * sizeof(T) +
                     (kAsync && sizeof(T) != sizeof(float) ? wn * sizeof(T)
                                                           : 0));
  cudaError_t err = cudaFuncSetAttribute(
      decode_epilogue_kernel<T, kAsync>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((w2 + TILE_W - 1) / TILE_W, (h2 + TILE_H - 1) / TILE_H, n);
  decode_epilogue_kernel<T, kAsync><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wmat), img_scale,
      img_bias, st_mat, st_bias, img, srch, h2, w2, cin);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* x, const void* wmat, const float* img_scale,
             const float* img_bias, const float* st_mat, const float* st_bias,
             float* img, float* srch, int n, int h2, int w2, int cin,
             cudaStream_t stream) {
  // cp.async moves 4 channels at once: every position's channels (and every
  // weight row group) must start on a 4 * sizeof(T) boundary and fill whole
  // chunks; the staging offsets are int32
  const bool aligned = cin % CH == 0 &&
      static_cast<long long>(h2) * w2 * cin < (1LL << 31) &&
      reinterpret_cast<uintptr_t>(x) % (4 * sizeof(T)) == 0 &&
      reinterpret_cast<uintptr_t>(wmat) % (4 * sizeof(T)) == 0;
  return aligned
      ? launch<T, true>(x, wmat, img_scale, img_bias, st_mat, st_bias, img,
                        srch, n, h2, w2, cin, stream)
      : launch<T, false>(x, wmat, img_scale, img_bias, st_mat, st_bias, img,
                         srch, n, h2, w2, cin, stream);
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
    return dispatch<__nv_bfloat16>(x, wmat, img_scale, img_bias, st_mat,
                                   st_bias, img, srch, n, h2, w2, cin,
                                   stream);
  }
  return dispatch<float>(x, wmat, img_scale, img_bias, st_mat, st_bias, img,
                         srch, n, h2, w2, cin, stream);
}

const char* decode_epilogue_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
