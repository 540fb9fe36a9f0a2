// Fused masked-Pearson patch search with arg-max, for Hopper (sm_90a), on the
// tensor cores at fp32 accuracy (3xTF32).
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
// torch.argmax take the first maximum; with no valid position the index is
// 0. The (P, Hc, Wc) score map never exists in memory: 1.18 GB per image at
// 320x1224 with 20x24 patches.
//
// Bound on an H100 SXM (700 W) at 320x1224, 20x24 patches (P = 816,
// K = 1440, Hc x Wc = 301 x 1201): 2 * P * K * Hc * Wc = 0.85 TFLOP per image.
//   * in fp32 on the CUDA cores (67 TFLOP/s): 12.68 ms per image;
//   * as 3xTF32 on the tensor cores (three TF32 products per fp32 product,
//     495 TFLOP/s): 5.15 ms per image, the least time for an fp32-accurate
//     search on this card.
// Operands are about 16 MB per image (0.005 ms at 3.35 TB/s): the search is
// bound by operations.
//
// Design.
//   * 3xTF32. Every operand value x is split once: hi = cvt.rna.tf32(x),
//     lo = cvt.rna.tf32(x - hi) (x - hi is exact in fp32). Each k-step of 8
//     adds lo_a*hi_b, then hi_a*lo_b, then hi_a*hi_b (small terms first) with
//     mma.sync.m16n8k8 TF32; lo_a*lo_b (2^-22 relative) is dropped. Operands
//     rounded to bfloat16 are exact in TF32: lo is 0 and the products are
//     exact. One TF32 pass alone (about three decimal digits) would not keep
//     the arg-max of near-ties.
//   * Two-level sums. The tensor cores round each MMA's sum toward zero;
//     over all 3 * K / 8 MMAs of one running sum that bias grew to 2e-5 of a
//     score on smooth images (against 3e-6 for fp32 FMA). So each 32-deep
//     k-slice sums from 0 on the tensor cores (12 MMAs), and the slice sums
//     join the tile's fp32 sums by ordinary round-to-nearest adds: the
//     errors of the slices no longer share a sign, and the scores are back
//     within 3e-6 of the plain version there, as with fp32 FMA.
//   * GEMM shape: M = patches (A = pk, K-major), N = map positions (B = the
//     im2col of y, never materialized), K in (dc, ch, dr) order.
//   * Position tiles are row-aligned: ROWS map rows x BNC columns. Such a
//     tile reads only y[:, r0 : r0 + ROWS + ph - 1, c0 : c0 + BNC + pw - 1],
//     its slab. The slab is copied with cp.async into shared memory during
//     the tile before, and split once into hi and lo slabs when its tile
//     starts; the k-slice (dc, ch, dr) of the operand is then the slab row
//     (ch, row + dr) shifted by dc columns: one table lookup per k and lane,
//     every B fragment a shared-memory read at any column shift. Slab rows
//     are padded (rows per channel = ph (mod 4), row stride = 8 (mod 16)
//     words) so a warp's fragment reads hit 32 distinct banks.
//   * pk streams through a STAGES-deep cp.async ring of BM x BK slices. The
//     slices repeat for every tile of the block, so the ring runs on across
//     the block's tiles and never drains; pk fragments are split as they are
//     read.
//   * Block: 4 warps, BM = 64 patches x 128 positions (2 map rows x 64
//     columns); warp (wm, row) owns 32 patches x the 64 columns of one map
//     row: 2 x 8 MMA tiles, 64 fp32 sums and 64 slice sums a lane (234
//     registers, no spill). About 111 KB of shared memory a block at 20x24
//     and 16x32 patches: two blocks an SM. (Warps of 64 x 64 were 10%
//     faster with one running sum, 24.3 against 26.6 ms at batch 2,
//     320x1224 on an H100 80GB HBM3 at 700 W, but cannot hold two sets of
//     sums without spilling.)
//   * Epilogue in the Pallas multiply order, positions past the map -inf, a
//     per-lane running (value, index) best with the lowest-index rule; after
//     the block's tiles, two shuffles and one shared-memory step merge the
//     lanes and the rows. Stage 2 reduces over the position groups.
//   * Every output element sees the same k-steps in the same order and the
//     same three products per step, whatever its place in its tile or its
//     tile: identical windows give bit-identical scores wherever they sit
//     (ties across blocks, K1 against K2, an image alone or in a batch).
//   * The wrapper sizes `groups` as for tiles of BN consecutive positions;
//     the kernel deals its row-aligned tiles out evenly over the groups.
//   * Patches so tall that the slab cannot fit in shared memory (ph of a
//     few hundred rows) take the same kernel with the B fragments read from
//     y in global memory and split as they are read.
// No atomics: the result depends neither on the order blocks run in nor on
// which other images share the launch.

#include <cuda_runtime.h>
#include <climits>
#include <cmath>
#include <cstdint>

namespace {

constexpr int BM = 64;                  // patches per block tile
constexpr int ROWS = 2;                 // map rows per position tile
constexpr int BNC = 64;                 // map columns per position tile
constexpr int BN = ROWS * BNC;          // positions per tile (128)
constexpr int WM = 32;                  // patches per warp
constexpr int WARPS_M = BM / WM;        // 2
constexpr int WARPS = WARPS_M * ROWS;   // 4: warp = (patch half, map row)
constexpr int THREADS = 32 * WARPS;     // 128
constexpr int MT = WM / 16;             // m16 tiles per warp (2)
constexpr int NT = BNC / 8;             // n8 tiles per warp (8)
constexpr int BK = 32;                  // k depth of one ring slice
constexpr int BKP = BK + 4;             // padded slice row: conflict-free reads
constexpr int SLICE = BM * BKP;         // floats per ring slice
constexpr int STAGES = 3;               // ring slices in flight
constexpr int MIN_BLOCKS = 2;           // per SM
constexpr int MAX_K = 8192;
constexpr int SMEM_LIMIT = 232448;      // dynamic shared memory a block may use
static_assert(BM % WM == 0 && WM % 16 == 0 && BNC % 8 == 0 && BK % 8 == 0,
              "tile shapes");

// Shapes of one launch, computed on the host.
struct Geo {
  int C, H, W, ph, pw, P, K, KP;  // KP: K rounded up to BK
  int hc, wc;
  int n_ct, n_tiles, groups;      // column tiles per row band, tiles, groups
  int SRr, SR, SW, SS;            // slab rows used / per channel, columns, stride
  int slab;                       // floats in one slab (C * SR * SS); 0: none
  int vec16;                      // pk rows 16-byte aligned: 16-byte copies
};

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x -> (hi, lo), both TF32: x = hi + lo up to 2^-22 |x|
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async with zero fill: `ok` false copies nothing and writes zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// pk[p0 : p0 + BM, k0 : k0 + BK] -> one ring slice (row m at m * BKP);
// patches past P and taps past K read as 0
__device__ __forceinline__ void copy_slice(uint32_t dst, const float* pk,
                                           int p0, int k0, const Geo& g,
                                           int tid) {
  if (g.vec16) {
#pragma unroll
    for (int u = 0; u < BM * BK / 4 / THREADS; ++u) {
      const int e = tid + u * THREADS;
      const int m = e / (BK / 4), q = e % (BK / 4);
      const int p = p0 + m, k = k0 + 4 * q;
      const bool ok = p < g.P && k < g.K;
      cp_async16(dst + (m * BKP + 4 * q) * 4,
                 ok ? pk + static_cast<long long>(p) * g.K + k : pk, ok);
    }
  } else {
#pragma unroll 4
    for (int u = 0; u < BM * BK / THREADS; ++u) {
      const int e = tid + u * THREADS;
      const int m = e / BK, q = e % BK;
      const int p = p0 + m, k = k0 + q;
      const bool ok = p < g.P && k < g.K;
      cp_async4(dst + (m * BKP + q) * 4,
                ok ? pk + static_cast<long long>(p) * g.K + k : pk, ok);
    }
  }
}

// y[:, r0 : r0 + SRr, c0 : c0 + SW] -> the raw slab, row (ch, i) at
// (ch * SR + i) * SS; outside the image reads as 0
__device__ __forceinline__ void copy_slab(uint32_t dst, const float* y,
                                          int r0, int c0, const Geo& g,
                                          int warp, int lane) {
  const int rows = g.C * g.SRr;
  for (int r = warp; r < rows; r += WARPS) {
    const int ch = r / g.SRr, i = r - ch * g.SRr;
    const int gr = r0 + i;
    const float* src =
        y + (static_cast<long long>(ch) * g.H + min(gr, g.H - 1)) * g.W;
    const uint32_t row = dst + (ch * g.SR + i) * g.SS * 4;
    for (int j = lane; j < g.SW; j += 32) {
      const int gc = c0 + j;
      const bool ok = gr < g.H && gc < g.W;
      cp_async4(row + j * 4, ok ? src + gc : y, ok);
    }
  }
}

template <bool kSlab>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
pearson_argmax_tc(const float* __restrict__ y, long long y_bstride,
                  const float* __restrict__ pk,
                  const float* __restrict__ dnm, long long d_bstride,
                  const float* __restrict__ gh,
                  const float* __restrict__ gw_t,
                  float* __restrict__ part_val, int* __restrict__ part_idx,
                  const Geo g) {
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;                                        // STAGES slices
  int* koff = reinterpret_cast<int*>(ring + STAGES * SLICE);  // KP taps
  float* red_v = reinterpret_cast<float*>(koff + g.KP);      // ROWS x BM
  int* red_i = reinterpret_cast<int*>(red_v + ROWS * BM);
  float* raw = reinterpret_cast<float*>(red_i + ROWS * BM);  // slab as copied
  float* sh = raw + g.slab;                                  // its hi parts
  float* sl = sh + g.slab;                                   // its lo parts

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;   // MMA group, thread in group
  const int wm = warp % WARPS_M, wr = warp / WARPS_M;
  const int p0 = blockIdx.x * BM;
  const int grp = blockIdx.y;
  const int b = blockIdx.z;

  y += b * y_bstride;
  pk += static_cast<long long>(b) * g.P * g.K;
  dnm += b * d_bstride;

  const int t_begin =
      static_cast<int>(static_cast<long long>(grp) * g.n_tiles / g.groups);
  const int t_end = static_cast<int>(
      static_cast<long long>(grp + 1) * g.n_tiles / g.groups);
  const int n_chunks = g.KP / BK;
  const int total = (t_end - t_begin) * n_chunks;   // ring slices to run

  // tap k = (dc, ch, dr) -> its offset in the slab (or in y); the k tail
  // reads any finite value, its pk is 0
  const int cph = g.C * g.ph;
  for (int k = tid; k < g.KP; k += THREADS) {
    int off = 0;
    if (k < g.K) {
      const int dc = k / cph, rem = k - dc * cph;
      const int ch = rem / g.ph, dr = rem - ch * g.ph;
      off = kSlab ? (ch * g.SR + dr) * g.SS + dc
                  : (ch * g.H + dr) * g.W + dc;
    }
    koff[k] = off;
  }

  float best_v[MT][2];
  int best_i[MT][2];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      best_v[i][h] = -INFINITY;
      best_i[i][h] = INT_MAX;
    }

  const uint32_t ring_a = smem_addr(ring);
  const uint32_t raw_a = smem_addr(raw);

  // prologue: the first tile's slab and STAGES - 1 slices, one commit group
  // per slice (empty groups keep the count uniform)
  if (kSlab && total > 0) {
    const int rt = t_begin / g.n_ct;
    copy_slab(raw_a, y, rt * ROWS, (t_begin - rt * g.n_ct) * BNC, g, warp,
              lane);
  }
  int fill_chunk = 0, fill_slot = 0;   // the next slice to copy, and where
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < total) copy_slice(ring_a + fill_slot * SLICE * 4, pk, p0,
                              fill_chunk * BK, g, tid);
    cp_async_commit();
    if (++fill_chunk == n_chunks) fill_chunk = 0;
    if (++fill_slot == STAGES) fill_slot = 0;
  }

  int s = 0, slot = 0;                 // the slice being computed, its slot
  for (int tile = t_begin; tile < t_end; ++tile) {
    const int rt = tile / g.n_ct, ct = tile - rt * g.n_ct;
    const int r0 = rt * ROWS, c0 = ct * BNC;
    // without a slab: y offset of this lane's map row (clamped)
    const int brow = min(r0 + wr, g.hc - 1) * g.W;
    if constexpr (kSlab) {
      // this tile's raw slab was committed n_chunks groups ago
      if (n_chunks >= STAGES - 1) {
        cp_async_wait<STAGES - 2>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();   // the raw slab is in; the last tile's reads are done
      for (int e = 4 * tid; e < g.slab; e += 4 * THREADS) {
        const float4 v = *reinterpret_cast<const float4*>(raw + e);
        uint4 hi, lo;
        split(v.x, hi.x, lo.x);
        split(v.y, hi.y, lo.y);
        split(v.z, hi.z, lo.z);
        split(v.w, hi.w, lo.w);
        *reinterpret_cast<uint4*>(sh + e) = hi;
        *reinterpret_cast<uint4*>(sl + e) = lo;
      }
      // visible after the first slice's barrier
    }
    const int bofs = wr * g.SS + gq;   // this lane's column in the slab

    float acc[MT][NT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

    for (int c = 0; c < n_chunks; ++c, ++s) {
      cp_async_wait<STAGES - 2>();
      __syncthreads();   // slice s is in; slice s - 1's slot is free
      if (s + STAGES - 1 < total)
        copy_slice(ring_a + fill_slot * SLICE * 4, pk, p0, fill_chunk * BK,
                   g, tid);
      if (kSlab && c == 0 && tile + 1 < t_end) {
        // the next tile's raw slab: this tile's split read it before the
        // barrier above
        const int nt = tile + 1, nrt = nt / g.n_ct;
        copy_slab(raw_a, y, nrt * ROWS, (nt - nrt * g.n_ct) * BNC, g, warp,
                  lane);
      }
      cp_async_commit();
      if (++fill_chunk == n_chunks) fill_chunk = 0;
      if (++fill_slot == STAGES) fill_slot = 0;

      const float* as = ring + slot * SLICE + (wm * WM + gq) * BKP + tq;
      const int* ko = koff + c * BK + tq;
      float part[MT][NT][4];   // this slice's sums, from 0 on the tensor cores
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) part[i][j][q] = 0.f;
#pragma unroll
      for (int kk = 0; kk < BK; kk += 8) {
        uint32_t ahi[MT][4], alo[MT][4];
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const float* ap = as + i * 16 * BKP + kk;
          split(ap[0], ahi[i][0], alo[i][0]);
          split(ap[8 * BKP], ahi[i][1], alo[i][1]);
          split(ap[4], ahi[i][2], alo[i][2]);
          split(ap[8 * BKP + 4], ahi[i][3], alo[i][3]);
        }
        const int o0 = ko[kk], o1 = ko[kk + 4];
        if constexpr (kSlab) {
          uint32_t bhi[NT][2], blo[NT][2];
          const float* h0 = sh + o0 + bofs;
          const float* h1 = sh + o1 + bofs;
          const float* l0 = sl + o0 + bofs;
          const float* l1 = sl + o1 + bofs;
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            bhi[j][0] = __float_as_uint(h0[8 * j]);
            bhi[j][1] = __float_as_uint(h1[8 * j]);
            blo[j][0] = __float_as_uint(l0[8 * j]);
            blo[j][1] = __float_as_uint(l1[8 * j]);
          }
          // small terms first; MT x NT independent accumulators between
          // the dependent products of one element
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int i = 0; i < MT; ++i)
              mma(part[i][j], alo[i], bhi[j][0], bhi[j][1]);
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int i = 0; i < MT; ++i)
              mma(part[i][j], ahi[i], blo[j][0], blo[j][1]);
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int i = 0; i < MT; ++i)
              mma(part[i][j], ahi[i], bhi[j][0], bhi[j][1]);
        } else {
          // one n-tile's fragments at a time (registers); the same three
          // products per element in the same order
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            const int at = brow + min(c0 + 8 * j + gq, g.wc - 1);
            uint32_t bhi0, blo0, bhi1, blo1;
            split(__ldg(y + o0 + at), bhi0, blo0);
            split(__ldg(y + o1 + at), bhi1, blo1);
#pragma unroll
            for (int i = 0; i < MT; ++i) mma(part[i][j], alo[i], bhi0, bhi1);
#pragma unroll
            for (int i = 0; i < MT; ++i) mma(part[i][j], ahi[i], blo0, blo1);
#pragma unroll
            for (int i = 0; i < MT; ++i) mma(part[i][j], ahi[i], bhi0, bhi1);
          }
        }
      }
      // the slice's sum joins the tile's in fp32, rounded to nearest
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[i][j][q] += part[i][j][q];
      if (++slot == STAGES) slot = 0;
    }

    // epilogue: Pallas multiply order, ragged edge to -inf, running best.
    // Accumulator (i, j, 2h + e) is patch row i*16 + h*8 + gq of the warp,
    // column 8j + 2tq + e of its map row.
    const int row = r0 + wr;
    const bool row_ok = row < g.hc;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = c0 + 8 * j + 2 * tq + e;
        const bool ok = row_ok && col < g.wc;
        const int rr = ok ? row : 0, cc = ok ? col : 0;
        const int n = rr * g.wc + cc;
        const float d = dnm[n];
#pragma unroll
        for (int i = 0; i < MT; ++i) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int p = p0 + wm * WM + i * 16 + h * 8 + gq;
            if (p >= g.P) continue;
            float sc = acc[i][j][2 * h + e] * d;
            sc = sc * gh[static_cast<long long>(rr) * g.P + p];
            sc = sc * gw_t[static_cast<long long>(p) * g.wc + cc];
            if (!ok) sc = -INFINITY;
            if (better(sc, n, best_v[i][h], best_i[i][h])) {
              best_v[i][h] = sc;
              best_i[i][h] = n;
            }
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  // the 4 lanes of an MMA group share patch rows: butterfly over tq
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, best_v[i][h], off);
        const int oi = __shfl_xor_sync(0xffffffffu, best_i[i][h], off);
        if (better(ov, oi, best_v[i][h], best_i[i][h])) {
          best_v[i][h] = ov;
          best_i[i][h] = oi;
        }
      }
      if (tq == 0) {
        const int m = wm * WM + i * 16 + h * 8 + gq;
        red_v[wr * BM + m] = best_v[i][h];
        red_i[wr * BM + m] = best_i[i][h];
      }
    }
  }
  __syncthreads();
  if (tid < BM && p0 + tid < g.P) {
    float bv = red_v[tid];
    int bi = red_i[tid];
#pragma unroll
    for (int r = 1; r < ROWS; ++r) {
      if (better(red_v[r * BM + tid], red_i[r * BM + tid], bv, bi)) {
        bv = red_v[r * BM + tid];
        bi = red_i[r * BM + tid];
      }
    }
    const long long o = (static_cast<long long>(b) * g.groups + grp) * g.P +
                        p0 + tid;
    part_val[o] = bv;
    part_idx[o] = bi;
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

// Positions per stage-1 tile; the wrapper sizes the position groups (and
// the partial buffers) from it.
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
  Geo g;
  g.C = C;
  g.H = H;
  g.W = W;
  g.ph = ph;
  g.pw = pw;
  g.P = P;
  g.K = static_cast<int>(K);
  g.KP = static_cast<int>((K + BK - 1) / BK * BK);
  g.hc = static_cast<int>(hc);
  g.wc = static_cast<int>(wc);
  g.n_ct = static_cast<int>((wc + BNC - 1) / BNC);
  g.n_tiles = static_cast<int>((hc + ROWS - 1) / ROWS * g.n_ct);
  g.groups = groups;
  g.SRr = ROWS + ph - 1;
  g.SR = g.SRr + ((ph - g.SRr) % 4 + 4) % 4;   // = ph (mod 4)
  g.SW = BNC + pw - 1;
  g.SS = g.SW;
  while (g.SS % 16 != 8) ++g.SS;               // = 8 or 24 (mod 32)
  const long long slab = static_cast<long long>(C) * g.SR * g.SS;
  const long long base = sizeof(float) * STAGES * SLICE +
                         sizeof(int) * static_cast<long long>(g.KP) +
                         (sizeof(float) + sizeof(int)) * ROWS * BM;
  const bool use_slab = base + 3 * sizeof(float) * slab <= SMEM_LIMIT;
  g.slab = use_slab ? static_cast<int>(slab) : 0;
  g.vec16 = K % 4 == 0 && reinterpret_cast<uintptr_t>(pk) % 16 == 0;
  const size_t smem =
      static_cast<size_t>(base + 3 * sizeof(float) * g.slab);

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid1((P + BM - 1) / BM, groups, B);
  cudaError_t err;
  if (use_slab) {
    err = cudaFuncSetAttribute(pearson_argmax_tc<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    pearson_argmax_tc<true><<<grid1, THREADS, smem, s>>>(
        y, y_bstride, pk, dnm, d_bstride, gh, gw_t, part_val, part_idx, g);
  } else {
    err = cudaFuncSetAttribute(pearson_argmax_tc<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    pearson_argmax_tc<false><<<grid1, THREADS, smem, s>>>(
        y, y_bstride, pk, dnm, d_bstride, gh, gw_t, part_val, part_idx, g);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = 256;
  pearson_argmax_stage2<<<(B * P + threads - 1) / threads, threads, 0, s>>>(
      part_val, part_idx, best_val, best_idx, B, P, groups);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
