// One wavefront front of the probclass context model on the card: the whole
// four-layer masked-conv ResShallow stack for a batch of causal context
// blocks, one launch per front, cut to the work the one logit row needs.
//
// Replaces the JAX package's Pallas kernel `probclass_front_logits`
// (dsin_tpu/coding/probclass_pallas.py:94, pallas_call :115, body
// `_front_kernel` :80-91, `_conv_taps` :59-77). Bound in Python by
// dsin_tpu_torch/coding/probclass_kernel.py, which also derives every table
// this kernel walks (`prepare_front`).
//
// Computes, per context block (5, 9, 9) of the padded symbol volume (K = 3,
// filters (2, 3, 3), VALID):
//   act1 = relu(conv0(block))              (4, 7, 7, C)
//   r1   = relu(conv1(act1))               (3, 5, 5, C)
//   act3 = conv2(r1) + act1[2:, 2:5, 2:5]  (2, 3, 3, C)
//   out  = relu(conv3(act3))               (L,)
// C = 24 and L = 6 at pc_default.
//
// Only part of that is needed. The causality masks keep 13 of the 18 taps of
// conv0 and 14 of the others; tracing back from the single conv3 output
// through the kept taps and the skip, the logit reads 14 of the 18 act3
// positions, 56 of the 75 r1 positions, 144 of the 196 act1 positions and
// 294 of the 405 inputs (`needed_positions`). The work the logit needs is
// 144*13*C + 56*14*C*C + 14*14*C*C + 14*C*L multiply-adds: 611,424 a block at
// C = 24, L = 6 (1.22 MFLOP), 42% fewer than the dense stack with every tap.
//
// Bound on an H100: at B = 248, the largest front of a 320x1224 volume and
// its own bucket, 0.303 GFLOP = 4.53 us at the 67 TFLOP/s fp32 rate, against
// about 0.48 MB of traffic (blocks in, 74 KB of compacted weights, logits
// out: 0.14 us at 3.35 TB/s). Compute-bound; and every launch pays one
// thread block's critical path, since the fronts of a pass are small.
//
// Design. One thread block per context block (grid = B), so each row is a
// function of its own block. The parameters arrive as one prepared buffer:
// int32 tables (each layer's kept taps as offsets in its input grid; each
// layer's needed outputs as (out, in_base, skip) positions) and the
// compacted weights (masked rows dropped: (13, C), (14C, C), (14C, C),
// (14C, L)) with their biases, each piece padded to 16 bytes. At entry one
// thread stages the buffer into shared memory with three 1D bulk copies
// (cp.async.bulk on an mbarrier each): the tables with w0 first, then w1,
// then w2 and w3, so conv0 starts as soon as its 1.3 KB have landed and the
// rest arrives while it runs. The block's 405 inputs and each layer's dense
// activation grid (29 KB at C = 24) sit in shared memory too; only the
// needed positions are written or read. About 104 KB a block at C = 24:
// two blocks per SM, so the 248-block bucket is one wave on 132 SMs.
// Each thread owns a register tile: P positions x 4 output channels (P = 2
// in conv1, whose 56 x C outputs then take one round of 192 threads; P = 1
// in conv0 and conv2), reading 4 input channels of each position and 4
// rows of weights as float4 per step. conv3's L outputs are one thread each.
//
// Bit-identity with the dense kernel this one replaced, and from run to run:
// every output is still one fmaf chain, over its kept taps in (td, th, tw)
// order and Cin ascending within a tap, starting from 0, with the bias added
// after the sum, then the ReLU, or for act3 the skip. No sum is split across
// threads. A dropped masked tap carried a zero weight, and fmaf(a, +-0, acc)
// == acc for finite a, so the running sum is exactly as before; an output
// that no kept tap reads never entered a logit. So the logits equal the
// dense kernel's bit for bit, up to the sign of an exact zero, which softmax
// cannot see, and the rANS tables and streams are unchanged.
//
// Entropy path: these logits become rANS frequency tables, so the kernel is
// IEEE fp32 (no fast math, no TF32, no tensor cores) with a fixed order of
// summation and no atomics. Each row is bit-identical whatever the batch,
// its batchmates or the padding rows.

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace {

constexpr int kThreads = 192;

// The prepared buffer's and shared memory's layout, in 4-byte words from
// their start; field for field the int tuple `prepare_front` builds.
// Layer i's tables: taps[i] (ntaps[i] offsets, in positions of its input
// grid) and pos[i] (npos[i] triples: output position, input position of tap
// 0, act1 position of the skip (conv2 only)).
struct Layout {
  int channels, logits, block_words;
  int seg_end[3];          // ends of the three staged segments
  int taps[4], ntaps[4];
  int pos[4], npos[4];
  int w[4], b[4];
  int smem_in, smem_act[3], smem_words;
};
constexpr int kLayoutInts = sizeof(Layout) / sizeof(int);
static_assert(kLayoutInts == 35, "Layout must match prepare_front");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Stage `words` words from global `src` into shared `dst` on barrier `bar`.
__device__ __forceinline__ void stage(uint64_t* bar, float* dst,
                                      const float* src, int words) {
  const uint32_t b = smem_addr(bar), bytes = 4u * words;
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(b), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(b) : "memory");
}

// Wait for the first (and only) phase of `bar` to complete.
__device__ __forceinline__ void wait(uint64_t* bar) {
  const uint32_t b = smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(b), "r"(0u) : "memory");
  }
}

// conv0 (Cin = 1) + bias + ReLU into act1, one position x 4 channels a
// thread.
__device__ __forceinline__ void conv0(const float* in, float* out,
                                      const int* tab, int n,
                                      const int* taps, int ntaps,
                                      const float* w, const float* b, int c) {
  const int groups = c / 4;
  for (int item = threadIdx.x; item < n * groups; item += kThreads) {
    const int g = item % groups, p = item / groups;
    const float* a = in + tab[3 * p + 1];
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int k = 0; k < ntaps; ++k) {
      const float x = a[taps[k]];
      const float4 wk = *reinterpret_cast<const float4*>(w + k * c + 4 * g);
      acc[0] = fmaf(x, wk.x, acc[0]);
      acc[1] = fmaf(x, wk.y, acc[1]);
      acc[2] = fmaf(x, wk.z, acc[2]);
      acc[3] = fmaf(x, wk.w, acc[3]);
    }
    float* o = out + tab[3 * p] * c + 4 * g;
#pragma unroll
    for (int j = 0; j < 4; ++j) o[j] = fmaxf(acc[j] + b[4 * g + j], 0.0f);
  }
}

// A Cin = C conv + bias, then the act1 skip (conv2) or the ReLU (conv1):
// P positions x 4 output channels a thread, float4 over Cin.
template <int P, bool kSkip>
__device__ __forceinline__ void conv_c(const float* in, float* out,
                                       const float* act1, const int* tab,
                                       int n, const int* taps, int ntaps,
                                       const float* w, const float* b, int c) {
  const int groups = c / 4;
  const int items = (n + P - 1) / P * groups;
  for (int item = threadIdx.x; item < items; item += kThreads) {
    const int g = item % groups, first = item / groups * P;
    int idx[P];
    const float* a[P];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      idx[p] = min(first + p, n - 1);   // a ragged last tile repeats its row
      a[p] = in + tab[3 * idx[p] + 1] * c;
    }
    float acc[P][4];
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[p][j] = 0.0f;
    for (int k = 0; k < ntaps; ++k) {
      const int off = taps[k] * c;
      const float* wk = w + k * c * c + 4 * g;
#pragma unroll 2
      for (int ci = 0; ci < c; ci += 4) {
        float4 x[P];
#pragma unroll
        for (int p = 0; p < P; ++p)
          x[p] = *reinterpret_cast<const float4*>(a[p] + off + ci);
        float4 wr[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          wr[i] = *reinterpret_cast<const float4*>(wk + (ci + i) * c);
#pragma unroll
        for (int p = 0; p < P; ++p) {
          const float xs[4] = {x[p].x, x[p].y, x[p].z, x[p].w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {      // Cin ascending in each chain
            acc[p][0] = fmaf(xs[i], wr[i].x, acc[p][0]);
            acc[p][1] = fmaf(xs[i], wr[i].y, acc[p][1]);
            acc[p][2] = fmaf(xs[i], wr[i].z, acc[p][2]);
            acc[p][3] = fmaf(xs[i], wr[i].w, acc[p][3]);
          }
        }
      }
    }
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int* t = tab + 3 * idx[p];
      float* o = out + t[0] * c + 4 * g;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float v = acc[p][j] + b[4 * g + j];
        o[j] = kSkip ? v + act1[t[2] * c + 4 * g + j] : fmaxf(v, 0.0f);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, 2)
probclass_front_kernel(const float* __restrict__ blocks,
                       const float* __restrict__ params,
                       float* __restrict__ out, const Layout lay) {
  extern __shared__ __align__(16) float smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + lay.smem_words);
  const int tid = threadIdx.x, c = lay.channels;
  const int* tabs = reinterpret_cast<const int*>(smem);

  if (tid == 0) {
    for (int i = 0; i < 3; ++i)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                   :: "r"(smem_addr(&bars[i])) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    int start = 0;
    for (int i = 0; i < 3; ++i) {
      stage(&bars[i], smem + start, params + start, lay.seg_end[i] - start);
      start = lay.seg_end[i];
    }
  }
  float* in = smem + lay.smem_in;
  const float* blk = blocks + static_cast<long>(blockIdx.x) * lay.block_words;
  for (int i = tid; i < lay.block_words; i += kThreads) in[i] = blk[i];
  float* act1 = smem + lay.smem_act[0];
  float* r1 = smem + lay.smem_act[1];
  float* act3 = smem + lay.smem_act[2];
  __syncthreads();

  wait(&bars[0]);
  conv0(in, act1, tabs + lay.pos[0], lay.npos[0], tabs + lay.taps[0],
        lay.ntaps[0], smem + lay.w[0], smem + lay.b[0], c);
  __syncthreads();

  wait(&bars[1]);
  conv_c<2, false>(act1, r1, nullptr, tabs + lay.pos[1], lay.npos[1],
                   tabs + lay.taps[1], lay.ntaps[1], smem + lay.w[1],
                   smem + lay.b[1], c);
  __syncthreads();

  wait(&bars[2]);
  conv_c<1, true>(r1, act3, act1, tabs + lay.pos[2], lay.npos[2],
                  tabs + lay.taps[2], lay.ntaps[2], smem + lay.w[2],
                  smem + lay.b[2], c);
  __syncthreads();

  const int l_out = lay.logits;
  if (tid < l_out) {
    const float* a = act3 + tabs[lay.pos[3] + 1] * c;
    const int* taps = tabs + lay.taps[3];
    const float* w = smem + lay.w[3] + tid;
    float acc = 0.0f;
    for (int k = 0; k < lay.ntaps[3]; ++k) {
      const float* ak = a + taps[k] * c;
      const float* wk = w + k * c * l_out;
#pragma unroll 4
      for (int ci = 0; ci < c; ++ci) acc = fmaf(ak[ci], wk[ci * l_out], acc);
    }
    out[static_cast<long>(blockIdx.x) * l_out + tid] =
        fmaxf(acc + smem[lay.b[3] + tid], 0.0f);
  }
}

}  // namespace

extern "C" {

// Ints in the layout tuple this library takes.
int probclass_front_layout_ints() { return kLayoutInts; }

// blocks (batch, 5, 9, 9) f32; params the prepared buffer; layout its
// `n_layout` ints; out (batch, L). Launches on `stream`, does not
// synchronise; returns the launch error (cudaSuccess = 0).
int probclass_front_logits(const float* blocks, const float* params,
                           const int* layout, int n_layout, float* out,
                           int batch, void* stream) {
  if (n_layout != kLayoutInts) return cudaErrorInvalidValue;
  Layout lay;
  std::memcpy(&lay, layout, sizeof(lay));
  if (lay.channels <= 0 || lay.channels % 4 != 0 || lay.logits <= 0
      || lay.logits > kThreads || lay.smem_words % 4 != 0)
    return cudaErrorInvalidValue;
  if (batch <= 0) return cudaSuccess;
  const int smem = 4 * lay.smem_words + 3 * sizeof(uint64_t);   // + bars
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        probclass_front_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
  }
  probclass_front_kernel<<<batch, kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      blocks, params, out, lay);
  return cudaGetLastError();
}

const char* probclass_front_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
