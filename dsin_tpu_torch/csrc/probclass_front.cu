// One wavefront front of the probclass context model on the card: the whole
// four-layer masked-conv ResShallow stack for a batch of causal context
// blocks, one launch per front.
//
// Replaces the JAX package's Pallas kernel `probclass_front_logits`
// (dsin_tpu/coding/probclass_pallas.py:94, pallas_call :115, body
// `_front_kernel` :80-91, `_conv_taps` :59-77). Bound in Python by
// dsin_tpu_torch/coding/probclass_kernel.py.
//
// Computes, per context block (5, 9, 9) of the padded symbol volume (K = 3,
// filters (2, 3, 3), 18 taps, VALID):
//   act1 = relu(conv0(block))              (4, 7, 7, C)
//   r1   = relu(conv1(act1))               (3, 5, 5, C)
//   act3 = conv2(r1) + act1[2:, 2:5, 2:5]  (2, 3, 3, C)
//   out  = relu(conv3(act3))               (L,)
// The weights arrive pre-masked as (taps * Cin, Cout) row-major matrices,
// rows in (td, th, tw, cin) order, with (Cout,) biases: the convention every
// coding engine of the port shares (models/probclass.py
// `front_weight_matrices`). C = 24 and L = 6 at pc_default.
//
// Bound on an H100: 1.63 MFLOP per block through the four convs, counting
// only the taps the causality masks keep (13 of the 18 in conv0, 14 in the
// others, each over C inputs; this kernel, like the Pallas one, also runs
// the masked taps on their zero weights). So 0.40 GFLOP for the largest
// front at 320x1224 (248 blocks, its own bucket), 6.0 us at the 67 TFLOP/s
// fp32 rate, against about 0.5 MB of traffic (blocks in, 95 KB of weights,
// logits out; 0.15 us at 3.35 TB/s). It is compute-bound.
//
// Design: the Pallas kernel tiles 128 blocks per grid step into VMEM
// matmuls; that is not carried over. Here each context block has its own
// thread block (grid = B). The block's 405 floats, then each layer's
// activations (act1 4*7*7*C, r1 3*5*5*C, act3 2*3*3*C floats: 29 KB in all
// at C = 24) live in shared memory. Each output is computed by one thread,
// which sums the taps in (td, th, tw) order and, within a tap, over cin
// ascending, in fp32 fmaf, adds the bias after the sum (as `_conv_taps`
// does) and then the ReLU. The weights (95 KB) are read from global memory
// through the read-only path and stay in L2 across blocks. Neighbouring
// threads compute neighbouring output channels of one position, so a warp
// reads consecutive weights and broadcasts one activation.
//
// Entropy path: these logits become rANS frequency tables, so the kernel is
// IEEE fp32 (no fast math, no TF32, no tensor cores) with a fixed order of
// summation and no atomics. Each row's logits are therefore a function of
// its own block alone: bit-identical whatever the batch, its batchmates or
// the padding rows, and from run to run.

#include <cuda_runtime.h>

namespace {

constexpr int kCD = 5, kCS = 9;                    // context block
constexpr int kFD = 2, kFH = 3, kFW = 3;           // filter
constexpr int kD1 = kCD - kFD + 1, kH1 = kCS - kFH + 1;   // act1 (4, 7, 7)
constexpr int kD2 = kD1 - kFD + 1, kH2 = kH1 - kFH + 1;   // r1 (3, 5, 5)
constexpr int kD3 = kD2 - kFD + 1, kH3 = kH2 - kFH + 1;   // act3 (2, 3, 3)
constexpr int kBlock = kCD * kCS * kCS;            // 405
constexpr int kPos1 = kD1 * kH1 * kH1;             // 196
constexpr int kPos2 = kD2 * kH2 * kH2;             // 75
constexpr int kPos3 = kD3 * kH3 * kH3;             // 18
constexpr int kSkipD = kD1 - kD3, kSkipHW = (kH1 - kH3) / 2;   // 2, 2
constexpr int kThreads = 256;

// One VALID conv output at (d, h, w), output channel co, before its bias:
// `act` is (D, h_in, h_in, cin) channel-last in shared memory, `wmat` the
// (taps * cin, cout) matrix.
__device__ __forceinline__ float conv_at(const float* act, int h_in, int cin,
                                         const float* __restrict__ wmat,
                                         int cout, int d, int h, int w,
                                         int co) {
  float acc = 0.0f;
  int tap = 0;
#pragma unroll
  for (int td = 0; td < kFD; ++td) {
#pragma unroll
    for (int th = 0; th < kFH; ++th) {
#pragma unroll
      for (int tw = 0; tw < kFW; ++tw, ++tap) {
        const float* a = act + (((d + td) * h_in + (h + th)) * h_in
                                + (w + tw)) * cin;
        const float* wr = wmat + static_cast<long>(tap) * cin * cout + co;
#pragma unroll 4
        for (int ci = 0; ci < cin; ++ci) {
          acc = fmaf(a[ci], __ldg(wr + static_cast<long>(ci) * cout), acc);
        }
      }
    }
  }
  return acc;
}

__global__ void __launch_bounds__(kThreads)
probclass_front_kernel(const float* __restrict__ blocks,
                       const float* __restrict__ w0,
                       const float* __restrict__ b0,
                       const float* __restrict__ w1,
                       const float* __restrict__ b1,
                       const float* __restrict__ w2,
                       const float* __restrict__ b2,
                       const float* __restrict__ w3,
                       const float* __restrict__ b3,
                       float* __restrict__ out, int channels, int logits) {
  extern __shared__ float smem[];
  const int c = channels;
  float* act0 = smem;                       // (5, 9, 9, 1)
  float* act1 = act0 + kBlock;              // (4, 7, 7, C)
  float* r1 = act1 + kPos1 * c;             // (3, 5, 5, C)
  float* act3 = r1 + kPos2 * c;             // (2, 3, 3, C)
  const int tid = threadIdx.x;
  const float* blk = blocks + static_cast<long>(blockIdx.x) * kBlock;

  for (int i = tid; i < kBlock; i += kThreads) act0[i] = blk[i];
  __syncthreads();

  for (int o = tid; o < kPos1 * c; o += kThreads) {
    const int co = o % c, p = o / c;
    const int w = p % kH1, h = (p / kH1) % kH1, d = p / (kH1 * kH1);
    act1[o] = fmaxf(conv_at(act0, kCS, 1, w0, c, d, h, w, co) + __ldg(b0 + co),
                    0.0f);
  }
  __syncthreads();

  for (int o = tid; o < kPos2 * c; o += kThreads) {
    const int co = o % c, p = o / c;
    const int w = p % kH2, h = (p / kH2) % kH2, d = p / (kH2 * kH2);
    r1[o] = fmaxf(conv_at(act1, kH1, c, w1, c, d, h, w, co) + __ldg(b1 + co),
                  0.0f);
  }
  __syncthreads();

  for (int o = tid; o < kPos3 * c; o += kThreads) {
    const int co = o % c, p = o / c;
    const int w = p % kH3, h = (p / kH3) % kH3, d = p / (kH3 * kH3);
    const float skip = act1[(((d + kSkipD) * kH1 + (h + kSkipHW)) * kH1
                             + (w + kSkipHW)) * c + co];
    act3[o] = (conv_at(r1, kH2, c, w2, c, d, h, w, co) + __ldg(b2 + co))
              + skip;
  }
  __syncthreads();

  for (int o = tid; o < logits; o += kThreads) {
    out[static_cast<long>(blockIdx.x) * logits + o] = fmaxf(
        conv_at(act3, kH3, c, w3, logits, 0, 0, 0, o) + __ldg(b3 + o), 0.0f);
  }
}

}  // namespace

extern "C" {

// Shared memory of one thread block, bytes.
long probclass_front_smem_bytes(int channels) {
  return static_cast<long>(kBlock + (kPos1 + kPos2 + kPos3) * channels)
         * sizeof(float);
}

// blocks (batch, 5, 9, 9) f32; w0 (18, C), w1 and w2 (18 C, C), w3 (18 C, L)
// pre-masked; b0..b2 (C,), b3 (L,); out (batch, L). Launches on `stream`,
// does not synchronise; returns the launch error (cudaSuccess = 0).
int probclass_front_logits(const float* blocks, const float* w0,
                           const float* b0, const float* w1, const float* b1,
                           const float* w2, const float* b2, const float* w3,
                           const float* b3, float* out, int batch,
                           int channels, int logits, void* stream) {
  if (batch <= 0) return cudaSuccess;
  const long smem = probclass_front_smem_bytes(channels);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        probclass_front_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  probclass_front_kernel<<<batch, kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      blocks, w0, b0, w1, b1, w2, b2, w3, b3, out, channels, logits);
  return cudaGetLastError();
}

const char* probclass_front_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
