// Byte-wise rANS entropy coder (native backend of dsin_tpu.coding.rans).
//
// The reference repo ships only vestigial arithmetic-coding hooks that are
// never called and whose drivers are missing (reference
// probclass_imgcomp.py:361-482: integer frequency tables at freqs_resolution
// for an external coder that does not exist in the repo). This file is the
// real thing: a static-per-symbol-frequency rANS coder that turns the
// context model's per-position PMFs into an actual bitstream.
//
// Algorithm: standard byte-renormalized rANS ("ryg_rans" construction):
//   state x in [RANS_L, RANS_L*256), RANS_L = 1<<23, frequencies quantized
//   to sum to 1<<scale_bits (scale_bits <= 16).
// Encoding consumes symbols in REVERSE order and emits bytes; the final
// stream is [4-byte little-endian final state][renorm bytes in reverse
// emission order], so the decoder reads strictly forward. Reverse-order
// encoding is fine for an autoregressive context model: the encoder knows
// every symbol up front (teacher forcing); only the DECODER is sequential.
//
// The Python fallback in ../rans.py implements the identical integer
// algorithm; both produce bit-identical streams (tested).

#include <cstdint>
#include <cstdlib>

namespace {

constexpr uint32_t kRansL = 1u << 23;  // lower bound of the state interval

struct Decoder {
  const uint8_t* data;
  long size;
  long pos;       // next byte to read
  uint32_t state;
};

}  // namespace

extern "C" {

// Shared encode core: one independent symbol lane into `out`, renorm
// bytes staged in the caller-provided `scratch` (>= cap bytes). Returns
// bytes written or -1 if cap is too small.
static long encode_lane(const uint32_t* starts, const uint32_t* freqs,
                        long n, int scale_bits, uint8_t* out, long cap,
                        uint8_t* scratch) {
  long sp = 0;
  uint64_t x = kRansL;
  for (long i = n - 1; i >= 0; --i) {
    uint32_t freq = freqs[i];
    // renormalize: keep x < ((RANS_L >> scale_bits) << 8) * freq
    uint64_t x_max =
        (static_cast<uint64_t>(kRansL >> scale_bits) << 8) * freq;
    while (x >= x_max) {
      if (sp >= cap) return -1;
      scratch[sp++] = static_cast<uint8_t>(x & 0xff);
      x >>= 8;
    }
    x = ((x / freq) << scale_bits) + (x % freq) + starts[i];
  }
  long total = sp + 4;
  if (total > cap) return -1;
  out[0] = static_cast<uint8_t>(x & 0xff);
  out[1] = static_cast<uint8_t>((x >> 8) & 0xff);
  out[2] = static_cast<uint8_t>((x >> 16) & 0xff);
  out[3] = static_cast<uint8_t>((x >> 24) & 0xff);
  for (long i = 0; i < sp; ++i) out[4 + i] = scratch[sp - 1 - i];
  return total;
}

// Encode n symbols given per-symbol (start, freq) in FORWARD order.
// Returns the number of bytes written to out, -1 if cap is too small
// (the Python side retries with a doubled cap), or -2 if the scratch
// allocation failed (a retry would only make the OOM worse — the
// Python side raises, coding/rans.py).
// Layout: out[0..3] = final state (LE), then renorm bytes.
long rans_encode(const uint32_t* starts, const uint32_t* freqs, long n,
                 int scale_bits, uint8_t* out, long cap) {
  // Emit into a scratch buffer forward, then reverse into `out`.
  uint8_t* scratch = static_cast<uint8_t*>(malloc(cap > 0 ? cap : 1));
  if (!scratch) return -2;
  long total = encode_lane(starts, freqs, n, scale_bits, out, cap, scratch);
  free(scratch);
  return total;
}

// Batch encode: n_lanes INDEPENDENT symbol lanes packed into one flat
// (starts, freqs) pair; lane i spans [lane_offsets[i], lane_offsets[i+1])
// of the packed arrays and its stream lands at out + out_offsets[i]
// (per-lane capacity out_offsets[i+1] - out_offsets[i] — sized by each
// lane's own length, not the longest lane's) with its byte count in
// out_sizes[i]. One call per micro-batch: the whole loop runs in C with
// the GIL dropped (ctypes releases it for the call), so an entropy-pool
// thread coding a batch no longer serializes the other pool threads'
// Python framing. Streams are byte-identical to n_lanes separate
// rans_encode calls (each lane is a self-contained coder run).
// Returns 0 on success, -(i+1) if lane i overflowed its capacity (the
// Python side retries that lane with a doubled cap, coding/rans.py),
// or -(n_lanes+1) if the scratch allocation failed (OOM: never
// retried with MORE memory).
long rans_encode_batch(const uint32_t* starts, const uint32_t* freqs,
                       const long* lane_offsets, long n_lanes,
                       int scale_bits, uint8_t* out,
                       const long* out_offsets, long* out_sizes) {
  long max_cap = 1;
  for (long i = 0; i < n_lanes; ++i) {
    long cap = out_offsets[i + 1] - out_offsets[i];
    if (cap > max_cap) max_cap = cap;
  }
  uint8_t* scratch = static_cast<uint8_t*>(malloc(max_cap));
  if (!scratch) return -(n_lanes + 1);
  for (long i = 0; i < n_lanes; ++i) {
    long off = lane_offsets[i];
    long n = lane_offsets[i + 1] - off;
    long cap = out_offsets[i + 1] - out_offsets[i];
    long total = encode_lane(starts + off, freqs + off, n, scale_bits,
                             out + out_offsets[i], cap, scratch);
    if (total < 0) { free(scratch); return -(i + 1); }
    out_sizes[i] = total;
  }
  free(scratch);
  return 0;
}

void* rans_decoder_new(const uint8_t* data, long size) {
  if (size < 4) return nullptr;
  Decoder* d = new Decoder;
  d->data = data;
  d->size = size;
  d->state = static_cast<uint32_t>(data[0]) |
             (static_cast<uint32_t>(data[1]) << 8) |
             (static_cast<uint32_t>(data[2]) << 16) |
             (static_cast<uint32_t>(data[3]) << 24);
  d->pos = 4;
  return d;
}

// Cumulative-frequency value of the next symbol (caller maps it to a symbol
// via its cumulative table, then calls rans_decoder_advance).
uint32_t rans_decoder_peek(void* handle, int scale_bits) {
  Decoder* d = static_cast<Decoder*>(handle);
  return d->state & ((1u << scale_bits) - 1);
}

void rans_decoder_advance(void* handle, uint32_t start, uint32_t freq,
                          int scale_bits) {
  Decoder* d = static_cast<Decoder*>(handle);
  uint32_t mask = (1u << scale_bits) - 1;
  uint64_t x = static_cast<uint64_t>(freq) * (d->state >> scale_bits) +
               (d->state & mask) - start;
  while (x < kRansL && d->pos < d->size) {
    x = (x << 8) | d->data[d->pos++];
  }
  d->state = static_cast<uint32_t>(x);
}

void rans_decoder_free(void* handle) {
  delete static_cast<Decoder*>(handle);
}

// Shared decode loop: n symbols, the i-th resolved against the cumulative
// table at cums + i*cum_stride (stride 0 = one static table for all;
// stride num_syms+1 = a fresh adaptive table per symbol).
static void decode_n(Decoder* d, const uint32_t* cums, long cum_stride,
                     int num_syms, long n, int scale_bits, int32_t* out) {
  uint32_t mask = (1u << scale_bits) - 1;
  for (long i = 0; i < n; ++i) {
    const uint32_t* cum = cums + i * cum_stride;
    uint32_t cf = d->state & mask;
    // linear scan: num_syms is small (L=6 centers)
    int s = num_syms - 1;
    for (int j = 1; j <= num_syms; ++j) {
      if (cum[j] > cf) { s = j - 1; break; }
    }
    out[i] = s;
    uint64_t x = static_cast<uint64_t>(cum[s + 1] - cum[s]) *
                     (d->state >> scale_bits) +
                 cf - cum[s];
    while (x < kRansL && d->pos < d->size) {
      x = (x << 8) | d->data[d->pos++];
    }
    d->state = static_cast<uint32_t>(x);
  }
}

// Batched decode of n symbols that all share one frequency table
// (cum: scale-sorted cumulative array of length num_syms+1, cum[num_syms] =
// 1<<scale_bits). Writes symbol indices to out. Used for header-less bulk
// payloads with static tables; the adaptive path peeks/advances per symbol.
void rans_decode_static(void* handle, const uint32_t* cum, int num_syms,
                        long n, int scale_bits, int32_t* out) {
  decode_n(static_cast<Decoder*>(handle), cum, 0, num_syms, n, scale_bits,
           out);
}

// Batched decode of n symbols where EVERY symbol has its own frequency
// table (cums: n rows of num_syms+1 cumulative values, row-major) — the
// adaptive-model hot path. One call replaces n Python-level peek/advance
// round trips per wavefront.
void rans_decode_front(void* handle, const uint32_t* cums, long n,
                       int num_syms, int scale_bits, int32_t* out) {
  decode_n(static_cast<Decoder*>(handle), cums, num_syms + 1, num_syms, n,
           scale_bits, out);
}

// Batch front decode across n_lanes INDEPENDENT streams: lane i's
// decoder advances k_i = lane_offsets[i+1] - lane_offsets[i] symbols,
// the j-th resolved against its own adaptive cumulative table (cums
// rows packed in lane order, num_syms+1 values per row; out shares the
// lane_offsets layout). One call replaces n_lanes rans_decode_front
// round trips per wavefront — the serve entropy stage's decode loop
// over a micro-batch stays in C with the GIL dropped. Per-lane results
// are identical to separate rans_decode_front calls (lanes share no
// state). Empty lanes (k_i = 0) are legal and advance nothing.
void rans_decode_batch(void** handles, const uint32_t* cums,
                       const long* lane_offsets, long n_lanes,
                       int num_syms, int scale_bits, int32_t* out) {
  for (long i = 0; i < n_lanes; ++i) {
    long off = lane_offsets[i];
    long k = lane_offsets[i + 1] - off;
    decode_n(static_cast<Decoder*>(handles[i]),
             cums + off * (num_syms + 1), num_syms + 1, num_syms, k,
             scale_bits, out + off);
  }
}

}  // extern "C"
