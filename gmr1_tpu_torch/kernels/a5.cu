// GMR-1 A5/1 keystream generator (reference src/l1/a5.c), batched over
// frame numbers that share one key.
//
// Not the port of a TPU kernel: it replaces the JAX package's lax.scan
// in gmr1_tpu/ops/a5.py `keystream`, which run eagerly would be about
// 1,630 dependent clock steps of some 15 small launches each for the
// 658-bit NT9 stream.  Same arithmetic, bit for bit: the key bytes
// swapped pairwise and mixed with the frame number (a5.c:233-241), 64
// forced clocks injecting key bits, the LSB of every register set, 250
// majority clocks, then nbits downlink and nbits uplink output bits.
//
// Design: one thread per frame number with the four LFSRs in registers
// (19/22/23/17 bits in uint32), parity by __popc.  What bounds it is the
// serial recurrence: 314 + 2*nbits dependent clocks a thread (1,630 at
// nbits = 658), and the output write, one byte a clock at a stride of
// nbits between threads, is uncoalesced.  The uplink half is skipped
// when the caller passes no ul buffer.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;   // small CTAs spread B~8k threads over the SMs

__device__ __forceinline__ uint32_t parity(uint32_t x) {
  return static_cast<uint32_t>(__popc(x)) & 1u;
}

// LFSR lengths 19/22/23/17 and feedback taps (a5.c:129-132)
template <int I>
__device__ __forceinline__ uint32_t clock_forced(uint32_t r) {
  constexpr uint32_t kMask =
      (1u << (I == 0 ? 19 : I == 1 ? 22 : I == 2 ? 23 : 17)) - 1u;
  constexpr uint32_t kTaps =
      I == 0 ? 0x072000u : I == 1 ? 0x311000u : I == 2 ? 0x660000u
                                                       : 0x013100u;
  return ((r << 1) & kMask) | parity(r & kTaps);
}

struct Regs {
  uint32_t r[4];

  __device__ __forceinline__ void clock_all_forced() {
    r[0] = clock_forced<0>(r[0]);
    r[1] = clock_forced<1>(r[1]);
    r[2] = clock_forced<2>(r[2]);
    r[3] = clock_forced<3>(r[3]);
  }

  // majority clocking by R4 bits 15, 6, 1 (a5.c:165-180)
  __device__ __forceinline__ void clock() {
    const uint32_t c0 = (r[3] >> 15) & 1u;
    const uint32_t c1 = (r[3] >> 6) & 1u;
    const uint32_t c2 = (r[3] >> 1) & 1u;
    const uint32_t m = (c0 + c1 + c2) >= 2u;
    if (c0 == m) r[0] = clock_forced<0>(r[0]);
    if (c1 == m) r[1] = clock_forced<1>(r[1]);
    if (c2 == m) r[2] = clock_forced<2>(r[2]);
    r[3] = clock_forced<3>(r[3]);
  }

  __device__ __forceinline__ static uint32_t maj3(uint32_t x, int a, int b,
                                                  int c) {
    return (((x >> a) & 1u) + ((x >> b) & 1u) + ((x >> c) & 1u)) >= 2u;
  }

  __device__ __forceinline__ uint8_t output() const {
    const uint32_t v = maj3(r[0], 1, 6, 15) ^ ((r[0] >> 11) & 1u) ^
                       maj3(r[1], 3, 8, 14) ^ ((r[1] >> 1) & 1u) ^
                       maj3(r[2], 4, 15, 19) ^ (r[2] & 1u);
    return static_cast<uint8_t>(v);
  }
};

__global__ void __launch_bounds__(kThreads)
a5_kernel(uint64_t key, const int64_t* __restrict__ fns,
          uint8_t* __restrict__ dl, uint8_t* __restrict__ ul, int B,
          int nbits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  const uint32_t fn = static_cast<uint32_t>(fns[i]);

  // key byte j of the SIM key is bits 8j..8j+7 of `key`; swap pairs
  uint32_t lkey[8];
  const int swap[8] = {1, 0, 3, 2, 5, 4, 7, 6};
#pragma unroll
  for (int j = 0; j < 8; ++j)
    lkey[j] = static_cast<uint32_t>((key >> (8 * swap[j])) & 0xffu);
  lkey[6] ^= (fn & 0x0000Fu) << 4;
  lkey[3] ^= (fn & 0x00030u) << 2;
  lkey[1] ^= (fn & 0x007C0u) >> 3;
  lkey[0] ^= (fn & 0x0F800u) >> 11;
  lkey[0] ^= (fn & 0x70000u) >> 11;

  Regs s;
#pragma unroll
  for (int j = 0; j < 4; ++j) s.r[j] = 0u;
#pragma unroll
  for (int k = 0; k < 64; ++k) {
    const uint32_t b = (lkey[k >> 3] >> (7 - (k & 7))) & 1u;
    s.clock_all_forced();
#pragma unroll
    for (int j = 0; j < 4; ++j) s.r[j] ^= b;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) s.r[j] |= 1u;
  for (int k = 0; k < 250; ++k) s.clock();

  uint8_t* out = dl + static_cast<size_t>(i) * nbits;
  for (int k = 0; k < nbits; ++k) {
    s.clock();
    out[k] = s.output();
  }
  if (ul == nullptr) return;
  out = ul + static_cast<size_t>(i) * nbits;
  for (int k = 0; k < nbits; ++k) {
    s.clock();
    out[k] = s.output();
  }
}

}  // namespace

// key: the 8 SIM key bytes, byte j in bits 8j..8j+7; fns (B,) int64
// frame numbers (the low 19 bits enter the key schedule); outputs dl
// and, when ul is not null, ul, each (B, nbits) uint8.  Returns a
// cudaError_t.
extern "C" int gmr1_a5_keystream(uint64_t key, const int64_t* fns,
                                 uint8_t* dl, uint8_t* ul, int B, int nbits,
                                 void* stream) {
  if (nbits < 1 || B < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  const int grid = (B + kThreads - 1) / kThreads;
  a5_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      key, fns, dl, ul, B, nbits);
  return static_cast<int>(cudaGetLastError());
}
