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
// What bounds it: one frame number is one serial recurrence of 250 +
// nbits (+ nbits for the uplink) majority clocks, and the receiver's
// batch (8512 frame numbers) is small: one thread a frame number (this
// kernel's first form) is 266 warps, half a warp for each of the card's 528
// schedulers, and each warp issues some 45 instructions a clock (three
// gated LFSR clocks and the output filter) with little to overlap.
// Measured: that form spends 0.066 ms of its 0.154 ms on the generator
// and the rest on its strided byte stores (H100, a store-free variant).
// The output itself (5.6 MB at 8512 x 658) is 0.0017 ms of bandwidth.
// So the instruction stream of a clock sets the time; the design cuts
// it per thread and writes whole lines:
//
//  * Four lanes a frame number.  Lanes 0, 1 and 2 each run one of R1,
//    R2, R3 and its share of the output filter, maj(3 taps) ^ tap, on
//    their own (a gated clock and a filter term: about 14 instructions a
//    step instead of 45); lane 3 repeats lane 0's work and contributes
//    nothing.  Every 32 clocks the lanes pack their 32 filter bits in a
//    word and XOR the four words together by two shuffles.  The 8512
//    frame numbers become 1064 warps, two on most schedulers.
//  * R4 off the critical path.  R4 clocks on every step and depends on
//    nothing else, so it is a bit stream s_t = s_{t-17} ^ s_{t-14} ^
//    s_{t-13} ^ s_{t-9}; 32 steps of it come from four word-wide steps
//    on a 64-bit window, and the three "clock Ri" decisions of the next
//    32 steps become three 32-bit masks (majority by bit logic).  The
//    per-step loop reads one mask bit.
//  * Key schedule in closed form.  The 64 forced clocks are linear over
//    GF(2): the state they leave is the key's state XOR the state delta
//    of every set frame-number bit.  The host computes both (the deltas
//    do not depend on the key), and each lane XORs the deltas its frame
//    number selects into its register and R4, then sets the LSBs.
//  * Coalesced output.  The XORed words go into a shared-memory tile
//    laid out (frame number, word).  A CTA's 32 rows are contiguous in
//    the output (32 * nbits bytes, a multiple of 16), so the CTA then
//    expands the tile to bytes and writes the whole region in 16-byte
//    vectors, consecutive threads on consecutive vectors (16 bits to 16
//    bytes by a funnel shift and four multiplies); a vector that spans
//    two rows or the region's end is written byte by byte.  The uplink
//    reuses the tile after the downlink is written.
// The uplink half is skipped when the caller passes no ul buffer.
//
// What bounds it now (H100 80GB HBM3): 0.031 ms at 8512 x 658 dl only,
// 0.0106 ms at one frame number.  The slope over nbits at one frame
// number is about 21 clocks a step, the issue time of one lane's step
// (the gated shifts of the filter bits and the word packing), and the
// 266 CTAs leave 2 of the 132 SMs a third CTA, whose three warps a
// scheduler then set the time: still the instruction stream, not the
// bytes (0.0017 ms) or the serial chain (0.008 ms).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 4;                 // lanes a frame number
constexpr int kRows = 32;                 // frame numbers a CTA
constexpr int kThreads = kLanes * kRows;  // 128
constexpr int kMix = 250;      // majority clocks before the first output
constexpr int kFnBits = 19;    // frame-number bits mixed into the key

// LFSR lengths 19/22/23/17 and feedback taps (a5.c:129-132)
__host__ __device__ constexpr uint32_t reg_mask(int k) {
  return (1u << (k == 0 ? 19 : k == 1 ? 22 : k == 2 ? 23 : 17)) - 1u;
}
__host__ __device__ constexpr uint32_t reg_taps(int k) {
  return k == 0 ? 0x072000u : k == 1 ? 0x311000u : k == 2 ? 0x660000u
                                                         : 0x013100u;
}

// The start state of every frame number: the 4 registers after the 64
// forced clocks are base ^ (XOR of delta[j] over the set fn bits j).
struct Schedule {
  uint32_t base[4];
  uint32_t delta[kFnBits][4];
};

// One of R1-R3 as its bit stream u, and R4 as its own.
//
// R (length L, feedback taps p) is the window e with bit k = u_{k-L+1}
// for the current clock count 0: bits 0..L-1 are the register
// reversed (register bit j is u_{-j}), and bits L..L+7 the next 8
// feedback bits, which depend on bits below L only (every tap p >= 12:
// u_m = XOR_p u_{m-1-p}, so one word step XORs e << (1 + p)).  After c
// more clocks register bit j is u_{c-j} = e bit c + L - 1 - j, so the
// filter bit maj(r_ta, r_tb, r_tc) ^ r_td of every count c = 0..8 is
// bit c of one word built from four shifts of e: a clock of the
// register is a shift of that word by one, and the window moves on by
// the 8 steps' clock count.
//
// R4 is the window x with bit k = s_{t-16+k} for the current step t
// (bits 0..16; R4 bit j is s_{t-j}), so R4's clock-control bits 15, 6
// and 1 at step t + i are bits i + 1, i + 10 and i + 15 of the window
// grown 32 steps ahead.
struct Lane {
  uint32_t e, low, future;     // window; masks of bits < L and L..L+7
  uint32_t s0, s1, s2, s3;     // 1 + each feedback tap
  uint32_t fa, fb, fc, fd;     // L - 1 - each filter tap
  int ctl;                     // this register's clock-control bit of R4
  uint64_t x;

  __device__ __forceinline__ void advance(uint32_t c) {
    const uint32_t w = (e >> c) & low;
    e = w | (((w << s0) ^ (w << s1) ^ (w << s2) ^ (w << s3)) & future);
  }

  // Run n <= 32 majority clocks (n = 32 when Full); this register's
  // filter bit after clock i lands in bit i of the returned word (bits
  // past n are not defined).
  template <bool Emit, bool Full>
  __device__ __forceinline__ uint32_t run(int n) {
    uint64_t v = x;
#pragma unroll
    for (int valid = 17; valid < 53; valid += 9) {
      const uint64_t y = v ^ (v >> 3) ^ (v >> 4) ^ (v >> 8);
      v |= (y << 17) & (0x1FFull << valid);
    }
    const uint32_t c0 = static_cast<uint32_t>(v >> 1);
    const uint32_t c1 = static_cast<uint32_t>(v >> 10);
    const uint32_t c2 = static_cast<uint32_t>(v >> 15);
    const uint32_t m = (c0 & c1) | (c0 & c2) | (c1 & c2);
    uint32_t k = ~(static_cast<uint32_t>(v >> ctl) ^ m);
    if (!Full) k &= n >= 32 ? ~0u : (1u << n) - 1u;
    x = (v >> (Full ? 32 : n)) & 0x1FFFFull;
    uint32_t word = 0u;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const uint32_t g = (k >> (8 * w)) & 0xFFu;
      if (Emit) {
        uint32_t o = (e >> fa) & (e >> fb);
        o |= ((e >> fa) | (e >> fb)) & (e >> fc);
        o ^= e >> fd;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          if (g & (1u << i)) o >>= 1;
          word |= (o & 1u) << (8 * w + i);
        }
      }
      advance(__popc(g));
    }
    return word;
  }
};

// Expand the tile's rows (bit k of row r: bit k % 32 of word
// tile[r * stride + k / 32]) to one byte a bit over the CTA's contiguous
// region out[0, rows * nbits), 16 bytes a thread a store.
__device__ __forceinline__ void write_rows(const uint32_t* tile, int stride,
                                           int rows, int nbits,
                                           uint8_t* __restrict__ out) {
  const int total = rows * nbits;
  for (int p = threadIdx.x * 16; p < total; p += kThreads * 16) {
    const int row = p / nbits;
    const int bit = p - row * nbits;
    const uint32_t* w = tile + row * stride + (bit >> 5);
    if (bit + 16 <= nbits) {                 // inside one row
      const uint32_t b16 = __funnelshift_r(w[0], w[1], bit & 31);
      uint32_t q[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)            // bit k of a nibble -> byte k
        q[j] = (((b16 >> (4 * j)) & 0xFu) * 0x00204081u) & 0x01010101u;
      *reinterpret_cast<uint4*>(out + p) = make_uint4(q[0], q[1], q[2], q[3]);
    } else {                                 // spans rows or ends the region
      const int cnt = min(16, total - p);
      int r = row, k = bit;
      for (int j = 0; j < cnt; ++j) {
        out[p + j] = static_cast<uint8_t>(
            (tile[r * stride + (k >> 5)] >> (k & 31)) & 1u);
        if (++k == nbits) {
          k = 0;
          ++r;
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
a5_kernel(Schedule sched, const int64_t* __restrict__ fns,
          uint8_t* __restrict__ dl, uint8_t* __restrict__ ul, int B,
          int nbits, int stride) {
  extern __shared__ uint32_t tile[];       // [kRows][stride] + 1 word
  const int f = threadIdx.x / kLanes;      // row within the CTA
  const int q = threadIdx.x % kLanes;      // 0-2: R1-R3; 3 repeats R1
  const int reg = q == 3 ? 0 : q;
  const int row0 = blockIdx.x * kRows;
  const int i = row0 + f;
  const int rows = min(kRows, B - row0);
  const int nwords = (nbits + 31) >> 5;

  // rows past B run frame number 0 so that every lane takes the shuffles
  const uint32_t fn = i < B ? static_cast<uint32_t>(fns[i]) : 0u;
  uint32_t r = 0u, r4 = 0u;
#pragma unroll
  for (int k = 0; k < 3; ++k)
    if (reg == k) r = sched.base[k];
  r4 = sched.base[3];
#pragma unroll
  for (int j = 0; j < kFnBits; ++j) {
    const uint32_t sel = 0u - ((fn >> j) & 1u);
    const uint32_t d = reg == 0 ? sched.delta[j][0]
                     : reg == 1 ? sched.delta[j][1] : sched.delta[j][2];
    r ^= d & sel;
    r4 ^= sched.delta[j][3] & sel;
  }
  // per register: length, feedback taps (a5.c:129-132) and the output
  // filter's taps: R1 1,6,15 ^ 11; R2 3,8,14 ^ 1; R3 4,15,19 ^ 0
  const uint32_t len = reg == 0 ? 19 : reg == 1 ? 22 : 23;
  const uint32_t p0 = reg == 0 ? 13 : reg == 1 ? 12 : 17;
  const uint32_t p1 = reg == 0 ? 16 : reg == 1 ? 16 : 18;
  const uint32_t p2 = reg == 0 ? 17 : reg == 1 ? 20 : 21;
  const uint32_t p3 = reg == 0 ? 18 : reg == 1 ? 21 : 22;
  const uint32_t ta = reg == 0 ? 1 : reg == 1 ? 3 : 4;
  const uint32_t tb = reg == 0 ? 6 : reg == 1 ? 8 : 15;
  const uint32_t tc = reg == 0 ? 15 : reg == 1 ? 14 : 19;
  const uint32_t td = reg == 0 ? 11 : reg == 1 ? 1 : 0;
  Lane g;
  g.low = (1u << len) - 1u;
  g.future = 0xFFu << len;
  g.s0 = 1 + p0;
  g.s1 = 1 + p1;
  g.s2 = 1 + p2;
  g.s3 = 1 + p3;
  g.fa = len - 1 - ta;
  g.fb = len - 1 - tb;
  g.fc = len - 1 - tc;
  g.fd = len - 1 - td;
  g.ctl = reg == 0 ? 1 : reg == 1 ? 10 : 15;
  g.e = __brev(r | 1u) >> (32 - len);          // bit L-1-j = register bit j
  g.advance(0);
  g.x = (__brev(r4 | 1u) >> 15) & 0x1FFFFu;   // bit k = R4 bit 16 - k
  for (int s = 0; s < kMix - 32; s += 32) g.run<false, true>(32);
  g.run<false, false>(kMix % 32);

  for (int half = 0; half < 2; ++half) {
    uint8_t* out = half == 0 ? dl : ul;
    if (out == nullptr) break;
    for (int w = 0; w < nwords; ++w) {
      uint32_t word = 32 * w + 32 <= nbits
                          ? g.run<true, true>(32)
                          : g.run<true, false>(nbits - 32 * w);
      if (q == 3) word = 0u;
      word ^= __shfl_xor_sync(0xffffffffu, word, 1);
      word ^= __shfl_xor_sync(0xffffffffu, word, 2);
      if (q == 0) tile[f * stride + w] = word;
    }
    __syncthreads();
    write_rows(tile, stride, rows, nbits,
               out + static_cast<size_t>(row0) * nbits);
    __syncthreads();                      // the tile is reused for ul
  }
}

// --- host side: the closed-form key schedule --------------------------------

uint32_t host_clock_forced(uint32_t r, int k) {
  return ((r << 1) & reg_mask(k)) |
         (static_cast<uint32_t>(__builtin_popcount(r & reg_taps(k))) & 1u);
}

// The registers after the 64 forced clocks that inject the bits of the
// 8 mixed key bytes lkey (a5.c:243-252), before the LSBs are set.
void load_key(const uint8_t lkey[8], uint32_t r[4]) {
  for (int k = 0; k < 4; ++k) r[k] = 0u;
  for (int i = 0; i < 64; ++i) {
    const uint32_t b = (lkey[i >> 3] >> (7 - (i & 7))) & 1u;
    for (int k = 0; k < 4; ++k) r[k] = host_clock_forced(r[k], k) ^ b;
  }
}

// The frame-number mix of a5.c:233-241 on the swapped key bytes.
void mix_fn(uint8_t lkey[8], uint32_t fn) {
  lkey[6] ^= static_cast<uint8_t>((fn & 0x0000Fu) << 4);
  lkey[3] ^= static_cast<uint8_t>((fn & 0x00030u) << 2);
  lkey[1] ^= static_cast<uint8_t>((fn & 0x007C0u) >> 3);
  lkey[0] ^= static_cast<uint8_t>((fn & 0x0F800u) >> 11);
  lkey[0] ^= static_cast<uint8_t>((fn & 0x70000u) >> 11);
}

Schedule fn_deltas() {
  Schedule s{};
  for (int j = 0; j < kFnBits; ++j) {
    uint8_t z[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    mix_fn(z, 1u << j);
    load_key(z, s.delta[j]);
  }
  return s;
}

Schedule make_schedule(uint64_t key) {
  static const Schedule deltas = fn_deltas();     // the same for every key
  static const int swap[8] = {1, 0, 3, 2, 5, 4, 7, 6};
  Schedule s = deltas;
  uint8_t lkey[8];
  for (int j = 0; j < 8; ++j)
    lkey[j] = static_cast<uint8_t>(key >> (8 * swap[j]));
  load_key(lkey, s.base);
  return s;
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
  const int stride = ((nbits + 31) >> 5) | 1;   // odd: conflict-free stores
  // one word past the last row: the funnel shift may read it
  const size_t smem = sizeof(uint32_t) * (kRows * stride + 1);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = (B + kRows - 1) / kRows;
  a5_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      make_schedule(key), fns, dl, ul, B, nbits, stride);
  return static_cast<int>(cudaGetLastError());
}
