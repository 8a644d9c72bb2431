// Radix-2 soft-decision Viterbi decoder for every GMR-1 trellis
// (S = 16/32/64/128/256 states), flush or tail-biting termination.
//
// Replaces the TPU kernel gmr1_tpu/ops/pallas_viterbi.py `_vit_kernel`
// (wrapper `decode_trellis`).  Same arithmetic, bit for bit: branch
// metrics sign(2S, n) . sym_t(n), ACS c0 = m[s>>1] + bm[s],
// c1 = m[(s>>1) + S/2] + bm[S+s], dec = c1 > c0, float32 metrics with the
// -1e30 flush sentinel (every sum of integer sbits is exact below 2^24),
// first-max argmax for tail-biting, traceback bit = s&1,
// s = (s>>1) | dec*S/2.
//
// What bounds it: at the receiver's batches, the bytes (B*T*n f32
// symbols in, B*T bit bytes out: 12.2 MB, 0.0036 ms at 3.35 TB/s for the
// CCCH batch B=6384, T=212); for one burst (the per-carrier receiver),
// the serial chain of T dependent add-compare-select steps.  The design
// below takes the chain off shared memory and barriers; at the large
// batches its per-step instruction stream, not the bytes, sets the time
// (PERF.md).  Two designs:
//
// S <= 64 (K=5 and the K=7 TCH3 speech code, the main path): warp-
// synchronous, no __syncthreads and no shared memory on the step chain.
// A lane holds two states, s and s + S/2, so a warp carries 64/S bursts
// (four at K=5, one at K=7) and S/2 lanes serve a burst.  The path
// metrics live in registers; the four predecessor metrics of a lane's
// two states come from four __shfl_sync; each step's two decision
// ballots (one word for the states below S/2, one above) stay in the
// register of lane t % 32 and go to a per-warp shared buffer every 32
// steps.  Symbols arrive 32 steps at a time, coalesced (the next chunk's
// loads are in flight while this one decodes), and reach the burst's
// lanes by shuffle.  Several independent warps share a CTA.  The
// traceback runs one lane per burst over the shared decision words; the
// bits go through shared memory and leave coalesced.  Tail-biting picks
// the first maximum: a lane prefers its lower state on ties, and the
// butterfly reduction prefers the lower state index.
//
// S = 128/256 (K=9: DC12's K9_13 tail-biting decode, off the receivers'
// path): one warp a burst and one burst a CTA, no CTA barrier.  Lane l
// holds the metrics of its butterflies i = 4l .. 4l+3 (two at S = 128),
// m[i] and m[i + S/2], in registers and makes their new states 2i and
// 2i+1; the new metrics go through a warp-private shared buffer (four
// floats of padding every 32 states keep it free of bank conflicts) with
// one __syncwarp a step.  The burst's symbols are staged in shared memory
// by cp.async before the first step.  Every GMR-1 generator taps both
// ends of the register, so a butterfly's four branch metrics are +-one
// dot product (the kernel checks the table; another table takes four).
// Each step's S/32 ballot words go to shared memory; state s is bit s/8
// of word s%8 (s/4, s%4 at S = 128), so the one-lane traceback knows a
// word's address four steps ahead and takes it from a register ring.
// Tail-biting takes the first maximum by an xor-shuffle butterfly that
// prefers the lower state.  B CTAs of 32 threads; about 12.5 KB of
// shared memory a CTA at T = 208 leaves 17 resident a multiprocessor, so
// B = 1064 and 2048 run in one wave.  Its time is its per-step
// instruction stream (about 74 instructions a warp a step at n = 3), not
// memory.  Two and four warps a burst, with a CTA barrier a step, were
// slower at both batches a path decodes (PERF.md).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

// ---------------------------------------------------------------------
// S <= 64: warp-synchronous
// ---------------------------------------------------------------------

constexpr int kWarps = 4;                 // independent warps a CTA

__host__ __device__ constexpr size_t warp_smem(int T, int G) {
  // decision words (uint2 a step, T rounded up to 32 steps) + G*T bits
  return static_cast<size_t>((T + 31) / 32) * 32 * sizeof(uint2) +
         (static_cast<size_t>(G) * T + 15) / 16 * 16;
}

template <int S, int N>
__global__ void __launch_bounds__(kWarps * 32)
vit_warp_kernel(const float* __restrict__ sym,
                const float* __restrict__ sign, uint8_t* __restrict__ bits,
                float* __restrict__ metric, int B, int T, int flush) {
  constexpr int L = S / 2;                // lanes a burst
  constexpr int G = 32 / L;               // bursts a warp
  constexpr int NV = 32 * N / L;          // symbol floats a lane a chunk
  extern __shared__ __align__(16) uint8_t smem[];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane / L;
  const int lam = lane % L;
  const int gbase = g * L;
  const int burst0 = (blockIdx.x * kWarps + warp) * G;
  if (burst0 >= B) return;                // whole warp
  const int burst = burst0 + g;
  const bool live = burst < B;
  const int n_ch = (T + 31) / 32;
  uint2* dec = reinterpret_cast<uint2*>(smem + warp * warp_smem(T, G));
  uint8_t* tb = reinterpret_cast<uint8_t*>(dec + n_ch * 32);

  // expected signs of the two branches into state lam (A) and lam+L (B)
  float gA0[N], gA1[N], gB0[N], gB1[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    gA0[k] = __ldg(sign + lam * N + k);
    gA1[k] = __ldg(sign + (S + lam) * N + k);
    gB0[k] = __ldg(sign + (lam + L) * N + k);
    gB1[k] = __ldg(sign + (S + lam + L) * N + k);
  }
  float mA = (flush && lam != 0) ? kNegInf : 0.f;
  float mB = flush ? kNegInf : 0.f;
  // predecessors: lam -> (lam>>1, lam>>1 + L) both held by lane srcA;
  // lam + L -> (L/2 + lam>>1, its + L) both held by lane srcB
  const int srcA = gbase + (lam >> 1);
  const int srcB = gbase + L / 2 + (lam >> 1);

  const float* xs = sym + static_cast<size_t>(live ? burst : burst0) * T * N;
  const int n_sym = T * N;
  float cur[NV], nxt[NV];
#pragma unroll
  for (int e = 0; e < NV; ++e) {
    const int q = lam + L * e;
    cur[e] = (live && q < n_sym) ? __ldg(xs + q) : 0.f;
  }
  uint32_t kA = 0, kB = 0;
  for (int c = 0; c < n_ch; ++c) {
    const int q0 = (c + 1) * 32 * N;      // next chunk, in flight
#pragma unroll
    for (int e = 0; e < NV; ++e) {
      const int q = q0 + lam + L * e;
      nxt[e] = (live && q < n_sym) ? __ldg(xs + q) : 0.f;
    }
    // one trellis step; tau is a constant once the loops below unroll
    auto step = [&](const int tau) {
      float bmA0 = 0.f, bmA1 = 0.f, bmB0 = 0.f, bmB1 = 0.f;
#pragma unroll
      for (int k = 0; k < N; ++k) {
        const int q = tau * N + k;
        const float v = __shfl_sync(kFull, cur[q / L], gbase + q % L);
        bmA0 = fmaf(gA0[k], v, bmA0);
        bmA1 = fmaf(gA1[k], v, bmA1);
        bmB0 = fmaf(gB0[k], v, bmB0);
        bmB1 = fmaf(gB1[k], v, bmB1);
      }
      const float pAa = __shfl_sync(kFull, mA, srcA);
      const float pBa = __shfl_sync(kFull, mB, srcA);
      const float pAb = __shfl_sync(kFull, mA, srcB);
      const float pBb = __shfl_sync(kFull, mB, srcB);
      const float c0A = pAa + bmA0, c1A = pBa + bmA1;
      const float c0B = pAb + bmB0, c1B = pBb + bmB1;
      const bool dA = c1A > c0A;
      const bool dB = c1B > c0B;
      mA = dA ? c1A : c0A;
      mB = dB ? c1B : c0B;
      const uint32_t wA = __ballot_sync(kFull, dA);
      const uint32_t wB = __ballot_sync(kFull, dB);
      if (lane == tau) {
        kA = wA;
        kB = wB;
      }
    };
    const int steps = T - c * 32;
    if (steps >= 32) {                    // a whole chunk: no step guard
#pragma unroll
      for (int tau = 0; tau < 32; ++tau) step(tau);
    } else {
#pragma unroll
      for (int tau = 0; tau < 32; ++tau)
        if (tau < steps) step(tau);
    }
    dec[c * 32 + lane] = make_uint2(kA, kB);
#pragma unroll
    for (int e = 0; e < NV; ++e) cur[e] = nxt[e];
  }

  // final state: state 0 (flush) or the first maximum (tail-biting)
  float best = mA;
  int st = lam;
  if (flush) {
    best = __shfl_sync(kFull, mA, gbase);
    st = 0;
  } else {
    if (mB > best) {
      best = mB;
      st = lam + L;
    }
#pragma unroll
    for (int off = L / 2; off >= 1; off >>= 1) {
      const float ob = __shfl_xor_sync(kFull, best, off);
      const int os = __shfl_xor_sync(kFull, st, off);
      if (ob > best || (ob == best && os < st)) {
        best = ob;
        st = os;
      }
    }
  }
  __syncwarp();
  if (lam == 0 && live) {
    metric[burst] = best;
    uint8_t* out = tb + g * T;
    for (int t = T - 1; t >= 0; --t) {
      out[t] = static_cast<uint8_t>(st & 1);
      const uint2 w = dec[t];
      const uint32_t word = st < L ? w.x : w.y;
      const int took = (word >> (gbase + (st & (L - 1)))) & 1u;
      st = (st >> 1) | (took * L);
    }
  }
  __syncwarp();
  // the warp's live bursts are G*T contiguous bytes of `bits`
  const int n_b = min(G, B - burst0) * T;
  uint8_t* dst = bits + static_cast<size_t>(burst0) * T;
  if (reinterpret_cast<uintptr_t>(dst) % 4 == 0 && n_b % 4 == 0) {
    const uint32_t* s4 = reinterpret_cast<const uint32_t*>(tb);
    uint32_t* d4 = reinterpret_cast<uint32_t*>(dst);
    for (int i = lane; i < n_b / 4; i += 32) d4[i] = s4[i];
  } else {
    for (int i = lane; i < n_b; i += 32) dst[i] = tb[i];
  }
}

template <int S, int N>
int launch_warp(const float* sym, const float* sign, uint8_t* bits,
                float* metric, int B, int T, int flush, cudaStream_t stream) {
  constexpr int G = 64 / S;
  const size_t smem = kWarps * warp_smem(T, G);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        vit_warp_kernel<S, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int grid = (B + G * kWarps - 1) / (G * kWarps);
  vit_warp_kernel<S, N><<<grid, kWarps * 32, smem, stream>>>(
      sym, sign, bits, metric, B, T, flush);
  return static_cast<int>(cudaGetLastError());
}

template <int S>
int launch_warp_n(const float* sym, const float* sign, uint8_t* bits,
                  float* metric, int B, int T, int n, int flush,
                  cudaStream_t st) {
  switch (n) {
    case 1: return launch_warp<S, 1>(sym, sign, bits, metric, B, T, flush, st);
    case 2: return launch_warp<S, 2>(sym, sign, bits, metric, B, T, flush, st);
    case 3: return launch_warp<S, 3>(sym, sign, bits, metric, B, T, flush, st);
    case 4: return launch_warp<S, 4>(sym, sign, bits, metric, B, T, flush, st);
    case 5: return launch_warp<S, 5>(sym, sign, bits, metric, B, T, flush, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---------------------------------------------------------------------
// S = 128/256: radix-2 butterflies, metrics in registers
// ---------------------------------------------------------------------

constexpr int kMaxN = 5;                    // the widest code, K5_15 (TCH9 2k4)

// shared-memory index of state s in the metric exchange buffer: four
// floats of padding every 32 states keep both the lanes' reads of R
// consecutive states and their writes of 2R consecutive states free of
// bank conflicts
__host__ __device__ constexpr int pad_idx(int s) { return s + (s >> 5) * 4; }

__host__ __device__ constexpr int sym_pad(int n) { return n <= 4 ? 4 : 8; }

__host__ __device__ constexpr size_t bfly_smem(int S, int T, int n) {
  // metric exchange [2][pad_idx(S)] f32, symbols [T][sym_pad(n)] f32,
  // decision words [T][S/32], traceback bits [T] u8
  return sizeof(float) * (2 * static_cast<size_t>(pad_idx(S)) +
                          static_cast<size_t>(T) * sym_pad(n)) +
         sizeof(uint32_t) * static_cast<size_t>(T) * (S / 32) +
         (static_cast<size_t>(T) + 15) / 16 * 16;
}

template <bool B>
struct Tag {
  static constexpr bool value = B;
};

// a 4-byte global -> shared copy that does not hold the thread
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

template <int N, int NP>
__device__ __forceinline__ float dot(const float (&g)[N], const float (&v)[NP]) {
  float acc = g[0] * v[0];
#pragma unroll
  for (int k = 1; k < N; ++k) acc = fmaf(g[k], v[k], acc);
  return acc;
}

// Lane l of the burst's warp owns the R butterflies i = i0 .. i0+R-1,
// i0 = R l: it holds m[i] and m[i + S/2] and makes the new states 2i and
// 2i+1, that is the 2R = NW states NW l + j.  So the ballot of register j
// is decision word j of the step and its bit l is state NW l + j: state s
// is bit s / NW of word s % NW.
template <int S, int N>
__global__ void __launch_bounds__(32)
vit_bfly_kernel(const float* __restrict__ sym, const float* __restrict__ sign,
                uint8_t* __restrict__ bits, float* __restrict__ metric,
                int T, int flush) {
  constexpr int HALF = S / 2;
  constexpr int NW = S / 32;                // decision words a step
  constexpr int LNW = NW == 8 ? 3 : 2;
  constexpr int R = HALF / 32;              // butterflies a lane
  constexpr int NP = sym_pad(N);
  constexpr int MP = pad_idx(S);
  static_assert(NW == 4 || NW == 8, "S = 128 or 256");
  extern __shared__ __align__(16) uint8_t smem[];
  float* mb = reinterpret_cast<float*>(smem);                  // [2][MP]
  float* xs = mb + 2 * MP;                                      // [T][NP]
  uint32_t* dec = reinterpret_cast<uint32_t*>(xs + T * NP);     // [T][NW]
  uint8_t* tb = reinterpret_cast<uint8_t*>(dec + T * NW);       // [T]

  const int burst = blockIdx.x;
  const int lane = threadIdx.x;
  const int i0 = R * lane;

  // the burst's symbols, staged before the first step by asynchronous
  // copies that are all in flight at once: no global load waits inside
  // the step loop
  const float* xg = sym + static_cast<size_t>(burst) * T * N;
  for (int q = lane; q < T * NP; q += 32) {
    const int t = q / NP, k = q % NP;
    if (k < N) {
      cp_async4(xs + q, xg + t * N + k);
    } else {
      xs[q] = 0.f;
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");

  // expected signs of the four branches of each butterfly: g00 i -> 2i
  // (row 2i), g10 i+S/2 -> 2i (row S+2i), g01 i -> 2i+1, g11 i+S/2 -> 2i+1
  float g00[R][N], g01[R][N], g10[R][N], g11[R][N];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int s2 = 2 * (i0 + r);
#pragma unroll
    for (int k = 0; k < N; ++k) {
      g00[r][k] = __ldg(sign + s2 * N + k);
      g01[r][k] = __ldg(sign + (s2 + 1) * N + k);
      g10[r][k] = __ldg(sign + (S + s2) * N + k);
      g11[r][k] = __ldg(sign + (S + s2 + 1) * N + k);
    }
  }
  // Every GMR-1 generator taps both ends of the register, so a
  // butterfly's four branches carry +-one word: g01 = g10 = -g00, g11 =
  // g00.  The warp holds every butterfly; where the whole table has this
  // form one dot product a butterfly serves all four branches (the
  // negated sums are exact: integer sbits).
  bool anti = true;
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      anti &= (g01[r][k] == -g00[r][k]) & (g10[r][k] == -g00[r][k]) &
              (g11[r][k] == g00[r][k]);
    }
  }
  anti = __all_sync(kFull, anti);

  float m0[R], m1[R];                       // m[i0 + r], m[i0 + r + S/2]
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m0[r] = (flush && i0 + r != 0) ? kNegInf : 0.f;
    m1[r] = flush ? kNegInf : 0.f;
  }
  __syncwarp();

  auto run = [&](auto tag) {
    constexpr bool ANTI = decltype(tag)::value;
    float* const dst0 = mb + pad_idx(2 * i0);
    const float* const s00 = mb + pad_idx(i0);
    const float* const s10 = mb + pad_idx(i0 + HALF);
    uint32_t* dt = dec;
    auto step = [&](int t, int par) {
      float v[NP];
#pragma unroll
      for (int c = 0; c < NP; c += 4) {     // one broadcast load a 4 floats
        const float4 x4 = *reinterpret_cast<const float4*>(xs + t * NP + c);
        v[c] = x4.x;
        v[c + 1] = x4.y;
        v[c + 2] = x4.z;
        v[c + 3] = x4.w;
      }
      float nm[2 * R];
      uint32_t dw[2 * R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float b00 = dot<N, NP>(g00[r], v);
        const float b10 = ANTI ? -b00 : dot<N, NP>(g10[r], v);
        const float b01 = ANTI ? -b00 : dot<N, NP>(g01[r], v);
        const float b11 = ANTI ? b00 : dot<N, NP>(g11[r], v);
        const float c0e = m0[r] + b00, c1e = m1[r] + b10;   // into 2i
        const float c0o = m0[r] + b01, c1o = m1[r] + b11;   // into 2i+1
        const bool de = c1e > c0e;
        const bool dd = c1o > c0o;
        nm[2 * r] = de ? c1e : c0e;
        nm[2 * r + 1] = dd ? c1o : c0o;
        dw[2 * r] = __ballot_sync(kFull, de);
        dw[2 * r + 1] = __ballot_sync(kFull, dd);
      }
      float* dst = dst0 + par * MP;
#pragma unroll
      for (int c = 0; c < 2 * R; c += 4)
        *reinterpret_cast<float4*>(dst + c) =
            make_float4(nm[c], nm[c + 1], nm[c + 2], nm[c + 3]);
      if (lane == 0) {
#pragma unroll
        for (int c = 0; c < 2 * R; c += 4)
          *reinterpret_cast<uint4*>(dt + c) =
              make_uint4(dw[c], dw[c + 1], dw[c + 2], dw[c + 3]);
      }
      dt += NW;
      __syncwarp();
      const float* s0 = s00 + par * MP;
      const float* s1 = s10 + par * MP;
      if constexpr (R == 4) {
        const float4 a = *reinterpret_cast<const float4*>(s0);
        const float4 b = *reinterpret_cast<const float4*>(s1);
        m0[0] = a.x; m0[1] = a.y; m0[2] = a.z; m0[3] = a.w;
        m1[0] = b.x; m1[1] = b.y; m1[2] = b.z; m1[3] = b.w;
      } else {
        const float2 a = *reinterpret_cast<const float2*>(s0);
        const float2 b = *reinterpret_cast<const float2*>(s1);
        m0[0] = a.x; m0[1] = a.y;
        m1[0] = b.x; m1[1] = b.y;
      }
    };
    int t = 0;
    for (; t + 1 < T; t += 2) {             // two steps, both buffers
      step(t, 0);
      step(t + 1, 1);
    }
    if (t < T) step(t, 0);
  };
  if (anti) {
    run(Tag<true>{});
  } else {
    run(Tag<false>{});
  }

  // final state: state 0 (flush) or the first maximum (tail-biting): a
  // lane scans its states upward, then the lanes keep the lower state on
  // ties
  float best = m0[0];
  int st = flush ? 0 : i0;
  if (!flush) {
#pragma unroll
    for (int r = 1; r < R; ++r) {
      if (m0[r] > best) {
        best = m0[r];
        st = i0 + r;
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (m1[r] > best) {
        best = m1[r];
        st = i0 + HALF + r;
      }
    }
#pragma unroll
    for (int off = 16; off >= 1; off >>= 1) {
      const float ob = __shfl_xor_sync(kFull, best, off);
      const int os = __shfl_xor_sync(kFull, st, off);
      if (ob > best || (ob == best && os < st)) {
        best = ob;
        st = os;
      }
    }
  }

  // traceback, one lane: the word of step t is word s % NW of the state
  // after step t, whose low bits are known four steps ahead, so the
  // words arrive through a four-deep register ring off the chain
  if (lane == 0) {
    metric[burst] = best;
    auto word = [&](int t, int s) {
      return t >= 0 ? dec[t * NW + (s & (NW - 1))] : 0u;
    };
    uint32_t q0 = word(T - 1, st), q1 = word(T - 2, st >> 1);
    uint32_t q2 = word(T - 3, st >> 2), q3 = word(T - 4, st >> 3);
    for (int t = T - 1; t >= 0; --t) {
      tb[t] = static_cast<uint8_t>(st & 1);
      const uint32_t took = (q0 >> (st >> LNW)) & 1u;
      st = (st >> 1) | static_cast<int>(took * HALF);
      q0 = q1;
      q1 = q2;
      q2 = q3;
      q3 = word(t - 4, st >> 3);
    }
  }
  __syncwarp();
  uint8_t* out = bits + static_cast<size_t>(burst) * T;
  if (reinterpret_cast<uintptr_t>(out) % 4 == 0 && T % 4 == 0) {
    const uint32_t* s4 = reinterpret_cast<const uint32_t*>(tb);
    uint32_t* d4 = reinterpret_cast<uint32_t*>(out);
    for (int i = lane; i < T / 4; i += 32) d4[i] = s4[i];
  } else {
    for (int i = lane; i < T; i += 32) out[i] = tb[i];
  }
}

template <int S, int N>
int launch_bfly(const float* sym, const float* sign, uint8_t* bits,
                float* metric, int B, int T, int flush, cudaStream_t stream) {
  const size_t smem = bfly_smem(S, T, N);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        vit_bfly_kernel<S, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  vit_bfly_kernel<S, N><<<B, 32, smem, stream>>>(sym, sign, bits, metric, T,
                                                 flush);
  return static_cast<int>(cudaGetLastError());
}

template <int S>
int launch_bfly_n(const float* sym, const float* sign, uint8_t* bits,
                  float* metric, int B, int T, int n, int flush,
                  cudaStream_t st) {
  switch (n) {
    case 1: return launch_bfly<S, 1>(sym, sign, bits, metric, B, T, flush, st);
    case 2: return launch_bfly<S, 2>(sym, sign, bits, metric, B, T, flush, st);
    case 3: return launch_bfly<S, 3>(sym, sign, bits, metric, B, T, flush, st);
    case 4: return launch_bfly<S, 4>(sym, sign, bits, metric, B, T, flush, st);
    case 5: return launch_bfly<S, 5>(sym, sign, bits, metric, B, T, flush, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// sym (B, T, n) float32 integer-valued sbits, n <= 5; sign (2S, n)
// float32 expected signs (flat index 2*state + input bit); outputs
// bits (B, T) uint8 and metric (B,) float32.  Returns a cudaError_t.
extern "C" int gmr1_viterbi_decode(const float* sym, const float* sign,
                                   uint8_t* bits, float* metric, int B,
                                   int T, int n, int S, int flush,
                                   void* stream) {
  if (n < 1 || n > kMaxN || T < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (S) {
    case 16:
      return launch_warp_n<16>(sym, sign, bits, metric, B, T, n, flush, st);
    case 32:
      return launch_warp_n<32>(sym, sign, bits, metric, B, T, n, flush, st);
    case 64:
      return launch_warp_n<64>(sym, sign, bits, metric, B, T, n, flush, st);
    case 128:
      return launch_bfly_n<128>(sym, sign, bits, metric, B, T, n, flush, st);
    case 256:
      return launch_bfly_n<256>(sym, sign, bits, metric, B, T, n, flush, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
