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
// S = 128/256 (K=9, off the receiver's path): one thread per state in a
// 256-thread CTA, metrics double-buffered in shared memory with a CTA
// barrier a step, decisions bit-packed by ballot in shared memory and a
// one-thread-per-burst traceback.
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
// S = 128/256: one thread per state
// ---------------------------------------------------------------------

constexpr int kCta = 256;
constexpr int kMaxN = 5;                    // the widest code, K5_15 (TCH9 2k4)

template <int S>
__global__ void __launch_bounds__(kCta)
vit_cta_kernel(const float* __restrict__ sym, const float* __restrict__ sign,
               uint8_t* __restrict__ bits, float* __restrict__ metric,
               int B, int T, int n, int flush) {
  constexpr int G = kCta / S;               // bursts per CTA
  constexpr int W = S / 32;                 // decision words per step
  constexpr int HALF = S / 2;
  extern __shared__ uint32_t smem_cta[];
  float* m_cur = reinterpret_cast<float*>(smem_cta);
  float* m_nxt = m_cur + G * S;
  uint32_t* dec = smem_cta + 2 * G * S;     // [G][T][W]

  const int tid = threadIdx.x;
  const int g = tid / S;
  const int s = tid % S;
  const int lane = tid & 31;
  const int burst = blockIdx.x * G + g;
  const bool live = burst < B;

  // expected-sign rows of the two branches entering state s
  float sg0[kMaxN], sg1[kMaxN];
#pragma unroll
  for (int k = 0; k < kMaxN; ++k) {
    sg0[k] = k < n ? sign[s * n + k] : 0.f;
    sg1[k] = k < n ? sign[(s + S) * n + k] : 0.f;
  }
  m_cur[g * S + s] = (flush && s != 0) ? kNegInf : 0.f;
  __syncthreads();

  const float* xs = sym + static_cast<size_t>(live ? burst : 0) * T * n;
  uint32_t* dg = dec + static_cast<size_t>(g) * T * W;
  for (int t = 0; t < T; ++t) {
    float bm0 = 0.f, bm1 = 0.f;
#pragma unroll
    for (int k = 0; k < kMaxN; ++k) {
      if (k < n) {
        const float v = live ? __ldg(xs + t * n + k) : 0.f;
        bm0 = fmaf(sg0[k], v, bm0);
        bm1 = fmaf(sg1[k], v, bm1);
      }
    }
    const float* mc = m_cur + g * S;
    const float c0 = mc[s >> 1] + bm0;
    const float c1 = mc[(s >> 1) + HALF] + bm1;
    const bool d = c1 > c0;
    m_nxt[g * S + s] = d ? c1 : c0;
    const uint32_t bal = __ballot_sync(kFull, d);
    if (lane == 0) dg[t * W + (s >> 5)] = bal;
    __syncthreads();
    float* tmp = m_cur;
    m_cur = m_nxt;
    m_nxt = tmp;
  }

  if (s != 0 || !live) return;
  const float* mf = m_cur + g * S;
  int st = 0;
  float best = mf[0];
  if (!flush) {
    for (int k = 1; k < S; ++k) {
      if (mf[k] > best) {
        best = mf[k];
        st = k;
      }
    }
  }
  metric[burst] = best;
  uint8_t* out = bits + static_cast<size_t>(burst) * T;
  for (int t = T - 1; t >= 0; --t) {
    out[t] = static_cast<uint8_t>(st & 1);
    const uint32_t took = (dg[t * W + (st >> 5)] >> (st & 31)) & 1u;
    st = (st >> 1) | static_cast<int>(took * HALF);
  }
}

template <int S>
int launch_cta(const float* sym, const float* sign, uint8_t* bits,
               float* metric, int B, int T, int n, int flush,
               cudaStream_t stream) {
  constexpr int G = kCta / S;
  constexpr int W = S / 32;
  const size_t smem = sizeof(uint32_t) *
      (2 * static_cast<size_t>(G) * S + static_cast<size_t>(G) * T * W);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        vit_cta_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int grid = (B + G - 1) / G;
  vit_cta_kernel<S><<<grid, kCta, smem, stream>>>(sym, sign, bits, metric,
                                                  B, T, n, flush);
  return static_cast<int>(cudaGetLastError());
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
    case 128: return launch_cta<128>(sym, sign, bits, metric, B, T, n, flush, st);
    case 256: return launch_cta<256>(sym, sign, bits, metric, B, T, n, flush, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
