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
// Design: one thread per state, 256 threads per CTA, so a CTA carries
// 256/S bursts.  Path metrics are double-buffered in shared memory and
// the decisions are bit-packed there with one warp ballot per step
// (S/32 words a step, or one word shared by 32/S bursts), so the
// traceback runs in-kernel and decisions never reach device memory:
// 848 B per burst at K=5, T=212; 6.9 KB at K=9, T=216.  What bounds it
// is the serial trellis: T dependent steps with a CTA barrier each; the
// input read (B*T*n floats) and the output write are small.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCta = 256;
constexpr float kNegInf = -1e30f;

template <int S>
__global__ void __launch_bounds__(kCta)
vit_kernel(const float* __restrict__ sym, const float* __restrict__ sign,
           uint8_t* __restrict__ bits, float* __restrict__ metric,
           int B, int T, int n, int flush) {
  constexpr int G = kCta / S;               // bursts per CTA
  constexpr int W = S < 32 ? 1 : S / 32;    // decision words per step
  constexpr int HALF = S / 2;
  extern __shared__ uint32_t smem[];
  float* m_cur = reinterpret_cast<float*>(smem);
  float* m_nxt = m_cur + G * S;
  uint32_t* dec = smem + 2 * G * S;         // [G][T][W]

  const int tid = threadIdx.x;
  const int g = tid / S;
  const int s = tid % S;
  const int lane = tid & 31;
  const int burst = blockIdx.x * G + g;
  const bool live = burst < B;

  // expected-sign rows of the two branches entering state s
  float sg0[4], sg1[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
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
    for (int k = 0; k < 4; ++k) {
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
    const uint32_t bal = __ballot_sync(0xffffffffu, d);
    if (S < 32) {
      if (s == 0) dg[t] = (bal >> lane) & ((1u << (S & 31)) - 1u);
    } else if (lane == 0) {
      dg[t * W + (s >> 5)] = bal;
    }
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
int launch(const float* sym, const float* sign, uint8_t* bits,
           float* metric, int B, int T, int n, int flush,
           cudaStream_t stream) {
  constexpr int G = kCta / S;
  constexpr int W = S < 32 ? 1 : S / 32;
  const size_t smem = sizeof(uint32_t) *
      (2 * static_cast<size_t>(G) * S + static_cast<size_t>(G) * T * W);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        vit_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int grid = (B + G - 1) / G;
  vit_kernel<S><<<grid, kCta, smem, stream>>>(sym, sign, bits, metric, B,
                                               T, n, flush);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// sym (B, T, n) float32 integer-valued sbits, n <= 4; sign (2S, n)
// float32 expected signs (flat index 2*state + input bit); outputs
// bits (B, T) uint8 and metric (B,) float32.  Returns a cudaError_t.
extern "C" int gmr1_viterbi_decode(const float* sym, const float* sign,
                                   uint8_t* bits, float* metric, int B,
                                   int T, int n, int S, int flush,
                                   void* stream) {
  if (n < 1 || n > 4 || T < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (S) {
    case 16: return launch<16>(sym, sign, bits, metric, B, T, n, flush, st);
    case 32: return launch<32>(sym, sign, bits, metric, B, T, n, flush, st);
    case 64: return launch<64>(sym, sign, bits, metric, B, T, n, flush, st);
    case 128: return launch<128>(sym, sign, bits, metric, B, T, n, flush, st);
    case 256: return launch<256>(sym, sign, bits, metric, B, T, n, flush, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
