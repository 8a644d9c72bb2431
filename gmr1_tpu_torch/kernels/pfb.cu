// PFB analysis branch filter: planar wideband block -> packed-real DFT
// activation of the 2x-oversampled M-channel analysis bank.
//
// Replaces the TPU kernel gmr1_tpu/ops/pallas_pfb.py `_kernel` (wrapper
// `branch_filter_slab`).  For component c, branch half a, row r and
// lane b (hop = M/2 lanes, no padding):
//
//   a2[r, c*2hop + a*hop + b] = sum_{u=0}^{2P} wa[a(2P+1)+u, b] * z_c[r+u, b]
//
// where z_c[j, b] = x[j*hop + b, c] is the planar (N, 2) block read in
// place as (rows, hop, 2): the TPU's slab transpose and 128-lane padding
// have no counterpart here.  The commutator's lane reversal is folded
// into `wa` (channelizer/pfb.py slab_weights); the channel DFT that
// follows is one dense f32 matrix product outside the kernel.
//
// Only P of the 2P+1 taps of each half are non-zero (slab_weights): tap k
// of half a sits at u = off + 2k with off = (1 - a) + (b == 0)
// (tests/test_torch_pfb.py compact_taps states the same rule).  The kernel
// loads those 2P taps once into registers and drops the zero terms; the
// non-zero terms keep the dense loop's order, so each sum is the dense
// sum.  Lane 0 is the other lanes' code reading its column one row
// lower.
//
// What bounds it: device-memory bytes.  Every input sample is read once
// and every output written once: (R + 2P) * hop * 8 B in and
// R * 4hop * 4 B out, 261 MB at M=1088/P=10/R=20000 (0.078 ms at
// 3.35 TB/s) against 4P multiply-adds a (row, lane), 0.87 GFLOP
// (0.013 ms at 67 TFLOP/s).  The design keeps enough bytes in flight and
// reads each byte once:
//   * persistent row walks: a CTA owns a 64-lane strip and walks a long
//     run of rows (grid = the SMs' resident CTAs), so the 2P-row halo is
//     read once a run, not once a tile;
//   * a 128-row ring of 16-row tiles in shared memory (64 KB), filled by
//     16-byte cp.async (8-byte when hop is odd or the block unaligned),
//     seven tiles issued ahead: the loads of tiles k+H+1..k+7 overlap
//     the FMAs of tile k (H = ceil(2P / 16) halo tiles);
//   * each thread owns one lane and 8 consecutive output rows: each
//     ring row it reads (8 + 2P - 1 per 8 rows) feeds every output that
//     needs it, so shared-memory traffic stays under 2x the global bytes
//     even at P = 19;
//   * stores: each warp store writes one whole 128-byte line (32 lanes x
//     4 B of one (c, a) quarter of the row).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 64;                // lanes of a CTA's strip
constexpr int kRB = 8;                    // output rows a thread
constexpr int kRG = 2;                    // row groups a CTA
constexpr int kThreads = kLanes * kRG;    // 128
constexpr int kTR = kRB * kRG;            // rows a tile (16)
constexpr int kRing = 128;                // ring rows (a power of two)
constexpr int kTiles = kRing / kTR;       // 8
constexpr int kAhead = kTiles - 1;        // tiles issued ahead (7)
constexpr size_t kSmem = sizeof(float2) * kRing * kLanes;   // 64 KB
constexpr int kMaxP = 24;

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 8 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Issue input tile t of this CTA (ring rows t*kTR .. t*kTR + kTR - 1 of
// the run starting at global row r0) into its ring slot; rows at or past
// `rows_in` and lanes at or past hop are zero-filled.
__device__ __forceinline__ void load_tile(float2* zs, const float2* x,
                                          int t, int r0, int rows_in,
                                          int lane0, int hop, bool vec16) {
  const int tid = threadIdx.x;
  const int rel0 = t * kTR;
  float2* slot = zs + (rel0 & (kRing - 1)) * kLanes;
  if (vec16) {                    // 16 B = two lanes a copy
#pragma unroll
    for (int e = 0; e < kTR * kLanes / 2 / kThreads; ++e) {
      const int idx = tid + e * kThreads;
      const int i = idx / (kLanes / 2);
      const int l = 2 * (idx % (kLanes / 2));
      const int row = r0 + rel0 + i;
      const bool ok = row < rows_in && lane0 + l < hop;
      const float2* src =
          ok ? x + static_cast<size_t>(row) * hop + lane0 + l : x;
      cp_async16(slot + i * kLanes + l, src, ok);
    }
  } else {
#pragma unroll
    for (int e = 0; e < kTR * kLanes / kThreads; ++e) {
      const int idx = tid + e * kThreads;
      const int i = idx / kLanes;
      const int l = idx % kLanes;
      const int row = r0 + rel0 + i;
      const bool ok = row < rows_in && lane0 + l < hop;
      const float2* src =
          ok ? x + static_cast<size_t>(row) * hop + lane0 + l : x;
      cp_async8(slot + i * kLanes + l, src, ok);
    }
  }
}

template <int P>
__global__ void __launch_bounds__(kThreads)
branch_filter_kernel(const float2* __restrict__ x,
                     const float* __restrict__ wa, float* __restrict__ a2,
                     int R, int hop, int rows_per, bool vec16) {
  constexpr int kH = (2 * P + kTR - 1) / kTR;     // halo tiles
  static_assert(kAhead >= kH + 1, "ring too small for this P");
  extern __shared__ float2 zs[];                  // [kRing][kLanes]

  const int lane = threadIdx.x % kLanes;
  const int rg = threadIdx.x / kLanes;
  const int lane0 = blockIdx.x * kLanes;
  const int b = lane0 + lane;
  const bool live = b < hop;
  const int r0 = blockIdx.y * rows_per;
  const int n_out = min(rows_per, R - r0);
  if (n_out <= 0) return;                         // whole CTA
  const int rows_in = R + 2 * P;                  // rows the caller gives
  const int t_in = (n_out + 2 * P + kTR - 1) / kTR;
  const int t_out = (n_out + kTR - 1) / kTR;

  for (int t = 0; t < kAhead; ++t) {
    if (t < t_in) load_tile(zs, x, t, r0, rows_in, lane0, hop, vec16);
    cp_async_commit();
  }

  // the lane's non-zero taps: half a, tap k at u = (1 - a) + d + 2k
  const int d = b == 0;
  float w0[P], w1[P];
#pragma unroll
  for (int k = 0; k < P; ++k) {
    w0[k] = live ? __ldg(wa + static_cast<size_t>(1 + d + 2 * k) * hop + b)
                 : 0.f;
    w1[k] = live ? __ldg(wa + static_cast<size_t>(2 * P + 1 + d + 2 * k) *
                                  hop + b)
                 : 0.f;
  }

  for (int k = 0; k < t_out; ++k) {
    cp_async_wait<kAhead - 1 - kH>();   // tiles k .. k + kH have landed
    __syncthreads();                    // ... for every thread, and the
                                        // slot of tile k - 1 is free
    if (k + kAhead < t_in)
      load_tile(zs, x, k + kAhead, r0, rows_in, lane0, hop, vec16);
    cp_async_commit();

    const int rr = k * kTR + rg * kRB;            // first output row (rel)
    const int base = rr + d;
    float2 acc0[kRB], acc1[kRB];                  // .x = c 0, .y = c 1
#pragma unroll
    for (int i = 0; i < kRB; ++i) {
      acc0[i] = make_float2(0.f, 0.f);
      acc1[i] = make_float2(0.f, 0.f);
    }
#pragma unroll
    for (int j = 0; j < kRB + 2 * P - 1; ++j) {
      const float2 z = zs[((base + j) & (kRing - 1)) * kLanes + lane];
#pragma unroll
      for (int i = 0; i < kRB; ++i) {
        const int u1 = j - i;                     // half 1: u = 2k
        if (u1 >= 0 && u1 % 2 == 0 && u1 / 2 < P) {
          acc1[i].x = fmaf(w1[u1 / 2], z.x, acc1[i].x);
          acc1[i].y = fmaf(w1[u1 / 2], z.y, acc1[i].y);
        }
        const int u0 = j - i - 1;                 // half 0: u = 1 + 2k
        if (u0 >= 0 && u0 % 2 == 0 && u0 / 2 < P) {
          acc0[i].x = fmaf(w0[u0 / 2], z.x, acc0[i].x);
          acc0[i].y = fmaf(w0[u0 / 2], z.y, acc0[i].y);
        }
      }
    }
    if (live) {
#pragma unroll
      for (int i = 0; i < kRB; ++i) {
        if (rr + i < n_out) {
          float* o = a2 + static_cast<size_t>(r0 + rr + i) * 4 * hop + b;
          o[0] = acc0[i].x;
          o[hop] = acc1[i].x;
          o[2 * hop] = acc0[i].y;
          o[3 * hop] = acc1[i].y;
        }
      }
    }
  }
  cp_async_wait<0>();
}

template <int P>
int launch(const float* x, const float* wa, float* a2, int R, int hop,
           cudaStream_t stream) {
  static int resident = 0;            // CTAs of this P an SM holds
  static int sms = 0;
  if (resident == 0) {
    cudaError_t e = cudaFuncSetAttribute(
        branch_filter_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kSmem));
    if (e != cudaSuccess) return static_cast<int>(e);
    int dev = 0;
    e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &resident, branch_filter_kernel<P>, kThreads, kSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (resident < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const int strips = (hop + kLanes - 1) / kLanes;
  // one wave of persistent CTAs: each walks rows_per rows of its strip
  const int want = (sms * resident + strips - 1) / strips;
  const int rows_per = (((R + want - 1) / want) + kTR - 1) / kTR * kTR;
  const dim3 grid(strips, (R + rows_per - 1) / rows_per);
  const bool vec16 = hop % 2 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  branch_filter_kernel<P><<<grid, kThreads, kSmem, stream>>>(
      reinterpret_cast<const float2*>(x), wa, a2, R, hop, rows_per, vec16);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: planar (>= (R + 2P) * hop, 2) float32, 8-byte aligned; wa:
// (2 * (2P + 1), hop) float32; a2: (R, 4 * hop) float32; 1 <= P <= 24
// (p2 = 2P).  Returns a cudaError_t.
extern "C" int gmr1_pfb_branch_filter(const float* x, const float* wa,
                                      float* a2, int R, int hop, int p2,
                                      void* stream) {
  if (R < 0 || hop < 1 || p2 < 2 || p2 % 2 || p2 / 2 > kMaxP)
    return static_cast<int>(cudaErrorInvalidValue);
  if (R == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (p2 / 2) {
#define GMR1_PFB_CASE(p) \
  case p:                \
    return launch<p>(x, wa, a2, R, hop, st);
    GMR1_PFB_CASE(1) GMR1_PFB_CASE(2) GMR1_PFB_CASE(3) GMR1_PFB_CASE(4)
    GMR1_PFB_CASE(5) GMR1_PFB_CASE(6) GMR1_PFB_CASE(7) GMR1_PFB_CASE(8)
    GMR1_PFB_CASE(9) GMR1_PFB_CASE(10) GMR1_PFB_CASE(11) GMR1_PFB_CASE(12)
    GMR1_PFB_CASE(13) GMR1_PFB_CASE(14) GMR1_PFB_CASE(15) GMR1_PFB_CASE(16)
    GMR1_PFB_CASE(17) GMR1_PFB_CASE(18) GMR1_PFB_CASE(19) GMR1_PFB_CASE(20)
    GMR1_PFB_CASE(21) GMR1_PFB_CASE(22) GMR1_PFB_CASE(23) GMR1_PFB_CASE(24)
#undef GMR1_PFB_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
