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
// Design: a CTA owns 64 lanes x 32 output rows.  Each thread stages its
// own lane's (32 + 2P)-row window of z (both components, one float2 a
// row) in shared memory once, then forms the four outputs of each row
// from it.  The kernel is bound by device-memory traffic: every input
// sample is read once (plus the 2P-row halo of each tile) and every
// output written once, 1.5x the input bytes in all.
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 64;
constexpr int kRows = 32;

__global__ void __launch_bounds__(kLanes)
branch_filter_kernel(const float2* __restrict__ x,
                     const float* __restrict__ wa, float* __restrict__ a2,
                     int R, int hop, int p2) {
  extern __shared__ float2 zs[];          // [(kRows + p2)][kLanes]
  const int b = blockIdx.x * kLanes + threadIdx.x;
  const int r0 = blockIdx.y * kRows;
  if (b >= hop) return;                   // each thread reads only its lane
  const int rows = min(kRows, R - r0);
  for (int j = 0; j < rows + p2; ++j)
    zs[j * kLanes + threadIdx.x] =
        x[static_cast<size_t>(r0 + j) * hop + b];
  for (int r = 0; r < rows; ++r) {
    float* o = a2 + static_cast<size_t>(r0 + r) * 4 * hop + b;
    for (int a = 0; a < 2; ++a) {
      const float* w = wa + static_cast<size_t>(a) * (p2 + 1) * hop + b;
      float re = 0.f, im = 0.f;
      for (int u = 0; u <= p2; ++u) {
        const float wu = __ldg(w + static_cast<size_t>(u) * hop);
        const float2 z = zs[(r + u) * kLanes + threadIdx.x];
        re = fmaf(wu, z.x, re);
        im = fmaf(wu, z.y, im);
      }
      o[a * hop] = re;
      o[2 * hop + a * hop] = im;
    }
  }
}

}  // namespace

// x: planar (>= (R + p2) * hop, 2) float32; wa: (2 * (p2 + 1), hop)
// float32; a2: (R, 4 * hop) float32.  Returns a cudaError_t.
extern "C" int gmr1_pfb_branch_filter(const float* x, const float* wa,
                                      float* a2, int R, int hop, int p2,
                                      void* stream) {
  if (R < 0 || hop < 1 || p2 < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (R == 0) return 0;
  const size_t smem = sizeof(float2) * (kRows + p2) * kLanes;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        branch_filter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((hop + kLanes - 1) / kLanes, (R + kRows - 1) / kRows);
  branch_filter_kernel<<<grid, kLanes, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float2*>(x), wa, a2, R, hop, p2);
  return static_cast<int>(cudaGetLastError());
}
