"""Polyphase filterbank wideband channelizer.

Counterpart of gmr1_tpu/channelizer/pfb.py (on-grid sample rates):

  analysis     2x-oversampled M-channel PFB.  The branch filter is a
               2P+1-tap FIR down the rows of the hop-row view of the
               block (`branch_filter`: the hand-written kernel
               kernels/pfb.cu on the card, the plain FIR on the CPU),
               writing the packed-real DFT activation; the M-point
               channel transform is one dense float32 matrix product.
  arb resample 32-phase polyphase fractional resampler geometry (host
               numpy); the streamed receiver applies it as one dense
               per-frame window matrix.
  extraction   per-carrier channel select + RRC resample to sps x
               symbol rate (rx/wideband.py's ingest step).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .. import kernels
from . import filters
from .arfcn import BASE_BANDWIDTH, BASE_SYMRATE, align_freq

torch.backends.cuda.matmul.allow_tf32 = False   # the channel DFT is f32


# --------------------------------------------------------------------------
# PFB analysis
# --------------------------------------------------------------------------

def slab_weights(h_poly: np.ndarray, m: int, p: int, hop: int) -> np.ndarray:
    """(M, P) polyphase taps -> (2*(2P+1), hop) shift-weight table.

    Row a*(2P+1)+u holds the per-lane weight applied to row r+u of the
    hop-row view when producing branch half a: lane b >= 1 carries
    channel q = a*hop + hop - b through shift s = u+1, lane 0 carries
    q = a*hop through s = u (gmr1_tpu/ops/pallas_pfb.py slab_weights
    without the TPU's 128-lane padding).
    """
    h = np.asarray(h_poly, np.float32)
    p2 = 2 * p
    wa = np.zeros((2 * (p2 + 1), hop), np.float32)

    def pp_of(s: int) -> int:
        return p - (s + (s & 1)) // 2

    for a in (0, 1):
        for u in range(p2 + 1):
            row = a * (p2 + 1) + u
            s = u + 1
            if 1 <= s <= p2 and (s & 1) == a:
                bp = np.arange(1, hop)
                wa[row, bp] = h[a * hop + (hop - bp), pp_of(s)]
            s = u
            if 1 <= s <= p2 and (s & 1) == a:
                wa[row, 0] = h[a * hop, pp_of(s)]
    return wa


@lru_cache(maxsize=None)
def dft_packed_slab(m: int, hop: int) -> np.ndarray:
    """(4*hop, 2M) channel-DFT matrix consuming the branch-filter output:
    row c*2hop + a*hop + b is the packed-real DFT row of component c,
    channel q = a*hop + ((hop - b) % hop).  a2 @ this = [yr | yi] per row
    (before the (-1)^{mr} sign flip)."""
    q_idx, k = np.meshgrid(np.arange(m), np.arange(m), indexing="ij")
    w = 2.0 * np.pi * q_idx * k / m
    br, bi = np.cos(w), np.sin(w)
    b2 = np.block([[br, bi], [-bi, br]]).astype(np.float32)   # (2M, 2M)
    out = np.zeros((4 * hop, 2 * m), np.float32)
    for c in (0, 1):
        for a in (0, 1):
            bp = np.arange(hop)
            q = a * hop + ((hop - bp) % hop)
            out[c * 2 * hop + a * hop + bp] = b2[c * m + q]
    return out


def branch_filter_plain(x, wa, r_cnt: int, hop: int):
    """Plain PyTorch branch filter (the kernel's reference):
    a2[r, c*2hop + a*hop + b] = sum_u wa[a(2P+1)+u, b] * x[(r+u)*hop + b, c].
    x planar (>= (r_cnt + 2P)*hop, 2); wa (2(2P+1), hop) -> (R, 4hop)."""
    taps = wa.shape[0] // 2
    z = x[:(r_cnt + taps - 1) * hop].reshape(r_cnt + taps - 1, hop, 2)
    out = x.new_zeros((r_cnt, 2, 2, hop))                # (R, c, a, hop)
    for a in (0, 1):
        for u in range(taps):
            w = wa[a * taps + u]
            out[:, :, a] += (w[None, :, None] * z[u:u + r_cnt]).transpose(1, 2)
    return out.reshape(r_cnt, 4 * hop)


def _branch_filter_cuda(x, wa, r_cnt: int, hop: int):
    """Launch kernels/pfb.cu on CUDA tensors (raises on anything else)."""
    if not (x.is_cuda and wa.is_cuda):
        raise ValueError("the PFB kernel takes CUDA tensors")
    if x.dtype != torch.float32 or wa.dtype != torch.float32:
        raise TypeError("the PFB kernel takes float32 tensors")
    p2 = wa.shape[0] // 2 - 1
    if x.ndim != 2 or x.shape[1] != 2 or x.shape[0] < (r_cnt + p2) * hop \
            or wa.shape != (2 * (p2 + 1), hop):
        raise ValueError(f"bad PFB shapes x {tuple(x.shape)} "
                         f"wa {tuple(wa.shape)} R={r_cnt} hop={hop}")
    x, wa = x.contiguous(), wa.contiguous()
    fn = kernels.library("pfb")
    a2 = torch.empty((r_cnt, 4 * hop), dtype=torch.float32, device=x.device)
    err = fn(x.data_ptr(), wa.data_ptr(), a2.data_ptr(), r_cnt, hop, p2,
             kernels.stream_ptr())
    kernels.check(err, "pfb")
    branch_filter.launches += 1
    return a2


def branch_filter(x, wa, r_cnt: int, hop: int):
    """PFB branch filter: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if x.is_cuda:
        return _branch_filter_cuda(x, wa, r_cnt, hop)
    if x.device.type != "cpu":
        raise ValueError(f"no PFB branch filter for device {x.device}")
    return branch_filter_plain(x, wa, r_cnt, hop)


branch_filter.launches = 0      # kernel launches (CUDA path only)


class PFBAnalyzer:
    """M-channel 2x-oversampled analysis bank (float32 channel DFT)."""

    def __init__(self, n_chans: int, taps: np.ndarray,
                 chunk_frames: int = 8192):
        if n_chans % 2:
            raise ValueError("need even channel count")
        t = np.asarray(taps, np.float32)
        p = int(np.ceil(len(t) / n_chans))
        h = np.zeros(p * n_chans, np.float32)
        h[:len(t)] = t
        self._setup(h.reshape(p, n_chans).T.copy(), chunk_frames)

    @classmethod
    def from_numpy(cls, h_poly: np.ndarray,
                   chunk_frames: int = 8192) -> "PFBAnalyzer":
        """Analyzer from (M, P) polyphase taps, e.g. the JAX analyzer's
        np.asarray(h_poly)."""
        self = cls.__new__(cls)
        self._setup(np.asarray(h_poly, np.float32), chunk_frames)
        return self

    def _setup(self, h_poly: np.ndarray, chunk_frames: int) -> None:
        self.m, self.p = h_poly.shape
        self.hop = self.m // 2
        self.h_poly = h_poly
        self.wa_np = slab_weights(h_poly, self.m, self.p, self.hop)
        self.chunk_frames = chunk_frames
        self._dev: dict = {}

    def _tables(self, device):
        """(wa, dft matrix, row/channel parity) resident on `device`."""
        key = str(device)
        if key not in self._dev:
            m = self.m
            qpar = np.tile(np.arange(m) % 2, 2).astype(np.float32)
            self._dev[key] = (
                torch.as_tensor(self.wa_np, device=device),
                torch.as_tensor(dft_packed_slab(m, self.hop), device=device),
                torch.as_tensor(qpar, device=device))
        return self._dev[key]

    def block(self, xp):
        """Analyze one left-padded planar block (R*hop + p*m, 2) ->
        channels (R, M, 2)."""
        m, hop = self.m, self.hop
        r_cnt = (xp.shape[0] - self.p * m) // hop
        wa, dft, qpar = self._tables(xp.device)
        c2 = branch_filter(xp, wa, r_cnt, hop) @ dft        # (R, 2M)
        rpar = (torch.arange(r_cnt, device=xp.device) & 1).to(torch.float32)
        c2 = c2 * (1.0 - 2.0 * rpar[:, None] * qpar[None, :])
        return torch.stack([c2[:, :m], c2[:, m:]], dim=-1)

    def __call__(self, x):
        """Planar wideband (N, 2) -> channels (R, M, 2) at rate fs/(M/2)."""
        x = torch.as_tensor(x).to(torch.float32)
        xp = torch.cat([x.new_zeros((self.p * self.m, 2)), x])
        r_cnt = x.shape[0] // self.hop
        out = []
        for r0 in range(0, r_cnt, self.chunk_frames):
            r1 = min(r0 + self.chunk_frames, r_cnt)
            beg = r0 * self.hop
            need = (r1 - r0) * self.hop + self.p * self.m
            blk = xp[beg:beg + need]
            if blk.shape[0] < need:
                blk = torch.cat([blk, x.new_zeros((need - blk.shape[0], 2))])
            out.append(self.block(blk))
        return torch.cat(out) if len(out) > 1 else out[0]


# --------------------------------------------------------------------------
# Arbitrary polyphase resampler (host geometry)
# --------------------------------------------------------------------------

class ArbResampler:
    """Fractional-ratio polyphase resampler geometry
    (pfb.arb_resampler_ccf): branch taps and the gather / dense-matrix
    forms of one output window, all host numpy."""

    def __init__(self, ratio: float, taps: np.ndarray, n_phases: int = 32):
        t = np.asarray(taps, np.float32)
        tpb = int(np.ceil(len(t) / n_phases))
        h = np.zeros(tpb * n_phases, np.float32)
        h[:len(t)] = t
        # branch p taps h[p::L], applied to x[k], x[k-1], ...
        self._setup(ratio, h.reshape(tpb, n_phases).T.copy())

    @classmethod
    def from_branches(cls, ratio: float,
                      branches: np.ndarray) -> "ArbResampler":
        """Resampler from (L, tpb) branch taps, e.g. the JAX resampler's
        `branches`."""
        self = cls.__new__(cls)
        self._setup(ratio, np.asarray(branches, np.float32))
        return self

    def _setup(self, ratio: float, branches: np.ndarray) -> None:
        self.ratio = float(ratio)
        self.branches = branches                   # (L, tpb)
        self.l, self.tpb = branches.shape

    @lru_cache(maxsize=8)
    def _geometry(self, n_in: int):
        n_out = int(np.floor(n_in * self.ratio))
        n = np.arange(n_out, dtype=np.float64)
        up = n * self.l / self.ratio           # position in upsampled grid
        ip = np.floor(up).astype(np.int64)
        frac = (up - ip).astype(np.float32)
        k1, p1 = ip // self.l, ip % self.l
        k2, p2 = (ip + 1) // self.l, (ip + 1) % self.l
        return (n_out, k1.astype(np.int32), p1.astype(np.int32),
                k2.astype(np.int32), p2.astype(np.int32), frac)

    def window_geometry(self, out_start: int, n_out: int):
        """Gather geometry producing outputs [out_start, out_start+n_out)
        from the input slice [k_min, k_min + k_span).  Returns (k_min,
        k_span, k1r, p1, k2r, p2, frac)."""
        n = np.arange(out_start, out_start + n_out, dtype=np.float64)
        up = n * self.l / self.ratio
        ip = np.floor(up).astype(np.int64)
        frac = (up - ip).astype(np.float32)
        k1, p1 = ip // self.l, ip % self.l
        k2, p2 = (ip + 1) // self.l, (ip + 1) % self.l
        k_min = int(k1.min()) - self.tpb + 1
        if k_min < 0:
            raise ValueError(f"window starts before the input ({k_min})")
        k_span = int(k2.max()) - k_min + 1
        return (k_min, k_span, (k1 - k_min).astype(np.int32),
                p1.astype(np.int32), (k2 - k_min).astype(np.int32),
                p2.astype(np.int32), frac)

    def window_matrix(self, out_start: int, n_out: int):
        """Dense (n_out, k_span) resampling matrix: out = W @
        x[k_min : k_min + k_span].  Returns (k_min, W)."""
        k_min, k_span, k1r, p1, k2r, p2, frac = self.window_geometry(
            out_start, n_out)
        w = np.zeros((n_out, k_span), np.float32)
        i = np.arange(self.tpb)
        n = np.arange(n_out)
        br = self.branches
        np.add.at(w, (n[:, None], k1r[:, None] - i[None, :]),
                  br[p1] * (1.0 - frac)[:, None])
        np.add.at(w, (n[:, None], k2r[:, None] - i[None, :]),
                  br[p2] * frac[:, None])
        return k_min, w


# --------------------------------------------------------------------------
# Channelizer front-end (on-grid sample rates)
# --------------------------------------------------------------------------

class Channelizer:
    """Wideband capture -> channel bank at 2x the carrier spacing, plus
    the per-carrier RRC resampler (utils/gmr1_rx_sdr.py:391-602).  Only
    sample rates on the 31.25 kHz grid are supported so far (the JAX
    package's off-grid pre-resampler is not ported yet)."""

    def __init__(self, samp_rate: float, center_freq: float, sps: int = 4):
        self.samp_rate = samp_rate
        self.center_freq = center_freq
        self.sps = sps
        cw = BASE_BANDWIDTH
        mid = align_freq(center_freq)
        self.rotation = (2.0 * np.pi * (center_freq - mid) / samp_rate
                         if abs(mid - center_freq) > 200 else 0.0)
        self.pfb_center_freq = mid
        self.n_chans = (int(np.ceil(samp_rate / cw)) + 1) & ~1
        if abs((self.n_chans * cw) / samp_rate - 1.0) >= 1e-5:
            raise NotImplementedError(
                f"sample rate {samp_rate} is off the {cw:.0f} Hz channel "
                "grid (the off-grid pre-resampler is not ported yet)")
        taps = filters.low_pass(1.0, self.n_chans * cw, cw * 0.5, cw * 0.25)
        self.analyzer = PFBAnalyzer(self.n_chans, taps)
        self.chan_rate = 2.0 * cw                 # 2x oversampled
        self._resamplers: dict = {}

    def _rrc_resampler(self, width: int) -> ArbResampler:
        key = ("rrc", width)
        if key not in self._resamplers:
            sym = BASE_SYMRATE * width
            in_rate = self.chan_rate if width == 1 else sym * self.sps
            ratio = (sym * self.sps) / in_rate
            ntaps = int(11.0 * 32 * in_rate / sym)
            taps = filters.root_raised_cosine(32.0, 32.0 * in_rate, sym,
                                              0.35, ntaps)
            self._resamplers[key] = ArbResampler(ratio, taps)
        return self._resamplers[key]
