"""Polyphase filterbank wideband channelizer.

Counterpart of gmr1_tpu/channelizer/pfb.py:

  analysis     2x-oversampled M-channel PFB.  The branch filter is a
               2P+1-tap FIR down the rows of the hop-row view of the
               block (`branch_filter`: the hand-written kernel
               kernels/pfb.cu on the card, the plain FIR on the CPU),
               writing the packed-real DFT activation; the M-point
               channel transform is one dense matrix product
               (`channel_dft`): on the card with bf16 operands and
               float32 accumulation and output by default (JAX's
               `dft_bf16`, its main path on its own chip), in float32
               everywhere else.
  arb resample 32-phase polyphase fractional resampler (linear phase
               interpolation, pfb.arb_resampler_ccf): host geometry, and
               tap-by-tap gathers on the device; the streamed receiver
               applies the per-carrier RRC as one dense per-frame window
               matrix.
  pre-resample off-grid sample rates land on the 31.25 kHz grid through
               the exact-rational period matrix of the pre-resampler
               (`StreamPreResampler`: one 2-D GEMM a block).
  extraction   per-carrier channel select + RRC resample to sps x symbol
               rate; wide carriers (2/3/5 subchannels) rotate-and-sum at
               the output rate with the subchannels' delays matched
               (`Channelizer.sub_phases`; `Channelizer.extract`, and its
               streamed form `WideStreamer`).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .. import checked_device, kernels
from ..ops import cplx
from ..ops.consts import upload
from ..trace import span
from . import filters
from .arfcn import BASE_BANDWIDTH, BASE_SYMRATE, Channel, align_freq

torch.backends.cuda.matmul.allow_tf32 = False   # the f32 channel DFT stays f32


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


PFB_KERNEL_MAX_P = 24     # kernels/pfb.cu instantiates P = 1..24


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
    if not 1 <= p2 // 2 <= PFB_KERNEL_MAX_P or p2 % 2:
        raise ValueError(f"the PFB kernel takes 1 <= P <= "
                         f"{PFB_KERNEL_MAX_P} taps a branch, not {p2 / 2}")
    x, wa = x.contiguous(), wa.contiguous()
    if x.data_ptr() % 8:
        raise ValueError("the PFB kernel reads x as float2 rows: it must "
                         "be 8-byte aligned")
    a2 = torch.empty((r_cnt, 4 * hop), dtype=torch.float32, device=x.device)
    kernels.launch("pfb", x.device, x.data_ptr(), wa.data_ptr(),
                   a2.data_ptr(), r_cnt, hop, p2)
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


def channel_dft_plain(a2, dft):
    """Plain version of the bf16 channel DFT: both operands rounded to
    bf16 (round to nearest even) and multiplied in float32.  A product of
    two bf16 values is exact in float32, so this differs from the card's
    bf16 product only in the order of the sums."""
    return a2.to(torch.bfloat16).float() @ dft.to(torch.bfloat16).float()


def channel_dft(a2, dft, bf16: bool):
    """The channel DFT product a2 (R, 4hop) @ dft (4hop, 2M) -> (R, 2M)
    float32 (gmr1_tpu/channelizer/pfb.py:71-78).  bf16: bf16 operands,
    float32 accumulation and output, one `mm` with out_dtype on a CUDA
    tensor (not a bf16-output product, which would round the bank), the
    plain version on the CPU; `dft` may already be the bf16 table.
    Otherwise the float32 product (TF32 off)."""
    if not bf16:
        return a2 @ dft
    if a2.is_cuda:
        return torch.mm(a2.to(torch.bfloat16), dft.to(torch.bfloat16),
                        out_dtype=torch.float32)
    return channel_dft_plain(a2, dft)


class PFBAnalyzer:
    """M-channel 2x-oversampled analysis bank.

    `dft_bf16` (JAX's default, and this one's) runs the channel DFT on the
    card with bf16 operands and float32 accumulation: operand rounding
    sits about -48 dB below the bank's RMS in JAX's estimate, far under a
    real capture's noise floor.  On the CPU the analysis computes the
    float32 product whatever it says, as JAX's non-TPU path does
    (gmr1_tpu/channelizer/pfb.py:164-175).  It is read at every call."""

    def __init__(self, n_chans: int, taps: np.ndarray,
                 chunk_frames: int = 8192, dft_bf16: bool = True):
        if n_chans % 2:
            raise ValueError("need even channel count")
        t = np.asarray(taps, np.float32)
        p = int(np.ceil(len(t) / n_chans))
        h = np.zeros(p * n_chans, np.float32)
        h[:len(t)] = t
        self._setup(h.reshape(p, n_chans).T.copy(), chunk_frames, dft_bf16)

    @classmethod
    def from_numpy(cls, h_poly: np.ndarray, chunk_frames: int = 8192,
                   dft_bf16: bool = True) -> "PFBAnalyzer":
        """Analyzer from (M, P) polyphase taps, e.g. the JAX analyzer's
        np.asarray(h_poly)."""
        self = cls.__new__(cls)
        self._setup(np.asarray(h_poly, np.float32), chunk_frames, dft_bf16)
        return self

    def _setup(self, h_poly: np.ndarray, chunk_frames: int,
               dft_bf16: bool) -> None:
        self.m, self.p = h_poly.shape
        self.hop = self.m // 2
        self.h_poly = h_poly
        self.wa_np = slab_weights(h_poly, self.m, self.p, self.hop)
        self.chunk_frames = chunk_frames
        self.dft_bf16 = dft_bf16
        self._dev: dict = {}

    def _tables(self, device):
        """(wa, f32 dft matrix, bf16 dft matrix, row/channel parity)
        resident on `device`."""
        key = str(device)
        if key not in self._dev:
            dev, m = torch.device(device), self.m
            dft = upload(dft_packed_slab(m, self.hop), dev)
            self._dev[key] = (
                upload(self.wa_np, dev), dft, dft.to(torch.bfloat16),
                upload(np.tile(np.arange(m) % 2, 2).astype(np.float32), dev))
        return self._dev[key]

    def block_packed(self, xp):
        """Analyze one left-padded planar block (R*hop + p*m, 2) -> the
        packed bank (R, 2M) = [yr | yi], the 2x-oversample sign applied
        (JAX's block_packed, without its 128-lane slab layout)."""
        m, hop = self.m, self.hop
        r_cnt = (xp.shape[0] - self.p * m) // hop
        wa, dft, dft16, qpar = self._tables(xp.device)
        bf16 = self.dft_bf16 and xp.is_cuda
        a2 = branch_filter(xp, wa, r_cnt, hop)
        with span("dft"):
            c2 = channel_dft(a2, dft16 if bf16 else dft, bf16)
        rpar = (torch.arange(r_cnt, device=xp.device) & 1).to(torch.float32)
        return c2 * (1.0 - 2.0 * rpar[:, None] * qpar[None, :])

    def block(self, xp):
        """Analyze one left-padded planar block (R*hop + p*m, 2) ->
        channels (R, M, 2)."""
        c2 = self.block_packed(xp)
        return torch.stack([c2[:, :self.m], c2[:, self.m:]], dim=-1)

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
# Arbitrary polyphase resampler
# --------------------------------------------------------------------------

class ArbResampler:
    """Fractional-ratio polyphase resampler (pfb.arb_resampler_ccf).

    Phase geometry is host numpy, precomputed per input length; device
    work is a gather and a weighted sum per tap, linear interpolation
    between adjacent polyphase branches."""

    def __init__(self, ratio: float, taps: np.ndarray | None = None,
                 n_phases: int = 32,
                 ratio_frac: tuple[int, int] | None = None):
        """ratio_frac: optional EXACT (num, den) with ratio = num/den,
        which enables the integer-exact periodic geometry
        (periodic_geometry / StreamPreResampler)."""
        if taps is None:
            # GNURadio default: lowpass at the slower side's Nyquist
            cutoff = 0.5 * min(1.0, float(ratio))
            taps = filters.low_pass_2(n_phases, n_phases, cutoff,
                                      0.2 * cutoff, 80, "blackmanharris")
        t = np.asarray(taps, np.float32)
        tpb = int(np.ceil(len(t) / n_phases))
        h = np.zeros(tpb * n_phases, np.float32)
        h[:len(t)] = t
        # branch p taps h[p::L], applied to x[k], x[k-1], ...
        self._setup(ratio, h.reshape(tpb, n_phases).T.copy(), ratio_frac)
        # group delay of the (symmetric) taps, in input samples
        self.delay = (len(t) - 1) / (2.0 * n_phases)

    @classmethod
    def from_branches(cls, ratio: float,
                      branches: np.ndarray) -> "ArbResampler":
        """Resampler from (L, tpb) branch taps, e.g. the JAX resampler's
        `branches`."""
        self = cls.__new__(cls)
        self._setup(ratio, np.asarray(branches, np.float32), None)
        return self

    def _setup(self, ratio: float, branches: np.ndarray,
               ratio_frac: tuple[int, int] | None) -> None:
        self.ratio = float(ratio)
        self.ratio_frac = None
        if ratio_frac is not None:
            num, den = ratio_frac
            g = int(np.gcd(num, den))
            self.ratio_frac = (num // g, den // g)
            if abs(self.ratio - num / den) >= 1e-9:
                raise ValueError(f"ratio {ratio} != {num}/{den}")
        self.branches = branches                   # (L, tpb)
        self.l, self.tpb = branches.shape
        self.delay = None                          # unknown taps

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

    def __call__(self, x):
        """Planar (..., N, 2) -> (..., floor(N*ratio), 2)."""
        x = cplx.tensor(x)
        _n_out, k1, p1, k2, p2, frac = self._geometry(x.shape[-2])
        # index k -> xp[k + tpb]; taps before the input read zeros
        xp = torch.cat([x.new_zeros((*x.shape[:-2], self.tpb, 2)), x],
                       dim=-2)
        return self.resample_window(xp, k1 + self.tpb, p1, k2 + self.tpb,
                                    p2, frac)

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

    def block_gather(self, n_out: int, hist: int):
        """Static gather geometry for STREAMED resampling: outputs
        [0, n_out) of every block, where the block's first input sample
        sits at index `hist` of rows_full = [carried history | new
        block].  Valid only when the resampling phase is block-periodic
        (n_out * l / ratio an integral multiple of l), so one geometry
        serves every block.  Feed to resample_window."""
        up_end = n_out * self.l / self.ratio
        if abs(up_end - round(up_end)) >= 1e-6 or round(up_end) % self.l:
            raise ValueError(f"{n_out} outputs are not block-periodic at "
                             f"ratio {self.ratio}")
        n = np.arange(n_out, dtype=np.float64)
        up = n * self.l / self.ratio
        ip = np.floor(up).astype(np.int64)
        frac = (up - ip).astype(np.float32)
        k1, p1 = ip // self.l + hist, ip % self.l
        k2, p2 = (ip + 1) // self.l + hist, (ip + 1) % self.l
        if k1.min() - self.tpb + 1 < 0:
            raise ValueError(f"history {hist} shorter than {self.tpb} taps")
        return (k1.astype(np.int32), p1.astype(np.int32),
                k2.astype(np.int32), p2.astype(np.int32), frac)

    def periodic_geometry(self):
        """EXACT periodic resampling geometry from the rational ratio.

        With ratio = num/den (reduced), the upsampled-grid position of
        output n is up(n) = n*L*den/num, so the (branch, fraction)
        geometry repeats every P = num outputs while the input advances
        exactly K = den samples: integer math, drift-free forever.
        Returns (P, K, W, B): out[q*P + phi] = W[phi] @ x[q*K + B :
        q*K + B + W.shape[1]] with zero-padding for x[<0]."""
        if self.ratio_frac is None:
            raise ValueError("the periodic geometry needs an exact "
                             "ratio_frac")
        num, den = self.ratio_frac
        p_out, k_in = num, den
        ll = self.l
        a = np.arange(p_out, dtype=np.int64) * ll * den
        ip = a // num
        frac = (a % num) / num
        k1, p1 = ip // ll, ip % ll
        k2, p2 = (ip + 1) // ll, (ip + 1) % ll
        b = int(k1.min()) - self.tpb + 1
        e = int(k2.max())
        w = np.zeros((p_out, e - b + 1), np.float32)
        i = np.arange(self.tpb)
        phi = np.arange(p_out)
        br = self.branches
        np.add.at(w, (phi[:, None], k1[:, None] - i[None, :] - b),
                  br[p1] * (1.0 - frac)[:, None])
        np.add.at(w, (phi[:, None], k2[:, None] - i[None, :] - b),
                  br[p2] * frac[:, None])
        return p_out, k_in, w, b

    def resample_window(self, xw, k1r, p1, k2r, p2, frac):
        """Resample a pre-sliced window (..., k_span, 2) with host
        geometry from window_geometry / block_gather: per tap i, one
        gather of x[k - i] weighted by branch tap i (tpb small gathers in
        place of one (n_out, tpb)-sized one); indices clamp into the
        window."""
        xw = cplx.tensor(xw)
        dev = xw.device
        last = xw.shape[-2] - 1
        br = torch.as_tensor(self.branches, device=dev)

        def tap(k, p):
            k = torch.as_tensor(k, dtype=torch.int64, device=dev)
            rows = br[torch.as_tensor(p, dtype=torch.int64, device=dev)]
            y = None
            for i in range(self.tpb):
                t = xw[..., torch.clamp(k - i, 0, last), :] \
                    * rows[:, i, None]
                y = t if y is None else y + t
            return y

        f = torch.as_tensor(frac, device=dev)[:, None]
        return tap(k1r, p1) * (1.0 - f) + tap(k2r, p2) * f


def _periodic_resample(x_rel, w_t, phi0: int, n_out: int, nq: int,
                      k_in: int):
    """x_rel (nq*k_in + k_span, 2) -> (n_out, 2) on-grid samples.

    Window q is x_rel[q*k_in : q*k_in + k_span], a strided view; the
    polyphase combine is ONE 2-D GEMM of the (2*nq, k_span) windows with
    the (k_span, P) transposed period matrix `w_t`, and phi0 (the period
    phase of the first output) picks the first output."""
    k_span, p_out = w_t.shape
    xw = x_rel.unfold(0, k_span, k_in)[:nq]             # (nq, 2, k_span)
    out = xw.reshape(2 * nq, k_span) @ w_t              # (2nq, P)
    out = out.view(nq, 2, p_out).transpose(1, 2).reshape(nq * p_out, 2)
    return out[phi0:phi0 + n_out]


class StreamPreResampler:
    """Block-streamed off-grid pre-resampler.

    Streams arbitrary-fs captures onto the 31.25 kHz channel grid in
    O(block) memory: the host carries only the raw-input tail, the
    device work per block is one GEMM with the exact-rational period
    matrix (ArbResampler.periodic_geometry), and the phase never drifts:
    integer bookkeeping replaces the reference flowgraph's
    fractional_resampler state (utils/gmr1_rx_sdr.py:411-417).

    `pull(n)` supplies raw planar float32 (m <= n signals EOF);
    produce_block() returns (on-grid (n_out, 2) tensor on `device`,
    n_valid), where n_valid < n_out flags the zero-padded tail after
    EOF."""

    P_MAX = 1 << 20     # period bound: integral-Hz rates stay tiny

    def __init__(self, rr: ArbResampler, n_out: int, pull,
                 device: str | torch.device = "cuda"):
        self.device = checked_device(device)
        p_out, k_in, w, b = rr.periodic_geometry()
        if p_out > self.P_MAX:
            raise ValueError(f"period {p_out} too large; use an "
                             "integral-Hz capture rate")
        self.p, self.k, self.b = p_out, k_in, b
        self.k_span = w.shape[1]
        self.n_out = n_out
        self.nq = n_out // p_out + 2
        self._w_t = torch.as_tensor(w.T.copy(), device=self.device)
        self._pull = pull
        self._n = 0                  # on-grid samples produced
        self._raw0 = 0               # abs raw index of _raw[0]
        self._raw = np.zeros((0, 2), np.float32)
        self._raw_end = None         # abs raw length once EOF is seen
        self.n_total = None          # total on-grid samples (at EOF)
        num, den = rr.ratio_frac
        self._num, self._den, self._l = num, den, rr.l

    def _ensure_raw(self, end_abs: int) -> None:
        """Grow the raw buffer to cover [..., end_abs)."""
        need = end_abs - (self._raw0 + self._raw.shape[0])
        if need <= 0 or self._raw_end is not None:
            return
        got = np.asarray(self._pull(need), np.float32)
        if got.shape[0]:
            self._raw = np.concatenate([self._raw, got]) \
                if self._raw.shape[0] else got
        if got.shape[0] < need:
            self._raw_end = self._raw0 + self._raw.shape[0]
            # exact total: outputs whose last tap k2(n) fits
            ll, num, den = self._l, self._num, self._den
            n_est = int(self._raw_end * num / den)
            while ((n_est * ll * den) // num + 1) // ll \
                    > self._raw_end - 1:
                n_est -= 1
            while ((((n_est + 1) * ll * den) // num + 1) // ll
                   <= self._raw_end - 1):
                n_est += 1
            self.n_total = n_est + 1

    def produce_block(self):
        """Next n_out on-grid samples on the device + the valid count."""
        q0, phi0 = divmod(self._n, self.p)
        start = q0 * self.k + self.b
        length = self.nq * self.k + self.k_span
        self._ensure_raw(start + length)
        # assemble [start, start+length) with zero pads at both ends
        x = np.zeros((length, 2), np.float32)
        lo = max(start, self._raw0)
        hi = min(start + length, self._raw0 + self._raw.shape[0])
        if hi > lo:
            x[lo - start:hi - start] = \
                self._raw[lo - self._raw0:hi - self._raw0]
        out = _periodic_resample(torch.from_numpy(x).to(self.device),
                                self._w_t, phi0, self.n_out, self.nq, self.k)
        n_valid = self.n_out if self.n_total is None \
            else max(0, min(self.n_out, self.n_total - self._n))
        self._n += self.n_out
        # drop raw the next block can no longer need
        nxt = (self._n // self.p) * self.k + self.b
        drop = max(0, nxt - self._raw0)
        if drop:
            self._raw = self._raw[drop:]
            self._raw0 += drop
        return out, n_valid


BAND_MARGIN_DB = 20.0   # a usable column's carrier over the image on it


def _gain(h: np.ndarray, f, rate: float) -> np.ndarray:
    """|H(f)| of the taps h at the sample rate `rate`, for each f."""
    n = np.arange(len(h))
    return np.abs(np.exp(-2j * np.pi * np.outer(np.atleast_1d(f) / rate, n))
                  @ np.asarray(h, np.float64))


def image_response(rr: ArbResampler, samp_rate: float,
                   n_chans: int) -> tuple[int, np.ndarray, np.ndarray]:
    """How the pre-resampler `rr` passes carriers and their images.

    The pre-resampler takes the capture from samp_rate onto the grid
    rate n_chans x 31.25 kHz.  Its prototype passes the first image of a
    carrier at offset f, the copy at f - samp_rate, with gain H(samp_rate
    - f), and the output's rate folds that copy back to f + (grid rate -
    samp_rate): k = round((grid rate - samp_rate) / 31.25 kHz) columns
    outward (1 at 30.72 MS/s), on either side of the centre.  Returns
    (k, own, image): own[c] = H(c x 31.25 kHz), the gain of a carrier c
    columns from the centre, and image[c] = H(samp_rate - (c - k) x
    31.25 kHz), that of the image column c - k throws onto column c
    (0 for c < k), both read off rr's prototype, for c < n_chans / 2."""
    h = rr.branches.T.reshape(-1)                         # h[L i + p]
    grid_rate = n_chans * BASE_BANDWIDTH
    k = int(round((grid_rate - samp_rate) / BASE_BANDWIDTH))
    c = np.arange(n_chans // 2)
    resp = _gain(h, np.concatenate([c * BASE_BANDWIDTH,
                                    samp_rate - (c - k) * BASE_BANDWIDTH]),
                 rr.l * float(samp_rate))
    own, image = resp[:len(c)], resp[len(c):]
    image[c < k] = 0.0
    return k, own, image


def usable_band(own: np.ndarray, image: np.ndarray) -> int:
    """Half-width, in columns from the centre, of the band a receiver
    behind the pre-resampler can separate: column c is usable when its
    own carrier (own[c]) stands BAND_MARGIN_DB above the image thrown
    onto it (image[c], as the column's own filters pass it); the band is
    the columns out to the first that is not.  On an H100 at 30.72 MS/s
    with every column acquired, columns at 9.1-12.7 dB lost about 1.7e-4
    of their frames and none from 13.2 dB up lost any in 78,000: 20 dB
    keeps the band's edge 7 dB above the last loss.  Images always fall
    outward, so no carrier beyond the band reaches a column inside it;
    an image inside it that falls on a silent column is refused by the
    acquisition (Channelizer.image_db)."""
    ok = own[1:] >= image[1:] * 10.0 ** (BAND_MARGIN_DB / 20.0)
    return int(np.argmin(ok)) if not ok.all() else len(own) - 1


# --------------------------------------------------------------------------
# Full channelizer front-end
# --------------------------------------------------------------------------

class Channelizer:
    """Wideband capture -> per-carrier streams at sps x symbol rate.

    Mirrors the reference PFBBase/PFBOutputBranch structure
    (utils/gmr1_rx_sdr.py:391-602): grid alignment pre-rotation,
    optional pre-resampling to an integer channel grid, 2x-oversampled
    analysis, per-output RRC resampling (+ subchannel recombination for
    wide carriers)."""

    def __init__(self, samp_rate: float, center_freq: float, sps: int = 4,
                 need_nx: bool = False):
        self.samp_rate = samp_rate
        self.center_freq = center_freq
        self.sps = sps
        cw = BASE_BANDWIDTH
        mid = align_freq(center_freq)
        self.rotation = (2.0 * np.pi * (center_freq - mid) / samp_rate
                         if abs(mid - center_freq) > 200 else 0.0)
        self.pfb_center_freq = mid
        self.n_chans = (int(np.ceil(samp_rate / cw)) + 1) & ~1
        resamp = (self.n_chans * cw) / samp_rate
        # exact rational ratio when fs is integral Hz: enables the
        # drift-free streaming form (StreamPreResampler)
        frac = (int(self.n_chans * cw), int(samp_rate)) \
            if samp_rate == int(samp_rate) else None
        self.pre_resamp = None if abs(resamp - 1.0) < 1e-5 \
            else ArbResampler(resamp, ratio_frac=frac)
        mid_rate = self.n_chans * cw
        if need_nx:   # perfect-reconstruction prototype (:420-428)
            taps = filters.low_pass_2(1.0, self.n_chans, 0.5, 0.2, 80,
                                      "blackmanharris")
        else:         # looser filter (:430-437)
            taps = filters.low_pass(1.0, mid_rate, cw * 0.5, cw * 0.25)
        self.analyzer = PFBAnalyzer(self.n_chans, taps)
        # the prototype's group delay (it is symmetric), seconds
        self.analysis_delay = (len(taps) - 1) / 2.0 / mid_rate
        self.chan_rate = 2.0 * cw                 # 2x oversampled
        self._resamplers: dict = {}
        # half-width of the columns the receiver can separate (None on
        # the grid: all of them); image_step k and image_db[c], in dB,
        # the image column c - k throws onto column c against column
        # c - k's own carrier, c columns out from the centre either side.
        # The image lands (grid rate - samp_rate) - k x 31.25 kHz off its
        # column's centre, where the column's own filters (the analysis
        # prototype, the RRC) pass it by chan_gain against the carrier.
        self.band = self.image_step = self.image_db = None
        if self.pre_resamp is not None:
            k, own, image = image_response(self.pre_resamp, samp_rate,
                                           self.n_chans)
            off = mid_rate - samp_rate - k * cw
            rrc = self._rrc_resampler(1)
            rh, rrate = rrc.branches.T.reshape(-1), rrc.l * self.chan_rate
            chan_gain = float(
                _gain(taps, off, mid_rate)[0] / _gain(taps, 0.0, mid_rate)[0]
                * _gain(rh, off, rrate)[0] / _gain(rh, 0.0, rrate)[0])
            image = image * chan_gain
            self.band = usable_band(own, image)
            self.image_step = k
            with np.errstate(divide="ignore"):
                self.image_db = 20.0 * np.log10(
                    image / own[np.maximum(np.arange(len(own)) - k, 0)])

    def freq2index(self, freq: float) -> int | None:
        """(:485-491)"""
        idx = int(round((freq - self.pfb_center_freq) / BASE_BANDWIDTH))
        if idx >= self.n_chans // 2 or idx <= -(self.n_chans // 2):
            return None
        return idx + self.n_chans if idx < 0 else idx

    def process(self, x):
        """Wideband planar (N, 2) -> channel bank (R, M, 2)."""
        x = cplx.tensor(x)
        if self.rotation:
            ph = cplx.expi(self.rotation * torch.arange(
                x.shape[0], dtype=torch.float32, device=x.device))
            x = cplx.mul(x, ph)
        if self.pre_resamp is not None:
            x = self.pre_resamp(x)
        return self.analyzer(x)

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

    def _sub_resampler(self, width: int) -> ArbResampler:
        key = ("sub", width)
        if key not in self._resamplers:
            ratio = (BASE_SYMRATE * width * self.sps) / self.chan_rate
            self._resamplers[key] = ArbResampler(ratio)
        return self._resamplers[key]

    def sub_phases(self, ch: Channel) -> np.ndarray:
        """Phase (radians) each subchannel of a wide carrier takes on top
        of its rotation to df = its offset from the carrier's centre.

        Subchannel k's bank column is its band moved to baseband by k x
        31.25 kHz against the input's own sample index, then delayed by
        the analysis prototype and the subchannel resampler (tau, both
        linear phase): at output time t it holds the carrier at t - tau,
        while rotating by df t turns it as at t.  Each subchannel is off
        by 2 pi df tau, a different phase each, and the subchannels do
        not add up where their bands cross (the reference's
        pfb_synthesizer matches the delays, utils/gmr1_rx_sdr.py:550-551,
        577-583).  This phase, -2 pi df tau, undoes it."""
        tau = self.analysis_delay \
            + self._sub_resampler(ch.width).delay / self.chan_rate
        turns = np.array([(sub.frequency - ch.frequency) * tau
                          for sub in ch.subchannels])
        return -2.0 * np.pi * (turns - np.round(turns))

    def wide_streamer(self, ch: Channel, block_rows: int) -> "WideStreamer":
        """Streamed form of extract() for a wide carrier: feed bank-row
        blocks, get stream chunks that concatenate to the offline extract
        output."""
        return WideStreamer(self, ch, block_rows)

    def extract(self, chans, ch: Channel):
        """Channel bank (R, M, 2) -> one carrier's planar stream at
        sps*sym_rate (None if the carrier is off the bank)."""
        chans = cplx.tensor(chans)
        if ch.width == 1:
            idx = self.freq2index(ch.frequency)
            if idx is None:
                return None
            return self._rrc_resampler(1)(chans[:, idx])
        # wide carrier: rotate-and-sum subchannels at the output rate,
        # then RRC (the pfb_synthesizer role, :566-589)
        out_rate = BASE_SYMRATE * ch.width * self.sps
        acc = None
        up = self._sub_resampler(ch.width)
        for sub, phi in zip(ch.subchannels, self.sub_phases(ch)):
            idx = self.freq2index(sub.frequency)
            if idx is None:
                return None
            s = up(chans[:, idx])
            df = sub.frequency - ch.frequency
            # exact wrapped phase: df and out_rate are integer Hz, so the
            # phasor repeats every period samples; index mod keeps the
            # f32 phase argument small over long captures
            period = _phase_period(df, out_rate)
            n = torch.arange(s.shape[0], device=s.device) % period
            s = cplx.mul(s, cplx.expi((2.0 * np.pi * df / out_rate)
                                      * n.to(torch.float32)
                                      + np.float32(phi)))
            acc = s if acc is None else acc + s
        return self._rrc_resampler(ch.width)(acc)


def _phase_period(df: float, out_rate: float) -> int:
    """Sample period after which 2*pi*df*n/out_rate wraps an integer
    number of turns (df, out_rate integer Hz)."""
    return int(out_rate) // np.gcd(int(abs(df)) or 1, int(out_rate))


class WideStreamer:
    """Streamed wide-carrier synthesizer (the block form of
    Channelizer.extract for width > 1, utils/gmr1_rx_sdr.py:566-589).

    Per block of bank rows: per-subchannel fractional resample to the
    output rate (static block-periodic gather geometry), rotate each
    subchannel to its offset with the phase carried across blocks, sum,
    and RRC-filter (the width-RRC at ratio 1 is a plain FIR, one
    conv1d).  All state - subchannel resampler history, FIR history,
    rotation phase - is carried, so chunks concatenate to the offline
    extract output.  The state lives on the device of the first block
    fed."""

    def __init__(self, chz: Channelizer, ch: Channel, block_rows: int):
        if ch.width <= 1:
            raise ValueError(f"{ch} is not a wide carrier")
        self.ch = ch
        cols = [chz.freq2index(sub.frequency) for sub in ch.subchannels]
        if any(c is None for c in cols):
            raise ValueError(f"{ch} is not inside the channel bank: {cols}")
        self.cols = np.asarray(cols, np.int64)
        w = ch.width
        self._up = chz._sub_resampler(w)
        rrc = chz._rrc_resampler(w)
        out_rate = BASE_SYMRATE * w * chz.sps
        n_out = block_rows * self._up.ratio
        self.n_out = int(round(n_out))
        if abs(self.n_out - n_out) >= 1e-6:
            raise ValueError(f"{block_rows} rows give {n_out} outputs")
        self._geom = self._up.block_gather(self.n_out, self._up.tpb)
        self.h_up = self._up.tpb
        dfs = np.asarray([sub.frequency - ch.frequency
                          for sub in ch.subchannels], np.float64)
        self._dphi = (2.0 * np.pi * dfs / out_rate).astype(np.float32)
        self._phi = chz.sub_phases(ch).astype(np.float32)
        self._periods = np.asarray([_phase_period(df, out_rate)
                                    for df in dfs], np.int64)
        # the ratio-1 FIR y[n] = sum_i fir[i] xf[n + t_fir - i] as a
        # cross-correlation of xf[1:] with the reversed taps
        self._fir_rev = np.ascontiguousarray(
            np.asarray(rrc.branches[0], np.float32)[::-1])
        self._state = None           # (hist_up, hist_fir, n0)

    def feed(self, bank_rows) -> np.ndarray:
        """bank_rows: carrier-major block rows (M, R_b, 2).  Returns the
        wide stream chunk (n_out, 2) as host numpy."""
        return self.feed_cols(bank_rows[torch.as_tensor(
            self.cols, device=bank_rows.device)])

    def feed_cols(self, rows_w) -> np.ndarray:
        """feed() from only the subchannel columns (W, R_b, 2), in `cols`
        order (a mesh receiver gathers just these from its
        carrier-sharded rows, gmr1_tpu/channelizer/pfb.py:680)."""
        dev = rows_w.device
        t_fir = len(self._fir_rev)
        if self._state is None:
            self._state = (
                rows_w.new_zeros((len(self.cols), self.h_up, 2)),
                rows_w.new_zeros((t_fir, 2)),
                np.zeros(len(self.cols), np.int64))
        hist_up, hist_fir, n0 = self._state
        rows_full = torch.cat([hist_up, rows_w], dim=1)
        s = self._up.resample_window(rows_full, *self._geom)  # (W, n, 2)
        # exact wrapped rotation (see _phase_period): index mod per
        # subchannel keeps the f32 phase argument small forever
        idx = (torch.as_tensor(n0, device=dev)[:, None]
               + torch.arange(self.n_out, device=dev)) \
            % torch.as_tensor(self._periods, device=dev)[:, None]
        ph = torch.as_tensor(self._dphi, device=dev)[:, None] \
            * idx.to(torch.float32) \
            + torch.as_tensor(self._phi, device=dev)[:, None]
        acc = torch.sum(cplx.mul(s, cplx.expi(ph)), dim=0)    # (n, 2)
        xf = torch.cat([hist_fir, acc])
        y = torch.nn.functional.conv1d(
            xf[1:].T[:, None, :],
            torch.as_tensor(self._fir_rev, device=dev)[None, None, :])
        self._state = (rows_full[:, -self.h_up:], xf[-t_fir:],
                       (n0 + self.n_out) % self._periods)
        return y[:, 0, :].T.cpu().numpy()
