"""Direct per-carrier DDC front-end (reference utils/gmr1_rx_sdr.py:609-807;
counterpart of gmr1_tpu/channelizer/ddc.py).

The alternative to the PFB channelizer for few-carrier use: per carrier,
a frequency-translating FIR decimator chain (two decimation stages
chosen by the reference's "squareness"-scored factor search) followed by
the RRC arbitrary resampler to sps x symbol rate.  The translation is a
float32 phasor multiply, each FIR decimation stage one strided conv1d,
and the resampler the PFB module's `ArbResampler`.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as tf

from ..ops import cplx
from . import filters
from .pfb import ArbResampler

# the FIR stages are cuDNN convolutions, which run in TF32 unless told
# otherwise (cuDNN's flag defaults to True, unlike the matmul one)
torch.backends.cudnn.allow_tf32 = False


def _factor(decim: int) -> list[int]:
    """Split decim into <=2 near-square factors (:644-649)."""
    d_ideal = int(round(math.sqrt(decim)))
    for i in range(d_ideal, 1, -1):
        if decim % i == 0:
            return [decim // i, i]
    return [decim]


def _score(factors: list[int]) -> float:
    """(:651-658)"""
    if len(factors) == 1:
        return float(factors[0])
    return (factors[0] * factors[0] * factors[1]) / (
        1.0 + 1.0 * factors[0] / factors[1])


class DirectParams:
    """Decimation plan + taps (DirectOutputParameters, :609-752)."""

    def __init__(self, samp_rate: float, sym_rate: float, sps: int):
        self.samp_rate = samp_rate
        self.sym_rate = sym_rate
        self.sps = sps
        self._select_decim()
        self._generate_taps()

    def _select_decim(self) -> None:
        target = self.sym_rate * self.sps
        if self.samp_rate % target == 0:
            decim = int(self.samp_rate / target)
            f = (_factor(decim) + [1, 1])[:3]
            self.decim1, self.decim2 = f[0], f[1]
            self.resamp = 1.0
            return
        decim_max = int(math.floor(self.samp_rate / (2 * self.sym_rate)))
        decim_min = int(math.ceil(self.samp_rate / (3 * self.sym_rate)))
        fs = [_factor(i) for i in range(decim_min, decim_max + 1)]
        best = sorted(fs, key=lambda x: -_score(x))[0]
        best = (best + [1])[:2]
        decim = best[0] * best[1]
        resamp = (self.sym_rate * self.sps * decim) / self.samp_rate
        if best[1] <= 4:                      # merge tiny decim2 (:682-684)
            resamp /= best[1]
            best[1] = 1
        self.decim1, self.decim2 = best[0], best[1]
        self.resamp = resamp

    def _generate_taps(self) -> None:
        """RRC goes to the last non-unity stage, scanned resampler ->
        decim2 -> decim1; earlier stages get loose low-pass (:694-752)."""
        need_rrc = True
        if self.resamp != 1:
            r_in = self.samp_rate / (self.decim1 * self.decim2)
            self.taps_resamp = filters.root_raised_cosine(
                32.0, 32.0 * r_in, self.sym_rate, 0.35,
                int(11.0 * 32 * r_in / self.sym_rate))
            need_rrc = False
        else:
            self.taps_resamp = np.zeros(0, np.float32)

        if self.decim2 != 1:
            if need_rrc:
                r1 = self.samp_rate / self.decim1
                self.taps2 = filters.root_raised_cosine(
                    1.0, r1, self.sym_rate, 0.35,
                    int(11.0 * r1 / self.sym_rate))
                need_rrc = False
            else:
                self.taps2 = filters.low_pass(
                    1.0, 1.0, 0.45 / self.decim2, 0.10 / self.decim2)
        else:
            self.taps2 = np.zeros(0, np.float32)

        if need_rrc:
            self.taps1 = filters.root_raised_cosine(
                1.0, self.samp_rate, self.sym_rate, 0.35,
                int(11.0 * self.samp_rate / self.sym_rate))
        else:
            self.taps1 = filters.low_pass(
                1.0, 1.0, 0.3 / self.decim1, 0.3 / self.decim1)


def _fir_decimate(x, taps, decim: int, n_taps: int):
    """Strided FIR on planar (..., N, 2): y[m] = sum_k h[k] x[m*D - k]
    (zeros before the input), one conv1d over the (B*2, 1, N) rows with
    the flipped taps, as conv_general_dilated at
    gmr1_tpu/channelizer/ddc.py:116-119."""
    batch_shape = x.shape[:-2]
    n = x.shape[-2]
    xx = x.reshape(-1, n, 2).transpose(1, 2).reshape(-1, 1, n)  # (B*2, 1, N)
    k = torch.flip(torch.as_tensor(np.asarray(taps, np.float32),
                                   device=x.device), (0,))[None, None, :]
    y = tf.conv1d(tf.pad(xx, (n_taps - 1, 0)), k, stride=decim)
    y = y.reshape(-1, 2, y.shape[-1]).transpose(1, 2)
    return y.reshape(*batch_shape, -1, 2)


class DirectDDC:
    """One carrier's DDC chain (DirectOutputBranch, :755-807)."""

    def __init__(self, params: DirectParams, freq_offset: float):
        self.p = params
        self.freq_offset = freq_offset
        self.resampler = (ArbResampler(params.resamp, params.taps_resamp)
                          if params.resamp != 1 else None)

    def __call__(self, x):
        """Wideband planar (N, 2) -> carrier stream at sps*sym_rate, on
        x's device (numpy input stays on the CPU)."""
        x = cplx.tensor(x)
        p = self.p
        w = -2.0 * np.pi * self.freq_offset / p.samp_rate
        # a float32 phase argument, as JAX computes it: float64 would
        # drift away from the reference stream over a block
        x = cplx.mul(x, cplx.expi(w * torch.arange(
            x.shape[-2], dtype=torch.float32, device=x.device)))
        if p.decim1 > 1:
            x = _fir_decimate(x, p.taps1, p.decim1, len(p.taps1))
        if p.decim2 > 1:
            x = _fir_decimate(x, p.taps2, p.decim2, len(p.taps2))
        if self.resampler is not None:
            x = self.resampler(x)
        return x
