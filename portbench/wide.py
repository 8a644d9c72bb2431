"""The plain reference of a wide carrier's stream (the receiver's
WideStreamer), and its control.

A wide carrier of width w (2, 3 or 5 grid columns) is synthesized from
the columns it spans of the 2x-oversampled channel bank (62.5 kHz a
column), as the reference front end's pfb_synthesizer role does
(utils/gmr1_rx_sdr.py:566-589): each subchannel column y_s is resampled
to the carrier's rate f_out = 4 w 23.4 kHz by GNU Radio's
pfb_arb_resampler_ccf (L = 32 branches of firdes.low_pass_2(L, L, 1/2,
1/10, 80 dB, Blackman-Harris): pre.py's design at this ratio, and
rrc.py's geometry), turned to its offset d_s from the carrier's centre
at the time its samples stand for, summed, and filtered by the carrier's
root-raised cosine at ratio 1 (rrc.py's taps at f_in = f_out, branch 0):

    a[n] = sum_s exp(2j pi d_s (n / f_out - tau))
                 sum_t w_s[n, t] y_s[k(n) - t]
    s[n] = sum_j r[j] a[n - j],

tau the delay of the bank's prototype (bank.prototype_nx: (taps - 1) / 2
samples at M x 31.25 kHz) and of the subchannel resampler ((taps - 1) /
2L rows at 62.5 kHz), both symmetric: a column holds its band at the
input's time less tau (the reference's synthesizer matches the delays,
utils/gmr1_rx_sdr.py:550-551, 577-583); y = 0 before the stream's first
bank row and a = 0 before its first output.  `stream` computes it in
float64 from bank rows; `rows` makes those rows from the on-grid
samples through the plain bank (bank.py), so `stream(rows(...))`
resamples the carrier's stream from the on-grid samples with nothing of
the program.  The control is the same product with both of its
operands (the bank rows and the resampler's weights) rounded to bf16, a
precision below the float32 of the program's synthesis.
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np
import torch

from . import bank, pre, rrc

SYM_RATE = 23400.0
GRID = 31250.0
SPS = 4


def rate(width: int) -> float:
    """The wide carrier's stream rate, samples a second."""
    return SPS * SYM_RATE * width


def offsets(arfcn: int, width: int) -> tuple[list, list]:
    """(the ARFCNs of the subchannels, each one's offset from the
    carrier's centre in Hz): odd widths centre on the carrier's ARFCN,
    even ones half a column above it."""
    subs = list(range(arfcn - (width - 1) // 2, arfcn + (width + 2) // 2))
    centre = arfcn + 0.5 * (width % 2 == 0)
    return subs, [GRID * (a - centre) for a in subs]


def _bf16(a: np.ndarray) -> np.ndarray:
    t = torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float64)
    return t.to(torch.bfloat16).to(torch.float64).numpy()


def delay(m: int, width: int) -> float:
    """tau, seconds: the bank prototype's and the subchannel resampler's
    group delays."""
    taps_a = int(80.0 * m / (22.0 * 0.2)) | 1          # prototype_nx
    up = Fraction(round(rate(width)), round(2 * GRID))
    taps_r = len(pre.taps(up))
    return (taps_a - 1) / 2.0 / (m * GRID) \
        + (taps_r - 1) / (2.0 * rrc.L) / (2 * GRID)


def stream(y: np.ndarray, k0: int, n: np.ndarray, width: int,
           dfs: list, m: int, bf16: bool = False) -> np.ndarray:
    """Outputs n (absolute, sorted, (N,)) of the wide carrier whose
    subchannel columns are y (W, K) complex, column i of each being the
    bank row k0 + i, and whose subchannels sit dfs Hz (W,) from its
    centre, out of an M = m channel bank.  With bf16 the control.
    complex128 (N,)."""
    f_out = rate(width)
    up = Fraction(round(f_out), round(2 * GRID))         # f_out / 62.5 kHz
    fir = rrc.branches(rrc.taps(f_out, SYM_RATE * width))[0]
    a_idx = np.arange(max(int(n[0]) - len(fir) + 1, 0), int(n[-1]) + 1)
    k_hi, w = rrc.weights(a_idx, up, rrc.branches(pre.taps(up)))
    idx = (k_hi - k0)[:, None] - np.arange(w.shape[1])
    if idx.max() >= y.shape[1]:
        raise ValueError("an output reaches past the rows given")
    if bf16:
        y = _bf16(y.real) + 1j * _bf16(y.imag)
        w = _bf16(w)
    seg = np.where(idx >= 0, 1.0, 0.0)[None] * y[:, np.maximum(idx, 0)]
    s = np.einsum("wnt,nt->wn", seg, w)                   # (W, len(a_idx))
    tau = delay(m, width)
    turns = np.array([[(df * i) % f_out / f_out for i in a_idx]
                      for df in dfs]) \
        - np.array([df * tau - np.round(df * tau) for df in dfs])[:, None]
    a = np.sum(np.exp(2j * np.pi * turns) * s, axis=0)
    j = np.arange(len(fir))
    out = np.empty(len(n), np.complex128)
    for i, k in enumerate(np.asarray(n, np.int64)):
        back = k - j - a_idx[0]
        ok = back >= 0
        out[i] = np.sum(fir[ok] * a[back[ok]])
    return out


def rows_needed(n: np.ndarray, width: int) -> tuple[int, int]:
    """[first, end) of the bank rows that outputs n (sorted) read."""
    f_out = rate(width)
    up = Fraction(round(f_out), round(2 * GRID))
    fir = rrc.branches(rrc.taps(f_out, SYM_RATE * width))[0]
    lo = max(int(n[0]) - len(fir) + 1, 0)
    k_hi, w = rrc.weights(np.array([lo, int(n[-1])]), up,
                          rrc.branches(pre.taps(up)))
    return max(int(k_hi[0]) - w.shape[1] + 1, 0), int(k_hi[1]) + 1


def rows(read, first: int, end: int, cols: list, m: int,
         proto: np.ndarray) -> np.ndarray:
    """Bank rows [first, end) of the columns `cols` from the on-grid
    samples read(lo, hi) (complex), through the plain bank with the
    prototype proto (bank.py): (len(cols), end - first) complex."""
    z, ph = bank.fold(read, 0, np.arange(first, end), m, proto)
    return bank.bank(z, ph)[:, cols].T
