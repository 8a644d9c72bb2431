"""The plain reference of the channel bank that the receiver's ingest
computes (kernel P's branch filter and the channel DFT), and its control.

The M-channel analysis bank, 2x oversampled (hop M / 2), of input x with
the prototype h (P M taps) is, for bank row r of a block that starts at
input sample s0 (a multiple of M) and channel k,

    y[r, k] = sum_t h[t] x[c - t] exp(-2j pi k (c - t) / M),  c = s0 + r hop,

with x = 0 before the stream's start.  Computed here in float64 NumPy
from the input samples and a prototype this module designs itself (the
windowed-sinc designs of the reference front end, gmr1_rx_sdr.py:420-437,
as GNU Radio's firdes: the Hamming `prototype`, or `prototype_nx`, the
perfect-reconstruction design the bank takes when wide carriers are
configured): it shares nothing with the program.  At a rate off the
grid the input is the capture resampled onto it (pre.py).  The control
is the same bank with the channel DFT's operands rounded to fp8 (e4m3,
one scale a tensor), the precision below the bf16 the configuration
states.
"""

from __future__ import annotations

import numpy as np
import torch

HAMMING_ATT = 53.0          # dB, firdes's attenuation of the Hamming window


def prototype(m: int, grid: float = 31250.0) -> np.ndarray:
    """The analysis prototype, zero-padded to P M taps: firdes.low_pass
    (Hamming, cutoff half a channel, transition a quarter)."""
    fs = m * grid
    ntaps = int(HAMMING_ATT * fs / (22.0 * grid * 0.25)) | 1
    k = np.arange(ntaps) - (ntaps - 1) / 2.0
    h = grid / fs * np.sinc(grid / fs * k)
    h *= 0.54 - 0.46 * np.cos(2 * np.pi * np.arange(ntaps) / (ntaps - 1))
    h /= h.sum()
    p = -(-len(h) // m)
    out = np.zeros(p * m)
    out[:len(h)] = h
    return out


def prototype_nx(m: int) -> np.ndarray:
    """The perfect-reconstruction prototype (gmr1_rx_sdr.py:420-428),
    zero-padded to P M taps: firdes.low_pass_2 (gain 1, rate M, cutoff
    half a channel, transition a fifth, 80 dB, Blackman-Harris)."""
    ntaps = int(80.0 * m / (22.0 * 0.2)) | 1
    n = np.arange(ntaps)
    k = n - (ntaps - 1) / 2.0
    h = np.sinc(k / m) / m
    a = 2 * np.pi * n / (ntaps - 1)
    h *= (0.35875 - 0.48829 * np.cos(a) + 0.14128 * np.cos(2 * a)
          - 0.01168 * np.cos(3 * a))
    h /= h.sum()
    p = -(-len(h) // m)
    out = np.zeros(p * m)
    out[:len(h)] = h
    return out


def fold(read, s0: int, rows: np.ndarray, m: int,
         h: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(z, phase): z[i, j] = sum over the taps of bank row rows[i] whose
    sample n has n mod M == (c + 1 + j) mod M, of h[c - n] x[n]; the bank
    row is phase[i, k] * DFT_j(z[i])[k].  read(lo, hi) returns the
    complex input samples [lo, hi), lo >= 0."""
    hop, pm = m // 2, len(h)
    hr = h[::-1]
    z = np.zeros((len(rows), m), np.complex128)
    for i, r in enumerate(rows):
        c = s0 + int(r) * hop
        lo = c - pm + 1
        seg = np.zeros(pm, np.complex128)
        a = max(lo, 0)
        seg[a - lo:] = read(a, c + 1)
        z[i] = (seg * hr).reshape(-1, m).sum(0)
    c = s0 + rows.astype(np.int64) * hop
    k = np.arange(m)
    phase = np.exp(-2j * np.pi * np.outer((c + 1) % m, k) / m)
    return z, phase


def bank(z: np.ndarray, phase: np.ndarray) -> np.ndarray:
    """The reference bank rows (float64)."""
    return phase * np.fft.fft(z, axis=-1)


def _fp8(a: np.ndarray) -> np.ndarray:
    """Round to fp8 e4m3 with one scale for the tensor (amax to 448)."""
    s = np.abs(a).max() / 448.0 or 1.0
    q = torch.as_tensor(a / s, dtype=torch.float32).to(torch.float8_e4m3fn)
    return q.to(torch.float64).numpy() * s


def bank_fp8(z: np.ndarray, phase: np.ndarray) -> np.ndarray:
    """The control: the channel DFT as a real matrix product with fp8
    operands (the fold and the DFT table), float32 accumulation."""
    m = z.shape[-1]
    j, k = np.meshgrid(np.arange(m), np.arange(m), indexing="ij")
    w = np.exp(-2j * np.pi * j * k / m)
    a = np.concatenate([z.real, z.imag], -1)                    # (R, 2M)
    t = np.block([[w.real, w.imag], [-w.imag, w.real]])         # (2M, 2M)
    y = (_fp8(a).astype(np.float32) @ _fp8(t).astype(np.float32))
    return phase * (y[:, :m] + 1j * y[:, m:])


def rel_err(got: np.ndarray, ref: np.ndarray) -> float:
    """RMS of the difference over the RMS of the reference."""
    return float(np.sqrt(np.sum(np.abs(got - ref) ** 2)
                         / np.sum(np.abs(ref) ** 2)))
