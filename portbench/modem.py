"""GMR-1 burst formats and the pi/4 modulator, the benchmark's own copy.

Burst catalog transcribed from osmo-gmr src/sdr/nb.c (TS 101 376-5-2
section 7.4) for the bursts the traffic sends, the modulator of
pi4cxpsk.c:742-799 (symbols at 1 sps, guard symbols zeroed, continuous
pi/4 rotation), the FCCH dual chirp (fcch.c:92-193) and the DKAB
keep-alive tones (dkab.c).  Imports nothing of the program under test.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

SLOT = 39                     # symbols a timeslot
FRAME_SYMS = 24 * SLOT        # 936 symbols a TDMA frame (40 ms)


@dataclass(frozen=True)
class Burst:
    name: str
    nbits: int                # bits a symbol (1: pi/4-CBPSK, 2: CQPSK)
    len_syms: int
    ebits: int
    sync: tuple               # per sync id: ((pos, symbol indices), ...)
    data: tuple               # ((pos, length), ...) in ebit order
    rotation: float = np.pi / 4
    guard_pre: int = 2
    guard_post: int = 3

    @property
    def slots(self) -> int:
        return self.len_syms // SLOT


BCCH = Burst("bcch", 2, 234, 424,
             (((28, (0, 2, 2, 0, 0, 0, 2, 0, 2, 2, 2)), (119, (2, 2, 0)),
               (197, (2, 2, 0))),),
             ((2, 26), (39, 80), (122, 75), (200, 31)))
DC6 = Burst("dc6", 2, 234, 432,
            (((28, (0, 0, 0, 2, 2, 0, 2)), (119, (0, 3, 0)),
              (197, (3, 1, 1))),),
            ((2, 26), (35, 84), (122, 75), (200, 31)))
NT3_SPEECH = Burst("nt3_speech", 2, 117, 212,
                   (((28, (0, 3, 3, 1, 2, 3)),),),
                   ((2, 26), (34, 80)))
NT3_FACCH = Burst("nt3_facch", 1, 117, 104,
                  (((28, (1, 0, 1, 0, 1, 0, 1, 0)),),
                   ((28, (1, 1, 0, 0, 1, 0, 0, 1)),)),
                  ((2, 26), (36, 78)))
NT9 = Burst("nt9", 2, 351, 662,
            (((28, (0, 2, 2, 3, 2, 3)), (119, (1, 2, 2)), (197, (0, 1, 0)),
              (275, (2, 3, 0))),
             ((28, (0, 0, 0, 2, 2, 0)), (119, (0, 2, 0)), (197, (1, 3, 0)),
              (275, (2, 1, 3)))),
            ((2, 26), (34, 85), (122, 75), (200, 75), (278, 70)))

# CQPSK Gray map: bits 00 -> 0, 01 -> 1, 11 -> 2, 10 -> 3; BPSK 0, 1
_SYM_OF_BITS = {1: np.array([0, 1]), 2: np.array([0, 1, 3, 2])}


def mod(burst: Burst, ebits: torch.Tensor, sync_id: int = 0) -> torch.Tensor:
    """Hard bits (..., ebits) -> complex64 symbols (..., len_syms)."""
    dev = ebits.device
    nb = burst.nbits
    g = ebits.to(torch.int64).reshape(*ebits.shape[:-1], -1, nb)
    packed = g[..., 0] if nb == 1 else (g[..., 0] << 1) | g[..., 1]
    idx = torch.as_tensor(_SYM_OF_BITS[nb], device=dev)[packed]
    syms = torch.zeros((*ebits.shape[:-1], burst.len_syms), dtype=torch.int64,
                       device=dev)
    pos = np.concatenate([np.arange(p, p + n) for p, n in burst.data])
    syms[..., torch.as_tensor(pos, device=dev)] = idx
    m = 1 << nb
    val = torch.exp(1j * (2 * np.pi / m) * syms.to(torch.float64))
    for p, s in burst.sync[sync_id]:
        ref = np.exp(1j * (2 * np.pi / m) * np.asarray(s, np.float64))
        val[..., p:p + len(s)] = torch.as_tensor(ref, device=dev)
    guard = np.ones(burst.len_syms)
    guard[:burst.guard_pre] = 0
    guard[burst.len_syms - burst.guard_post:] = 0
    rot = guard * np.exp(1j * burst.rotation * np.arange(burst.len_syms))
    return (val * torch.as_tensor(rot, device=dev)).to(torch.complex64)


FCCH_SYMS = 3 * SLOT
FCCH_FREQ = 0.32


def fcch(sps: int) -> np.ndarray:
    """The dual chirp at sps, over sqrt 2: cos(2 pi f (t - T/2)^2 / T),
    t in symbols (fcch.c, kind 'dual')."""
    t = np.arange(FCCH_SYMS * sps, dtype=np.float64) / sps - FCCH_SYMS / 2.0
    return np.cos(2 * np.pi * FCCH_FREQ / FCCH_SYMS * t * t) + 0j


def dkab(p: int, bits, sps: int) -> np.ndarray:
    """The DKAB slot triple at sps: two 5-symbol tones at symbols 2 + p and
    2 + p + 59, each a pi phase step a set bit, with the pi/4 rotation."""
    sig = np.zeros(FCCH_SYMS * sps, np.complex128)
    i_all = np.arange(FCCH_SYMS * sps)
    for tone, base in enumerate((2 + p, 2 + p + 59)):
        ph = 0.0
        for s in range(5):
            if s:
                ph += np.pi * bits[tone * 4 + (s - 1)]
            i = (base + s) * sps + np.arange(sps)
            sig[i] += np.exp(1j * (ph + (np.pi / 4) * i_all[i] / sps))
    return sig
