"""AMBE tone frame synthesis (reference src/codec/tone.c; counterpart of
gmr1_tpu/codec/tone.py), batched.

Tone frames carry a frequency code (majority-voted over 8 bit columns),
a log amplitude, and a half-frame start/stop selector.  Synthesis is
two phase-continuous oscillators whose phase state persists across
frames.  Branch-free: the DTMF / KNOX / call-progress / single-tone
interpretation is resolved via precomputed (freq1, freq2, amp_shift)
lookup tables indexed by the 8-bit code.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .frame import div, exp2

AMBE_RATE = 8000
N = 160

# tone descriptor tables (tone.c:44-89): (f1, f2) Hz
DTMF = [(1209, 697), (1209, 770), (1209, 852), (1209, 941),
        (1336, 697), (1336, 770), (1336, 852), (1336, 941),
        (1477, 697), (1477, 770), (1477, 852), (1477, 941),
        (1633, 697), (1633, 770), (1633, 852), (1633, 941)]
KNOX = [(1052, 606), (1052, 672), (1052, 743), (1052, 820),
        (1162, 606), (1162, 672), (1162, 743), (1162, 820),
        (1297, 606), (1297, 672), (1297, 743), (1297, 820),
        (1430, 606), (1430, 672), (1430, 743), (1430, 820)]
CPROG = [(440, 350), (480, 440), (630, 480), (490, 350)]

# Per 8-bit code: f1, f2 (0 = oscillator silent), amplitude halved flag,
# valid flag (tone.c:159-205).
_F1 = np.zeros(256, np.float32)
_F2 = np.zeros(256, np.float32)
_HALF = np.zeros(256, np.bool_)
_VALID = np.zeros(256, np.bool_)
for _c in range(256):
    if _c == 0xFF:
        _VALID[_c] = True          # inactive: silence
    elif 0xA0 <= _c <= 0xA3:
        _F1[_c], _F2[_c] = CPROG[_c & 0xF]
        _HALF[_c] = _VALID[_c] = True
    elif 0x90 <= _c <= 0x9F:
        _F1[_c], _F2[_c] = KNOX[_c & 0xF]
        _HALF[_c] = _VALID[_c] = True
    elif 0x80 <= _c <= 0x8F:
        _F1[_c], _F2[_c] = DTMF[_c & 0xF]
        _HALF[_c] = _VALID[_c] = True
    elif _c < 0x7F:
        _F1[_c] = (_c * 125) >> 2  # 31.25 Hz increments
        _VALID[_c] = True
_TABLES = {"f1": _F1, "f2": _F2, "half": _HALF, "valid": _VALID}


@lru_cache(maxsize=None)
def _table(name: str, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(_TABLES[name], device=device)


def tone_code(frames) -> torch.Tensor:
    """The 8-bit tone code of frames (..., 10): each bit the majority of
    its column over bytes 0-7 (tone.c:138-144)."""
    frames = torch.as_tensor(frames).to(torch.int64)
    sh = torch.arange(7, -1, -1, device=frames.device)
    bits = (frames[..., :8, None] >> sh) & 1                  # (..., 8, 8)
    cnt = torch.sum(bits, dim=-2)                             # (..., 8)
    return torch.sum(torch.where(cnt >= 4, 1, 0) << sh, dim=-1)


def decode_tone(phase_f1, phase_f2, frames):
    """Tone frames (..., 10) uint8 -> (phase_f1', phase_f2',
    audio (..., 160) float32 pre-int16, valid (...,) bool).

    Phases only advance for the generated sample span, matching the
    reference's per-call tone_gen phase bookkeeping (tone.c:100-115).
    """
    frames = torch.as_tensor(frames).to(torch.int64)
    dev = frames.device
    sf_sel = frames[..., 0] & 3
    log_ampl = frames[..., 1].to(torch.float32)
    code = tone_code(frames)

    start = torch.where((sf_sel & 2) != 0, 0, N >> 1)
    stop = torch.where((sf_sel & 1) != 0, N - 1, (N >> 1) - 1)
    run = start < stop                                  # tone.c:153

    amplitude = torch.floor(
        32767.0 * exp2(div(log_ampl - 255.0, 17.0)))
    f1 = _table("f1", dev)[code]
    f2 = _table("f2", dev)[code]
    half = _table("half", dev)[code]
    valid = _table("valid", dev)[code]
    amp = torch.where(half, torch.floor(amplitude / 2.0),  # integer >> 1
                      amplitude)

    i = torch.arange(N, device=dev)
    on = run & valid & (code != 0xFF)
    active = (i >= start[..., None]) & (i <= stop[..., None]) & on[..., None]
    # sample index within the generated span
    k = (i - start[..., None]).to(torch.float32)

    def osc(phase, freq, use):
        step = div((2.0 * np.pi) * freq, AMBE_RATE)
        ang = phase[..., None] + step[..., None] * k
        cos = torch.cos(ang.to(torch.float64)).to(torch.float32)
        out = torch.where(active & use[..., None],
                          torch.trunc(amp[..., None] * cos), 0.0)
        n_gen = torch.where(on & use, (stop - start + 1).to(torch.float32),
                            0.0)
        return phase + step * n_gen, out

    phase_f1, a1 = osc(phase_f1, f1, f1 > 0)
    phase_f2, a2 = osc(phase_f2, f2, f2 > 0)
    return phase_f1, phase_f2, a1 + a2, valid
