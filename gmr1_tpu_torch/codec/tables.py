"""AMBE codec tables and derived constants.

The raw VQ codebooks / windows live in _tables.npz, extracted from the
reference sources by tools/extract_ambe_tables.py (see that tool for
provenance: reference src/codec/tables.c and src/codec/synth.c:36-95).
This module loads them and precomputes the TPU-friendly derived forms:
the cosf_fast quantized cosine table (math.c:34-66), the dense
DFT/iDFT matrices for the 128-pt unvoiced transform (math.c:127-175),
the iDCT-8 matrix for PRBA (math.c:99-114), and the per-L block-index
maps that make the variable-harmonic-count layout static-shape.
"""

from __future__ import annotations

import os

import numpy as np

L_MAX = 56          # max harmonics (private.h: Mlog[56])
L_MIN = 9
NB = 4              # spectral blocks per subframe
UW_LEN = 121        # unvoiced synthesis window length
DFT_N = 128         # unvoiced DFT size
DFT_BINS = DFT_N // 2 + 1   # 65 (real transform, one side)

_NPZ = np.load(os.path.join(os.path.dirname(__file__), "_tables.npz"))

HPG = _NPZ["hpg"].astype(np.int32)             # (48, 4) harmonics/block
GAIN = _NPZ["gain"].astype(np.float32)         # (256, 2)
V_UV = _NPZ["v_uv"].astype(np.int32)           # (64,) bitmasks
PRBA12 = _NPZ["prba12"].astype(np.float32)     # (128, 2)
PRBA34 = _NPZ["prba34"].astype(np.float32)     # (64, 2)
PRBA57 = _NPZ["prba57"].astype(np.float32)     # (128, 3)
HOC = [_NPZ[f"hoc{i}"].astype(np.float32) for i in range(4)]
SF0_INTERP = _NPZ["sf0_interp"].astype(np.float32)   # (4,)
SF0_PERR14 = _NPZ["sf0_perr14"].astype(np.float32)   # (64, 4)
SF0_PERR58 = _NPZ["sf0_perr58"].astype(np.float32)   # (32, 4)
WS = _NPZ["ws"].astype(np.float32)             # (121,) synthesis window
RHO = _NPZ["rho"].astype(np.float32)           # (56,) random phase incr

# HOC tables have different row counts (128/64/64/64) and the raw
# index fields different widths; pad to a uniform (4, 128, 4) block.
HOC_ALL = np.zeros((4, 128, 4), np.float32)
for _i, _t in enumerate(HOC):
    HOC_ALL[_i, :_t.shape[0]] = _t

# --- cosf_fast emulation (math.c:34-66) ----------------------------------
# cos_tbl[i] = cosf(pi*i/512); lookup index (int)(angle*512/pi) & 1023.
COS_TBL = np.cos(np.pi * np.arange(1024) / 512.0).astype(np.float32)


def cosf_fast_np(angle: np.ndarray) -> np.ndarray:
    idx = (np.asarray(angle, np.float32) * np.float32(512.0 / np.pi)
           ).astype(np.int32) & 1023
    return COS_TBL[idx]


def sinf_fast_np(angle: np.ndarray) -> np.ndarray:
    idx = ((np.asarray(angle, np.float32) * np.float32(512.0 / np.pi)
            ).astype(np.int32) + 768) & 1023
    return COS_TBL[idx]


# --- dense transform matrices (static shapes, MXU matmuls) ---------------
# 128-pt real DFT over 121 samples (ambe_fdft_fc): (65, 121) each.
_fb = np.arange(DFT_BINS)[:, None].astype(np.float32)
_ts = np.arange(UW_LEN)[None, :].astype(np.float32)
_ang = (-2.0 * np.pi / DFT_N) * _fb * _ts
DFT_COS = cosf_fast_np(_ang)                   # (65, 121)
DFT_SIN = sinf_fast_np(_ang)

# inverse (ambe_idft_cf): out[ts] = sum_fb m/N * (i*cos + q*sin), (121, 65)
_m = np.where((np.arange(DFT_BINS) == 0) | (np.arange(DFT_BINS) == DFT_N // 2),
              1.0, 2.0).astype(np.float32)
IDFT_COS = (DFT_COS.T * _m / DFT_N).astype(np.float32)   # (121, 65)
IDFT_SIN = (DFT_SIN.T * _m / DFT_N).astype(np.float32)

# iDCT-8 for the PRBA vector (ambe_idct with N=M=8):
# Ri[i] = prba[0] + 2*sum_{j=1..7} prba[j] cos(pi/8 j (i+.5))
_i8 = np.arange(8)[:, None].astype(np.float32)
_j8 = np.arange(8)[None, :].astype(np.float32)
IDCT8 = np.where(_j8 == 0, 1.0,
                 2.0 * cosf_fast_np((np.pi / 8.0) * _j8 * (_i8 + 0.5))
                 ).astype(np.float32)           # (8, 8)

# --- per-L static layout maps --------------------------------------------
# For each L in [9, 56]: block id and in-block index of each harmonic k,
# derived from HPG (frame.c:216-249).  Indexed by L-9.
BLOCK_OF = np.zeros((48, L_MAX), np.int32)
IDX_IN_BLOCK = np.zeros((48, L_MAX), np.int32)
for _l in range(48):
    _k = 0
    for _b in range(NB):
        for _j in range(HPG[_l, _b]):
            BLOCK_OF[_l, _k] = _b
            IDX_IN_BLOCK[_l, _k] = _j
            _k += 1
    assert _k == _l + 9, (_l, _k)
