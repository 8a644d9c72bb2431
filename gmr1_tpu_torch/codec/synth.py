"""AMBE speech synthesis (reference src/codec/synth.c; counterpart of
gmr1_tpu/codec/synth.py), batched and static-shape.

  * spectral enhancement (synth.c:308-369): masked, vectorized over the
    56 padded harmonics;
  * unvoiced synthesis (synth.c:121-198): the LCG noise sequence in
    closed form (multiplier and offset powers precomputed instead of the
    sequential loop), the 128-point real DFT/iDFT as dense f32 matrix
    products against cosf_fast-quantized matrices, the band magnitude
    normalization as a one-hot segment sum, weighted overlap-add
    against the carried window;
  * voiced synthesis (synth.c:207-290): the per-harmonic oscillator bank
    as one masked (56, 80) outer product summed over the bands, the
    fine/coarse transition choice branch-free.

Synth state is a NamedTuple of tensors carried from frame to frame.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import tables as T
from .frame import Subframe, _cosf, _take, const, div, rdiv

# full float32 matmuls (TF32 rounds the operands to 10 mantissa bits)
torch.backends.cuda.matmul.allow_tf32 = False

LCG_A, LCG_C, LCG_M = 171, 11213, 53125   # synth.c:110


class SynthState(NamedTuple):
    u_prev: torch.Tensor    # (...,) int64 last LCG value
    uw_prev: torch.Tensor   # (..., 121) previous unvoiced window
    psi1: torch.Tensor      # (...,) fundamental phase
    phi: torch.Tensor       # (..., 56) per-harmonic phase
    SE: torch.Tensor        # (...,) energy tracker


def init_state(batch_shape=(), device="cpu") -> SynthState:
    """ambe_synth_init (synth.c:296-301): zeros, u_prev=3147."""
    def z(*shape):
        return torch.zeros((*batch_shape, *shape), dtype=torch.float32,
                           device=device)
    return SynthState(
        u_prev=torch.full(batch_shape, 3147, dtype=torch.int64,
                          device=device),
        uw_prev=z(T.UW_LEN), psi1=z(), phi=z(T.L_MAX), SE=z())


# --- closed-form LCG (synth.c:103-113) -----------------------------------
# u_i = (A^(i+1) u0 + C*(A^i + ... + 1)) mod M, precomputed per step;
# every product stays below 2^33 in int64.
LCG_MUL = np.zeros(T.UW_LEN, np.int64)
LCG_ADD = np.zeros(T.UW_LEN, np.int64)
_a, _b = 1, 0
for _i in range(T.UW_LEN):
    _a = (_a * LCG_A) % LCG_M
    _b = (_b * LCG_A + LCG_C) % LCG_M
    LCG_MUL[_i] = _a
    LCG_ADD[_i] = _b


def lcg_sequence(u_prev):
    """121 LCG values from u_prev (...,) -> (..., 121) int64."""
    dev = u_prev.device
    mul = torch.as_tensor(LCG_MUL, device=dev)
    add = torch.as_tensor(LCG_ADD, device=dev)
    return (mul * u_prev[..., None] + add) % LCG_M


# --- enhancement (synth.c:307-369) ---------------------------------------

def enhance(state: SynthState, sf: Subframe) -> tuple[SynthState, Subframe]:
    dev = sf.f0.device
    lmask = torch.arange(T.L_MAX, device=dev) < sf.L[..., None]
    lp1 = torch.arange(1, T.L_MAX + 1, dtype=torch.float32, device=dev)
    w0 = sf.w0
    sq = sf.Ml * sf.Ml
    rm0 = torch.sum(torch.where(lmask, sq, 0.0), dim=-1)
    cos_l = _cosf(w0[..., None] * lp1)
    rm1 = torch.sum(torch.where(lmask, sq * cos_l, 0.0), dim=-1)

    k1 = rdiv(0.96 * np.pi, w0 * rm0 * (rm0 * rm0 - rm1 * rm1))
    k2 = rm0 * rm0 + rm1 * rm1
    k3 = 2.0 * rm0 * rm1

    # the fourth root in float64, rounded once (as exp2 in frame.py)
    w = torch.sqrt(sf.Ml) * torch.pow(
        torch.clamp(k1[..., None] * (k2[..., None] - k3[..., None] * cos_l),
                    min=0.0).to(torch.float64), 0.25).to(torch.float32)
    w = torch.clamp(w, 0.5, 1.2)
    low = (lp1 * 8.0) <= sf.L[..., None].to(torch.float32)
    ml = sf.Ml * torch.where(low, 1.0, w)

    gamma_den = torch.sum(torch.where(lmask, ml * ml, 0.0), dim=-1)
    gamma = torch.sqrt(rm0 / torch.clamp(gamma_den, min=1e-30))
    ml = torch.where(lmask, ml * gamma[..., None], 0.0)

    se = torch.clamp(0.95 * state.SE + 0.05 * rm0, min=1e4)
    return state._replace(SE=se), sf._replace(Ml=ml)


# --- unvoiced synthesis (synth.c:120-198) --------------------------------

def _synth_unvoiced(state: SynthState, sf: Subframe):
    dev = sf.f0.device
    u = lcg_sequence(state.u_prev)                       # (..., 121)
    u_prev_new = u[..., 79]
    ws = const("WS", dev)
    uw = u.to(torch.float32) * ws

    uwi = uw @ const("DFT_COS", dev).T                   # (..., 65)
    uwq = uw @ const("DFT_SIN", dev).T

    # band edges e_l = ceil(128/(2pi) * (l+0.5 or 1.5...) * w0)
    c = float(np.float32(T.DFT_N / (2.0 * np.pi)))
    lidx = torch.arange(T.L_MAX + 1, dtype=torch.float32, device=dev)
    mult = torch.where(lidx == 0, 0.5, lidx + 0.5)       # e_0 uses 0.5
    edges = torch.ceil(c * mult * sf.w0[..., None])      # (..., 57)

    bins = torch.arange(T.DFT_BINS, dtype=torch.float32, device=dev)
    # band of bin i: number of edges <= i, minus 1 (-1 = below e_0)
    band = torch.sum((edges[..., None] <= bins).to(torch.int64), dim=-2) - 1

    e = uwi * uwi + uwq * uwq
    lrange = torch.arange(T.L_MAX, device=dev)
    onehot = (band[..., None, :] == lrange[:, None])     # (..., 56, 65)
    esum = torch.einsum("...li,...i->...l", onehot.to(torch.float32), e)
    cnt = torch.sum(onehot, dim=-1).to(torch.float32)
    ampl = 76.89 * sf.Ml / torch.sqrt(
        torch.clamp(esum / torch.clamp(cnt, min=1.0), min=1e-30))

    lmask = lrange < sf.L[..., None]
    keep = lmask & (sf.Vl == 0)                          # unvoiced bands
    factor_l = torch.where(keep, ampl, 0.0)              # (..., 56)
    valid = (band >= 0) & (band < sf.L[..., None])
    factor = torch.where(
        valid, _take(factor_l, torch.clamp(band, 0, T.L_MAX - 1)), 0.0)

    uwi = uwi * factor
    uwq = uwq * factor
    uw_new = uwi @ const("IDFT_COS", dev).T + uwq @ const("IDFT_SIN", dev).T

    # WOLA (synth.c:184-197)
    head = state.uw_prev[..., 60:81]                     # i in [0,21)
    a, b = ws[81:120], ws[1:40]                          # i in [21,60)
    num = a * state.uw_prev[..., 81:120] + b * uw_new[..., 1:40]
    den = a ** 2 + b ** 2
    mid = num / den
    tail = uw_new[..., 40:60]                            # i in [60,80)
    suv = torch.cat([head, mid, tail], dim=-1)
    return state._replace(u_prev=u_prev_new, uw_prev=uw_new), suv


# --- voiced synthesis (synth.c:206-290) ----------------------------------

def _synth_voiced(state: SynthState, sf: Subframe, sf_prev: Subframe):
    dev = sf.f0.device
    lp1 = torch.arange(1, T.L_MAX + 1, dtype=torch.float32, device=dev)
    L_max = torch.maximum(sf.L, sf_prev.L)
    band = torch.arange(T.L_MAX, device=dev)
    in_max = band < L_max[..., None]

    # L_uv counts unvoiced bands up to L_max (synth.c:219-221); the padded
    # Vl is zero beyond sf.L, which reads as "unvoiced" there, as in JAX
    # (the reference reads uninitialized stack, tests/test_codec.py:7-13)
    L_uv = torch.sum(torch.where(in_max, (sf.Vl == 0).to(torch.int64), 0),
                     dim=-1).to(torch.float32)

    two_pi = float(np.float32(2.0 * np.pi))
    psi_step = (sf.w0 + sf_prev.w0) * 40.0
    psi1_raw = state.psi1 + psi_step
    psi1 = psi1_raw - two_pi * torch.round(div(psi1_raw, two_pi))  # remainderf

    Lf = sf.L.to(torch.float32)
    rho_term = (L_uv / Lf)[..., None] * const("RHO", dev)
    rho_on = band >= (sf.L // 4)[..., None]

    phi_prev = state.phi
    phi_cur = psi1[..., None] * lp1 + torch.where(rho_on, rho_term, 0.0)
    # bands >= L_max get the rho term unconditionally (synth.c:288-289)
    phi_new = torch.where(in_max, phi_cur, psi1[..., None] * lp1 + rho_term)

    vl_cur = sf.Vl != 0                                  # padded 0 beyond L
    vl_prev = sf_prev.Vl != 0
    ml_cur = sf.Ml
    ml_prev = sf_prev.Ml
    w_cur = lp1 * sf.w0[..., None]
    w_prev = lp1 * sf_prev.w0[..., None]

    fine = vl_cur & vl_prev & (band < 7) \
        & (torch.abs(w_cur - w_prev) < 0.1 * w_cur)

    i = torch.arange(80, dtype=torch.float32, device=dev)       # (80,)
    ws = const("WS", dev)

    # fine transition (synth.c:258-270)
    ml_step = div(ml_cur - ml_prev, 80.0)
    dpl = phi_cur - phi_prev - (w_cur + w_prev) * 40.0
    dwl = div(dpl - two_pi * torch.floor(div(dpl + np.pi, two_pi)), 80.0)
    tha = w_prev + dwl
    thb = div(w_cur - w_prev, 160.0)
    ang_f = phi_prev[..., None] + (tha[..., None]
                                   + thb[..., None] * i) * i  # (..., 56, 80)
    sv_fine = (ml_prev[..., None] + i * ml_step[..., None]) * _cosf(ang_f)

    # coarse, current (synth.c:273-277): i in [21, 80)
    wmask_cur = torch.where(i >= 21, 1.0, 0.0) * ws[torch.clamp(
        (i - 20).to(torch.int64), 0, T.UW_LEN - 1)]
    sv_cur = wmask_cur * ml_cur[..., None] * _cosf(
        phi_cur[..., None] + w_cur[..., None] * (i - 80.0))

    # coarse, previous (synth.c:280-284): i in [0, 60)
    wmask_prev = torch.where(i < 60, 1.0, 0.0) * ws[torch.clamp(
        (i + 60).to(torch.int64), 0, T.UW_LEN - 1)]
    sv_prev = wmask_prev * ml_prev[..., None] * _cosf(
        phi_prev[..., None] + w_prev[..., None] * i)

    contrib = torch.where(fine[..., None], sv_fine,
                          torch.where(vl_cur[..., None], sv_cur, 0.0)
                          + torch.where(vl_prev[..., None], sv_prev, 0.0))
    sv = torch.sum(torch.where(in_max[..., None], contrib, 0.0), dim=-2)

    return state._replace(psi1=psi1, phi=phi_new), sv


def audio(state: SynthState, sf: Subframe, sf_prev: Subframe):
    """One subframe of audio (ambe_synth_audio, synth.c:377-389).

    Returns (new_state, audio (..., 80) float32 BEFORE the int16 cast;
    the caller quantizes once per frame)."""
    state, suv = _synth_unvoiced(state, sf)
    state, sv = _synth_voiced(state, sf, sf_prev)
    return state, (suv + 2.0 * sv) * 4.0
