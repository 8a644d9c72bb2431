"""Batched pi/2-CBPSK / pi/4-CBPSK / pi/4-CQPSK modem (planar complex).

Counterpart of gmr1_tpu/sdr/modem.py (reference src/sdr/pi4cxpsk.c):

  normalize/derotate -> per-sync-sequence strided correlation ->
  sub-sample peak (TOA) -> best sync id -> align/decimate (sinc
  fractional delay for sps<4) -> chunk-phase fine frequency estimate ->
  derotate -> sync-phase derotation -> phase -> soft symbols ->
  quantized soft bits (the reference's quantizer, pi4cxpsk.c:479-499).

The integer alignment is one `torch.gather` of the winning offset's
symbol-spaced samples (the JAX package contracts a one-hot over every
candidate offset instead, a workaround for slow gathers on the TPU).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops import consts, cplx, dsp
from .bursts import Burst


class DemodResult(NamedTuple):
    ebits: torch.Tensor     # (..., ebits) int8 soft bits (osmocom sbit)
    sync_id: torch.Tensor   # (...,) int32 winning sync sequence
    toa: torch.Tensor       # (...,) float32 fractional TOA in samples
    freq_err: torch.Tensor  # (...,) float32 rad/symbol residual
    pwr: torch.Tensor       # (...,) float32 normalized correlation power


def _ref_planar(burst: Burst, sid: int, ci: int) -> np.ndarray:
    return cplx.planar_np(burst.sync_ref(sid)[ci])


def _data_pos(burst: Burst) -> np.ndarray:
    return burst.data_positions.astype(np.int64)


def _select(stacked, idx):
    """stacked (..., S) picked at idx (...,)."""
    return torch.gather(stacked, -1, idx[..., None].long())[..., 0]


def _sync_peaks(burst: Burst, y, sps: int, w: int):
    """Per-sync-id sub-sample TOA and normalized peak power of the
    combined |correlation| over the w-offset search window: two (..., S)
    tensors."""
    toas, pwrs = [], []
    for sid in range(burst.n_sync):
        acc, tl = None, 0
        for ci, chunk in enumerate(burst.sync[sid]):
            b = chunk.pos * sps
            seg = y[..., b:b + chunk.length * sps + w - 1, :]
            a = cplx.absv(dsp.correlate(
                consts.table(_ref_planar, burst, sid, ci, device=y.device),
                seg, sps))
            acc = a if acc is None else acc + a
            tl += chunk.length
        # |correlation| as a planar vector with zero imag: the peak
        # search sees the same energies as the JAX package
        planar = torch.stack([acc, torch.zeros_like(acc)], dim=-1)
        toa_s, peak = dsp.peak_energy_find(planar, 3, dsp.PEAK_EARLY_LATE)
        toas.append(toa_s)
        pwrs.append(cplx.abs2(peak) / float(tl) ** 2)
    return torch.stack(toas, dim=-1), torch.stack(pwrs, dim=-1)


def demod(burst: Burst, x, sps: int, win: int, freq_shift=0.0) -> DemodResult:
    """Demodulate burst windows x (..., burst.len_syms*sps + win, 2).

    freq_shift is radians/symbol pre-applied (the reference passes
    -freq_err); win is the TOA search window in samples."""
    sv, sync_id, toa, freq_err, pwr = soft_symbols(burst, x, sps, win,
                                                   freq_shift)
    return DemodResult(ebits=quantize(burst.mod.nbits, sv),
                       sync_id=sync_id.to(torch.int32), toa=toa,
                       freq_err=freq_err, pwr=pwr)


def soft_symbols(burst: Burst, x, sps: int, win: int, freq_shift=0.0):
    """demod() up to the quantizer: (soft symbols (..., n_data) in
    units of the symbol spacing, sync_id, toa, freq_err, pwr)."""
    x = cplx.tensor(x)
    dev = x.device
    n_len = burst.len_syms
    fs = torch.as_tensor(freq_shift, dtype=torch.float32, device=dev)
    y = dsp.sig_normalize(x, 1, (fs - burst.mod.rotation) / sps)
    w = y.shape[-2] - n_len * sps + 1
    if w != win + 1:
        raise ValueError(f"window length {x.shape[-2]} != burst + win {win}")

    # --- sync search over all sequences -------------------------------
    toa_all, pwr_all = _sync_peaks(burst, y, sps, w)
    sync_id = torch.argmax(pwr_all, dim=-1)
    toa = _select(toa_all, sync_id)
    pwr = _select(pwr_all, sync_id)

    # --- align & decimate to 1 sps ------------------------------------
    d_int = torch.clamp(torch.round(toa).to(torch.int64), 0,
                        y.shape[-2] - 1 - (n_len - 1) * sps)
    if sps < 4:
        y = dsp.fractional_delay(y, toa - torch.round(toa))
    pos = d_int[..., None] + sps * torch.arange(n_len, device=dev)
    z = torch.gather(y, -2, pos[..., None].expand(*pos.shape, 2))

    # --- fine frequency from inter-chunk phase slope ------------------
    freq_errs = []
    for sid in range(burst.n_sync):
        chunks = burst.sync[sid]
        if len(chunks) < 2:
            freq_errs.append(torch.zeros(z.shape[:-2], device=dev))
            continue
        corrs, centers = [], []
        for ci, chunk in enumerate(chunks):
            seg = z[..., chunk.pos:chunk.pos + chunk.length, :]
            ref = consts.table(_ref_planar, burst, sid, ci, device=dev)
            corrs.append(cplx.conj_dot(ref, seg))
            centers.append(chunk.pos + chunk.length / 2.0)
        f = 0.0
        for i in range(1, len(corrs)):
            f = f + (cplx.angle(cplx.conj_mul(corrs[i - 1], corrs[i]))
                     / (centers[i] - centers[i - 1]))
        freq_errs.append(f / (len(corrs) - 1))
    freq_err = _select(torch.stack(freq_errs, dim=-1), sync_id)
    i_n = torch.arange(n_len, dtype=torch.float32, device=dev)
    z = cplx.mul(z, cplx.expi(-freq_err[..., None] * i_n))

    # --- phase alignment via the sync sequence ------------------------
    phasors = []
    for sid in range(burst.n_sync):
        acc = z.new_zeros((*z.shape[:-2], 2))
        for ci, chunk in enumerate(burst.sync[sid]):
            seg = z[..., chunk.pos:chunk.pos + chunk.length, :]
            ref = consts.table(_ref_planar, burst, sid, ci, device=dev)
            acc = acc + cplx.conj_dot(ref, seg)
        phasors.append(acc)
    ph = torch.stack(phasors, dim=-2)
    phasor = torch.gather(
        ph, -2, sync_id[..., None, None].expand(*sync_id.shape, 1, 2)
    )[..., 0, :]
    z = cplx.mul(z, cplx.conj(cplx.normalize(phasor))[..., None, :])

    # --- phase -> soft symbols ----------------------------------------
    ssyms = cplx.angle(z) * ((1 << burst.mod.nbits) / (2.0 * np.pi))
    sv = ssyms[..., consts.table(_data_pos, burst, device=dev)]
    return sv, sync_id, toa, freq_err, pwr


def detect(bursts: tuple[Burst, ...], x, sps: int, win: int,
           freq_shift=0.0, e_toa=-1.0):
    """Classify which burst type is present (gmr1_pi4cxpsk_detect).

    Returns (bt_id, sync_id, toa, pwr) per batch element.  When
    e_toa >= 0 the candidate powers are divided by |e_toa - toa|
    (pi4cxpsk.c:657-659)."""
    x = cplx.tensor(x)
    dev = x.device
    fs = torch.as_tensor(freq_shift, dtype=torch.float32, device=dev)
    y = dsp.sig_normalize(x, 1, (fs - bursts[0].mod.rotation) / sps)
    e_toa = torch.as_tensor(e_toa, dtype=torch.float32, device=dev)
    sids, toas, pwrs = [], [], []
    for bt in bursts:
        w = y.shape[-2] - bt.len_syms * sps + 1
        if w != win + 1:
            raise ValueError(f"window length {x.shape[-2]} != burst + win "
                             f"{win}")
        t_all, p_all = _sync_peaks(bt, y, sps, w)
        sid = torch.argmax(p_all, dim=-1)
        toa_b = _select(t_all, sid)
        pwr_b = _select(p_all, sid)
        pwr_b = torch.where(
            e_toa >= 0,
            pwr_b / torch.clamp(torch.abs(e_toa - toa_b), min=1e-6), pwr_b)
        sids.append(sid.to(torch.int32))
        toas.append(toa_b)
        pwrs.append(pwr_b)
    pw = torch.stack(pwrs, dim=-1)
    bt_id = torch.argmax(pw, dim=-1)
    sync_id = _select(torch.stack(sids, dim=-1), bt_id)
    return (bt_id.to(torch.int32), sync_id,
            _select(torch.stack(toas, dim=-1), bt_id), _select(pw, bt_id))


def mod_order(x, sps: int, freq_shift=0.0):
    """Blind BPSK-vs-QPSK detect by comparing |sum x^2| vs |sum x^4|
    (gmr1_pi4cxpsk_mod_order, pi4cxpsk.c:694-729).  Returns 2 or 4."""
    x = cplx.tensor(x)
    fs = torch.as_tensor(freq_shift, dtype=torch.float32, device=x.device)
    y = dsp.sig_normalize(x, 1, (fs - np.pi / 4) / sps)
    v = cplx.mul(y, y) / torch.clamp(cplx.abs2(y), min=1e-30)[..., None]
    pb = cplx.abs2(torch.sum(v, dim=-2))
    pq = cplx.abs2(torch.sum(cplx.mul(v, v), dim=-2))
    return torch.where(pb < pq / 2.0, 4, 2)


def quantize(nbits: int, sv):
    """Soft symbols -> int8 soft bits: the reference's quantizer
    (pi4cxpsk.c:479-499) with its Gray bit map."""
    m_syms = 1 << nbits
    svr = torch.round(sv)
    sp = torch.remainder(svr.to(torch.int32), m_syms)
    ss = torch.remainder(torch.where(svr > sv, sp - 1, sp + 1), m_syms)
    d = torch.round(2.0 * torch.abs(svr - sv) * 64.0).to(torch.int32)

    def sym_bits(s):
        # Gray map: BPSK s -> [s]; CQPSK s -> [s>>1, (s>>1)^(s&1)]
        if nbits == 1:
            return s[..., None]
        return torch.stack([s >> 1, (s >> 1) ^ (s & 1)], dim=-1)

    vp, vs = sym_bits(sp), sym_bits(ss)
    dd = d[..., None]
    mag = 127 - torch.where(vp != vs, dd, dd >> 1)
    ebits = torch.where(vp != 0, -mag, mag)
    ebits = ebits.reshape(*ebits.shape[:-2], ebits.shape[-2] * nbits)
    return torch.clamp(ebits, -127, 127).to(torch.int8)


def mod(burst: Burst, ebits, sync_id: int = 0):
    """Modulate hard ebits (..., burst.ebits) -> planar (..., len_syms, 2)
    at 1 sps (gmr1_pi4cxpsk_mod, pi4cxpsk.c:742-799)."""
    ebits = torch.as_tensor(np.asarray(ebits) if not isinstance(
        ebits, torch.Tensor) else ebits).to(torch.int64)
    dev = ebits.device
    nbits = burst.mod.nbits
    nd = burst.ebits // nbits
    grouped = ebits.reshape(*ebits.shape[:-1], nd, nbits)
    packed = torch.zeros(grouped.shape[:-1], dtype=torch.int64, device=dev)
    for j in range(nbits):
        packed = (packed << 1) | grouped[..., j]
    sym_idx = torch.as_tensor(burst.mod.sym_of_bits, device=dev).long()[packed]
    syms = torch.zeros((*ebits.shape[:-1], burst.len_syms),
                       dtype=torch.int64, device=dev)
    syms[..., torch.as_tensor(burst.data_positions, device=dev).long()] = \
        sym_idx
    sym_val = torch.as_tensor(cplx.planar_np(burst.mod.sym_val), device=dev)
    out = sym_val[syms]                                  # (..., len_syms, 2)
    for chunk in burst.sync[sync_id]:                    # sync overrides
        ref = cplx.planar_np(burst.mod.sym_val[np.asarray(chunk.syms)])
        out[..., chunk.pos:chunk.pos + chunk.length, :] = torch.as_tensor(
            ref, device=dev)
    guard = np.ones(burst.len_syms, np.float32)          # guards zeroed
    guard[:burst.guard_pre] = 0
    guard[burst.len_syms - burst.guard_post:] = 0
    out = out * torch.as_tensor(guard, device=dev)[:, None]
    i = torch.arange(burst.len_syms, dtype=torch.float32, device=dev)
    return cplx.mul(out, cplx.expi(burst.mod.rotation * i))
