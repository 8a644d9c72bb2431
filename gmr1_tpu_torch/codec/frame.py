"""AMBE frame unpacking and parameter decoding (reference
src/codec/frame.c; counterpart of gmr1_tpu/codec/frame.py).

Batched, static-shape: the reference's variable harmonic count L in
[9, 56] becomes padded tensors of length L_MAX=56 with validity masks;
the per-block iDCTs with data-dependent lengths become elementwise cos
expressions over the block sizes; the bit unpacking is one gather and a
weighted sum.  float32 throughout, integers in int64.

All functions take/return leading batch axes.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from . import tables as T

# full float32 matmuls (TF32 rounds the operands to 10 mantissa bits)
torch.backends.cuda.matmul.allow_tf32 = False


@lru_cache(maxsize=None)
def const(name: str, device: torch.device) -> torch.Tensor:
    """A table of `tables` (by attribute name) as a tensor on device,
    copied there once."""
    arr = np.asarray(getattr(T, name))
    if arr.dtype.kind in "iu":
        arr = arr.astype(np.int64)
    return torch.as_tensor(arr, device=device)


@lru_cache(maxsize=None)
def _scalar(c: float, device: torch.device) -> torch.Tensor:
    return torch.tensor(c, dtype=torch.float32, device=device)


def div(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c rounded as one float32 division on every device (on a CUDA
    tensor PyTorch multiplies by the reciprocal of a scalar divisor)."""
    return x / (_scalar(c, x.device) if x.is_cuda else c)


def rdiv(c: float, x: torch.Tensor) -> torch.Tensor:
    """c / x rounded as one float32 division (a Python scalar divided by
    a tensor is x.reciprocal() * c in PyTorch, rounded twice).  The
    0-dim CPU tensor rides along as a scalar operand: no copy to the
    device."""
    return torch.tensor(c, dtype=torch.float32) / x


def exp2(x: torch.Tensor) -> torch.Tensor:
    """2**x rounded to float32 from float64, so that the CPU and the card
    agree bit for bit (their float32 exp2 differ in the last bit)."""
    return torch.exp2(x.to(torch.float64)).to(torch.float32)


def log2(x: torch.Tensor) -> torch.Tensor:
    """log2(x) rounded to float32 from float64 (see exp2)."""
    return torch.log2(x.to(torch.float64)).to(torch.float32)


class Subframe(NamedTuple):
    """Decoded subframe parameters (reference private.h:65-77), padded
    to L_MAX harmonics.  Ml is the *enhanced* magnitude when carried as
    the previous-subframe state (ambe.c:107-114 enhances in place
    before saving)."""
    f0log: torch.Tensor   # (...,) log2 fundamental
    f0: torch.Tensor      # (...,)
    L: torch.Tensor       # (...,) int64 harmonics count
    gain: torch.Tensor    # (...,)
    Mlog: torch.Tensor    # (..., 56) log2 magnitudes (raw, pre-enhance)
    Ml: torch.Tensor      # (..., 56) linear magnitudes
    Vl: torch.Tensor      # (..., 56) int64 per-harmonic voicing

    @property
    def w0(self):
        return self.f0 * (2.0 * np.pi)


def init_subframe(batch_shape=(), device="cpu") -> Subframe:
    """Initial previous-subframe state (ambe_decode_init, ambe.c:39-49):
    w0=0.09378, L=30, everything else zero (f0log included)."""
    z = torch.zeros(batch_shape, dtype=torch.float32, device=device)
    zl = torch.zeros((*batch_shape, T.L_MAX), dtype=torch.float32,
                     device=device)
    w0 = 0.09378
    return Subframe(
        f0log=z, f0=z + float(np.float32(w0 / (2 * np.pi))),
        L=torch.full(batch_shape, 30, dtype=torch.int64, device=device),
        gain=z, Mlog=zl, Ml=zl,
        Vl=torch.zeros((*batch_shape, T.L_MAX), dtype=torch.int64,
                       device=device))


# --- raw bit unpacking (frame.c:61-79) -----------------------------------

_FIELDS = {
    "pitch": [(0, 7, 0)],
    "pitch_interp": [(48, 2, 0)],
    "gain": [(7, 6, 2), (50, 2, 0)],
    "v_uv": [(13, 6, 0)],
    "sf1_prba12": [(19, 6, 1), (52, 1, 0)],
    "sf1_prba34": [(25, 3, 3), (53, 3, 0)],
    "sf1_prba57": [(28, 3, 4), (56, 4, 0)],
    "sf1_hoc0": [(31, 3, 4), (60, 4, 0)],
    "sf1_hoc1": [(34, 3, 3), (64, 3, 0)],
    "sf1_hoc2": [(37, 2, 4), (67, 4, 0)],
    "sf1_hoc3": [(39, 2, 3), (71, 3, 0)],
    "sf0_mag_interp": [(46, 2, 0)],
    "sf0_perr_14": [(41, 3, 3), (74, 3, 0)],
    "sf0_perr_58": [(44, 2, 3), (77, 3, 0)],
}

# all fields as one (80, n_fields) weight matrix: value = bits @ W
_NAMES = tuple(_FIELDS)
_FIELD_W = np.zeros((80, len(_NAMES)), np.int64)
for _f, _name in enumerate(_NAMES):
    for _p, _l, _s in _FIELDS[_name]:
        for _k in range(_l):
            _FIELD_W[_p + _k, _f] = 1 << (_l - 1 - _k + _s)


def unpack_raw(frames) -> dict[str, torch.Tensor]:
    """Frames (..., 10) uint8 -> dict of raw parameter ints (...,)."""
    frames = torch.as_tensor(frames).to(torch.int64)
    sh = torch.arange(7, -1, -1, device=frames.device)
    bits = ((frames[..., :, None] >> sh) & 1).reshape(
        *frames.shape[:-1], 80)
    w = torch.as_tensor(_FIELD_W, device=frames.device)
    vals = torch.sum(bits[..., :, None] * w, dim=-2)     # (..., n_fields)
    return {name: vals[..., f] for f, name in enumerate(_NAMES)}


# --- helpers -------------------------------------------------------------

def _take(x, idx, dim=-1):
    """take_along_axis with numpy's broadcasting of idx against x."""
    shape = list(torch.broadcast_shapes(x.shape[:dim % x.ndim] + (1,)
                                        + x.shape[dim % x.ndim + 1:],
                                        idx.shape[:dim % idx.ndim] + (1,)
                                        + idx.shape[dim % idx.ndim + 1:]))
    shape_x = list(shape)
    shape_x[dim] = x.shape[dim]
    shape[dim] = idx.shape[dim]
    return torch.gather(x.expand(shape_x), dim, idx.expand(shape))


def _interpolate_f0log(prev, cur, rule):
    """frame.c:87-122."""
    step = float(np.float32(4.2672e-2))
    neq = torch.stack([cur, 0.65 * cur + 0.35 * prev, (cur + prev) / 2.0,
                       prev], dim=-1)
    eq = torch.stack([cur, cur, cur + step, cur - step], dim=-1)
    sel = torch.where((cur != prev)[..., None], neq, eq)
    return _take(sel, rule[..., None])[..., 0]


def _compute_L(f0):
    """frame.c:128-141."""
    return torch.clamp(torch.floor(rdiv(0.4751, f0)).to(torch.int64),
                       T.L_MIN, T.L_MAX)


def _resample_mag(src, l_src, l_dst):
    """Resample + mean-removal (ambe_resample_mag, frame.c:149-181).

    src (..., 56) valid to l_src; returns (..., 56) valid to l_dst,
    with the mean over the first l_dst entries removed, zeros beyond.
    """
    i = torch.arange(T.L_MAX, dtype=torch.float32, device=src.device)
    step = l_src.to(torch.float32)[..., None] \
        / l_dst.to(torch.float32)[..., None]
    pos = step * (i + 1.0)
    posi = torch.floor(pos).to(torch.int64)
    lo = _take(src, torch.clamp(posi - 1, 0, T.L_MAX - 1))
    hi = _take(src, torch.clamp(posi, 0, T.L_MAX - 1))
    alpha = pos - posi.to(torch.float32)
    mid = lo * (1.0 - alpha) + hi * alpha
    first = src[..., :1]
    last = _take(src, l_src[..., None] - 1)
    val = torch.where(posi == 0, first,
                      torch.where(posi >= l_src[..., None], last, mid))
    mask = i < l_dst[..., None]
    val = torch.where(mask, val, 0.0)
    avg = torch.sum(val, dim=-1, keepdim=True) / l_dst[..., None]
    return torch.where(mask, val - avg, 0.0)


def _cosf(angle):
    """cosf_fast (math.c:50-55): the angle quantized to a 1024-entry grid
    (C-style truncation toward zero, then & 1023) and the table's cosine
    of the grid point, cos_tbl[i] = cos(pi*i/512) (math.c:38-43).  The
    JAX package computes the grid point's cosine instead (equal up to 1
    ulp); a gather from the one table gives the CPU and the card the same
    bits."""
    idx = (angle.to(torch.float32) * float(np.float32(512.0 / np.pi))
           ).to(torch.int32) & 1023
    return const("COS_TBL", angle.device)[idx.to(torch.int64)]


def _idct_traced(coef, n, m: int, n_out: int = T.L_MAX):
    """ambe_idct (math.c:99-114) with a per-element length n.

    coef (..., m); out[i] = coef[0] + 2*sum_{j=1..m-1} coef[j] *
    cosf_fast(pi/n * j * (i+0.5)) for i < n (masked beyond).
    """
    dev = coef.device
    i = torch.arange(n_out, dtype=torch.float32, device=dev)
    j = torch.arange(1, m, dtype=torch.float32, device=dev)
    ang = rdiv(np.pi, n.to(torch.float32))[..., None, None] \
        * j[:, None] * (i[None, :] + 0.5)              # (..., m-1, n_out)
    c = _cosf(ang)
    out = coef[..., :1] + 2.0 * torch.einsum("...j,...ji->...i",
                                             coef[..., 1:], c)
    return torch.where(i < n[..., None], out, 0.0)


# --- main parameter decode (frame.c:308-351) -----------------------------

def decode_params(rp: dict[str, torch.Tensor], sf_prev: Subframe
                  ) -> tuple[Subframe, Subframe]:
    """Raw params + previous subframe -> (sf0, sf1) with Mlog filled."""
    dev = sf_prev.f0.device

    def tab(name):
        return const(name, dev)

    # Fundamental (frame.c:317-322)
    f0log1 = float(np.float32(-4.312)) - float(np.float32(2.1336e-2)) \
        * rp["pitch"].to(torch.float32)
    f01 = exp2(f0log1)
    f0log0 = _interpolate_f0log(sf_prev.f0log, f0log1, rp["pitch_interp"])
    f00 = exp2(f0log0)

    L0, L1 = _compute_L(f00), _compute_L(f01)
    Lb1 = tab("HPG")[L1 - T.L_MIN]                   # (..., 4)

    # Voicing (frame.c:329-334)
    vuv = tab("V_UV")[rp["v_uv"]]
    i8 = torch.arange(8, device=dev)
    v0 = (vuv[..., None] >> (7 - i8)) & 1
    v1 = (vuv[..., None] >> (15 - i8)) & 1

    # Gain (frame.c:337-344)
    g = tab("GAIN")[rp["gain"]]
    gain0 = torch.clamp(0.5 * sf_prev.gain + g[..., 0], max=13.0)
    gain1 = torch.clamp(0.5 * sf_prev.gain + g[..., 1], max=13.0)

    # --- subframe 1 magnitudes (frame.c:188-256) ---
    pred = _resample_mag(sf_prev.Mlog, sf_prev.L, L1) * 0.65

    prba = torch.cat([
        torch.zeros((*f01.shape, 1), dtype=torch.float32, device=dev),
        tab("PRBA12")[rp["sf1_prba12"]],
        tab("PRBA34")[rp["sf1_prba34"]],
        tab("PRBA57")[rp["sf1_prba57"]],
    ], dim=-1)                                       # (..., 8)
    Ri = torch.einsum("...j,ij->...i", prba, tab("IDCT8"))

    rconst = float(np.float32(1.0 / (2.0 * np.sqrt(2.0))))
    C0 = (Ri[..., 0::2] + Ri[..., 1::2]) * 0.5       # (..., 4)
    C1 = (Ri[..., 0::2] - Ri[..., 1::2]) * rconst
    hoc_idx = torch.stack([rp[f"sf1_hoc{b}"] for b in range(4)], dim=-1)
    hoc = tab("HOC_ALL")[torch.arange(4, device=dev), hoc_idx]  # (..., 4, 4)
    C = torch.cat([C0[..., None], C1[..., None], hoc], dim=-1)  # (..., 4, 6)

    # per-harmonic block layout for this L (static maps, frame.c:242-246)
    blk = tab("BLOCK_OF")[L1 - T.L_MIN]              # (..., 56)
    jidx = tab("IDX_IN_BLOCK")[L1 - T.L_MIN]
    n_b = _take(Lb1, blk).to(torch.float32)
    Ck = _take(C, blk[..., None], dim=-2)            # (..., 56, 6)
    m = torch.arange(1, 6, dtype=torch.float32, device=dev)
    ang = rdiv(np.pi, n_b)[..., None] * m \
        * (jidx.to(torch.float32) + 0.5)[..., None]
    ck = Ck[..., 0] + 2.0 * torch.sum(Ck[..., 1:] * _cosf(ang), dim=-1)

    karr = torch.arange(T.L_MAX, device=dev)
    mask1 = karr < L1[..., None]
    L1f = L1.to(torch.float32)
    blocksum = torch.sum(C[..., 0] * Lb1.to(torch.float32), dim=-1)
    ofs = gain1 - 0.5 * log2(L1f) - blocksum / L1f
    Mlog1 = torch.where(mask1, pred + ck + ofs[..., None], 0.0)

    # --- subframe 0 magnitudes (frame.c:264-301) ---
    mag_p = _resample_mag(sf_prev.Mlog, sf_prev.L, L0)
    mag_c = _resample_mag(Mlog1, L1, L0)
    alpha = tab("SF0_INTERP")[rp["sf0_mag_interp"]]
    perr = torch.cat([
        torch.zeros((*f01.shape, 1), dtype=torch.float32, device=dev),
        tab("SF0_PERR14")[rp["sf0_perr_14"]],
        tab("SF0_PERR58")[rp["sf0_perr_58"]],
    ], dim=-1)                                       # (..., 9)
    corr = _idct_traced(perr, L0, 9)
    gain0t = gain0 - 0.5 * log2(L0.to(torch.float32))
    mask0 = karr < L0[..., None]
    Mlog0 = torch.where(
        mask0,
        gain0t[..., None] + corr + alpha[..., None] * mag_p
        + (1.0 - alpha)[..., None] * mag_c,
        0.0)

    sf0 = Subframe(f0log=f0log0, f0=f00, L=L0, gain=gain0, Mlog=Mlog0,
                   Ml=torch.zeros_like(Mlog0), Vl=_expand_vl(v0, f00, L0))
    sf1 = Subframe(f0log=f0log1, f0=f01, L=L1, gain=gain1, Mlog=Mlog1,
                   Ml=torch.zeros_like(Mlog1), Vl=_expand_vl(v1, f01, L1))
    return sf0, sf1


def _expand_vl(v_uv, f0, L):
    """Per-harmonic voicing from the 8 band bits (frame.c:366-368)."""
    i = torch.arange(T.L_MAX, dtype=torch.float32, device=f0.device)
    j = torch.clamp((i * 16.0 * f0[..., None]).to(torch.int64), 0, 7)
    vl = _take(v_uv, j)
    return torch.where(i < L[..., None], vl, 0)


def expand(sf: Subframe) -> Subframe:
    """Fill linear magnitudes Ml (ambe_subframe_expand, frame.c:357-373)."""
    w0 = sf.f0 * (2.0 * np.pi)
    unvc = rdiv(float(np.float32(0.2046)), torch.sqrt(w0))
    ml = div(exp2(sf.Mlog), 6.0)
    ml = torch.where(sf.Vl == 0, ml * unvc[..., None], ml)
    mask = torch.arange(T.L_MAX, device=sf.f0.device) < sf.L[..., None]
    return sf._replace(Ml=torch.where(mask, ml, 0.0))
