"""Batched soft-decision Viterbi decoding for the GMR-1 code family.

Counterpart of gmr1_tpu/ops/viterbi.py.  Every GMR-1 trellis is radix-2
(the predecessors of state s are s>>1 and (s>>1) | S/2, input bit s&1),
so one generic decoder serves them all:

  * `decode_trellis` dispatches by device: a CUDA tensor always runs the
    hand-written kernel (kernels/viterbi.cu, the port of the TPU kernel
    gmr1_tpu/ops/pallas_viterbi.py `_vit_kernel`); a CPU tensor runs
    `decode_trellis_plain`, the plain ACS + traceback loop.  There is no
    fallback between the two.
  * Metrics are float32 correlations sum(soft * expected sign) with
    positive soft = bit 0.  Soft inputs are integer sbits, so every sum
    is an exact integer below 2^24 and both forms are bit-exact with the
    JAX scan (same c1 > c0 tie-break, first-max argmax, traceback rule).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .. import kernels
from . import consts
from .conv import TERM_FLUSH, ConvCode, encode

# full float32 matmuls, as everywhere in the port (TF32 rounds the
# operands to 10 mantissa bits)
torch.backends.cuda.matmul.allow_tf32 = False

NEG_INF = -1e30


@lru_cache(maxsize=None)
def _acs_tables(code: ConvCode) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(p0[S], p1[S], sign[S, 2, N]): the two predecessors of each state
    and the expected-bit sign (+1 for bit 0) of transition (s, b)."""
    s_cnt = code.num_states
    ns = np.arange(s_cnt)
    p0 = (ns >> 1).astype(np.int32)
    p1 = (p0 | (s_cnt >> 1)).astype(np.int32)
    sign = (1 - 2 * code.output_bits.astype(np.int32)).astype(np.float32)
    return p0, p1, sign


def _sign_rows(code: ConvCode) -> np.ndarray:
    return _acs_tables(code)[2].reshape(code.num_states * 2, code.n)


def depuncture(soft, keep_idx, out_len: int):
    """Scatter punctured soft bits (..., P) into erasure zeros (..., out_len).
    keep_idx: the surviving positions, a host array or a tensor
    (consts.table)."""
    soft = torch.as_tensor(soft).to(torch.float32)
    out = soft.new_zeros((*soft.shape[:-1], out_len))
    out[..., torch.as_tensor(keep_idx, device=soft.device)] = soft
    return out


def decode_trellis_plain(sym, sign, flush: bool):
    """Plain PyTorch radix-2 trellis decode (the kernel's reference).

    sym (B, T, n) float32 integer-valued sbits; sign (2S, n) float32
    expected signs, flat index 2*state + input bit.  Returns (bits (B, T)
    uint8, metric (B,) float32)."""
    b_cnt, t_steps, _ = sym.shape
    s_cnt = sign.shape[0] // 2
    half = s_cnt // 2
    bm = sym @ sign.T                                   # (B, T, 2S), exact
    m = sym.new_zeros((b_cnt, s_cnt))
    if flush:
        m[:, 1:] = NEG_INF
    dec = torch.empty((t_steps, b_cnt, s_cnt), dtype=torch.bool,
                      device=sym.device)
    for t in range(t_steps):
        c0 = m[:, :half].repeat_interleave(2, dim=1) + bm[:, t, :s_cnt]
        c1 = m[:, half:].repeat_interleave(2, dim=1) + bm[:, t, s_cnt:]
        dec[t] = c1 > c0
        m = torch.maximum(c0, c1)
    if flush:
        state = torch.zeros(b_cnt, dtype=torch.int64, device=sym.device)
        metric = m[:, 0].clone()
    else:
        state = torch.argmax(m, dim=1)                  # first max
        metric = torch.amax(m, dim=1)
    rows = torch.arange(b_cnt, device=sym.device)
    bits = torch.empty((b_cnt, t_steps), dtype=torch.uint8, device=sym.device)
    for t in range(t_steps - 1, -1, -1):
        bits[:, t] = (state & 1).to(torch.uint8)
        took = dec[t, rows, state].to(torch.int64)
        state = (state >> 1) | (took * half)
    return bits, metric


def _decode_trellis_cuda(sym, sign, flush: bool):
    """Launch kernels/viterbi.cu on CUDA tensors (raises on anything else)."""
    if not (sym.is_cuda and sign.is_cuda):
        raise ValueError("the Viterbi kernel takes CUDA tensors")
    if sym.dtype != torch.float32 or sign.dtype != torch.float32:
        raise TypeError("the Viterbi kernel takes float32 sym and sign")
    b_cnt, t_steps, n = sym.shape
    s_cnt = sign.shape[0] // 2
    if sign.shape != (2 * s_cnt, n) or not 1 <= n <= 5:
        raise ValueError(f"bad trellis shapes sym {tuple(sym.shape)} "
                         f"sign {tuple(sign.shape)}")
    if s_cnt not in (16, 32, 64, 128, 256):
        raise ValueError(f"unsupported state count {s_cnt}")
    sym, sign = sym.contiguous(), sign.contiguous()
    bits = torch.empty((b_cnt, t_steps), dtype=torch.uint8, device=sym.device)
    metric = torch.empty((b_cnt,), dtype=torch.float32, device=sym.device)
    kernels.launch("viterbi", sym.device, sym.data_ptr(), sign.data_ptr(),
                   bits.data_ptr(), metric.data_ptr(), b_cnt, t_steps, n,
                   s_cnt, int(flush))
    decode_trellis.launches += 1
    return bits, metric


def decode_trellis(sym, sign, flush: bool):
    """Radix-2 trellis decode of (B, T, n) integer sbits: the CUDA kernel
    for CUDA tensors, the plain version for CPU tensors."""
    if sym.is_cuda:
        return _decode_trellis_cuda(sym, sign, flush)
    if sym.device.type != "cpu":
        raise ValueError(f"no Viterbi decoder for device {sym.device}")
    return decode_trellis_plain(sym, sign, flush)


decode_trellis.launches = 0     # kernel launches (CUDA path only)


def decode(code: ConvCode, soft, in_len: int):
    """ML-decode soft bits (..., out_len(in_len)) -> (bits, metric).

    `soft` must already be de-punctured (zeros at erased positions).
    Returns decoded input bits (..., in_len) uint8 and the winning path
    metric (...,) float32.  Flush termination pins both endpoint states
    to zero; tail-biting starts all states equal and ends at the best."""
    soft = torch.as_tensor(soft).to(torch.float32)
    n = code.n
    t_steps = soft.shape[-1] // n
    batch_shape = soft.shape[:-1]
    sign = consts.table(_sign_rows, code, device=soft.device)
    bits, metric = decode_trellis(soft.reshape(-1, t_steps, n), sign,
                                  code.term == TERM_FLUSH)
    return (bits.reshape(*batch_shape, t_steps)[..., :in_len],
            metric.reshape(batch_shape))


def decode_punctured(code: ConvCode, soft, in_len: int, keep_idx: np.ndarray):
    """Convenience: de-puncture then decode."""
    full = depuncture(soft, keep_idx, code.out_len(in_len))
    return decode(code, full, in_len)


def distance(code: ConvCode, soft, bits_decoded, keep_idx=None):
    """Soft distance of the decoded word, libosmocore-flavoured:
    sum(|soft| - soft*sign)/2 over surviving positions."""
    sign = 1.0 - 2.0 * encode(code, bits_decoded).to(torch.float32)
    if keep_idx is not None:
        sign = sign[..., torch.as_tensor(np.asarray(keep_idx),
                                         device=sign.device)]
    soft = torch.as_tensor(soft).to(torch.float32)
    return torch.sum(torch.abs(soft) - soft * sign, dim=-1) / 2.0
