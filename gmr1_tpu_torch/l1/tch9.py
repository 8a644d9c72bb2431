"""TCH9 data channel coder (reference src/l1/tch9.c; counterpart of
gmr1_tpu/l1/tch9.py).

2.4/4.8/9.6 kbit/s over NT9 bursts: mode-specific conv code + puncture
triple -> 648 bits -> intra-interleave N=81 -> inter-burst interleave
depth 3 (functional state) -> scramble -> SACCH(10)+status(4) mux ->
cipher.  No CRC; correctness is judged by conv metric alone.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from ..ops import (bits, consts, conv, interleave, puncture, scramble,
                   viterbi)
from ..ops.interleave import InterleaverState

IL_N = 81
INTER_DEPTH = 3
INTER_WIDTH = 648
EBITS = 662


@dataclass(frozen=True)
class Tch9Mode:
    name: str
    code: conv.ConvCode
    conv_len: int
    l2_bytes: int
    punct: tuple  # (main, pre, post, repeat)


MODE_2K4 = Tch9Mode("2k4", conv.K5_15, 144, 18,
                    ("k5_15_P23", "k5_15_P53", "k5_15_Ps53", 41))
MODE_4K8 = Tch9Mode("4k8", conv.K5_13, 240, 30,
                    ("k5_13_P25", "k5_13_P15", "k5_13_Ps15", 41))
MODE_9K6 = Tch9Mode("9k6", conv.K5_12, 480, 60,
                    ("k5_12_P23", "k5_12_P25", "k5_12_Ps25", 158))
MODES = {m.name: m for m in (MODE_2K4, MODE_4K8, MODE_9K6)}


@lru_cache(maxsize=None)
def _keep_idx(mode: Tch9Mode) -> np.ndarray:
    main, pre, post, repeat = mode.punct
    keep = puncture.keep_indices(
        mode.code.out_len(mode.conv_len), mode.code.n, main, pre, post, repeat
    )
    if len(keep) != INTER_WIDTH:
        raise AssertionError((mode.name, len(keep)))
    return keep


def interleaver_init(dtype=torch.float32) -> InterleaverState:
    return interleave.interleaver_init(INTER_DEPTH, INTER_WIDTH, dtype=dtype)


def encode(l2, mode: Tch9Mode, bits_sacch, bits_status,
           il: InterleaverState, ciph=None):
    """One burst. Returns (new_il_state, bits_e (..., 662))."""
    u = bits.unpack_bits(l2, mode.conv_len)
    enc = conv.encode(mode.code, u)
    c = enc[..., consts.table(_keep_idx, mode, device=enc.device)]
    ep = interleave.interleave_intra(c, IL_N)
    il, epp = interleave.interleave_inter(il, ep)
    x = scramble.scramble_ubit(epp)
    my = torch.cat([x[..., :52], bits.like(bits_sacch, x), x[..., 52:648]],
                   dim=-1)
    if ciph is not None:
        my = my ^ bits.like(ciph, my)
    e = torch.cat([my[..., :52], bits.like(bits_status, my),
                   my[..., 52:658]], dim=-1)
    return il, e


def _demux(ebits, ciph):
    """Soft (..., 662) -> (status bits, SACCH soft bits, scrambled-off
    soft bits (..., 648))."""
    e = torch.as_tensor(ebits).to(torch.float32)
    bits_status = (e[..., 52:56] < 0).to(torch.uint8)
    my = torch.cat([e[..., :52], e[..., 56:662]], dim=-1)
    if ciph is not None:
        my = my * (1.0 - 2.0 * bits.like(ciph, my))
    bits_sacch = my[..., 52:62]
    x = torch.cat([my[..., :52], my[..., 62:658]], dim=-1)
    return bits_status, bits_sacch, scramble.scramble_sbit(x)


def _fec(ep, mode: Tch9Mode):
    """Deinterleaved soft bits (..., 648) -> (l2, metric)."""
    c = interleave.deinterleave_intra(ep, IL_N)
    full = viterbi.depuncture(
        c, consts.table(_keep_idx, mode, device=c.device),
        mode.code.out_len(mode.conv_len))
    u, metric = viterbi.decode(mode.code, full, mode.conv_len)
    return bits.pack_bits(u, mode.l2_bytes), metric


def decode_frames(ebits, mode: Tch9Mode, il: InterleaverState, ciph=None,
                  valid=None):
    """Decode F chained bursts (F, ..., 662) in one call.

    Only the depth-3 deinterleaver ring is sequential across bursts, so
    a short loop over the F frames carries just the ring and the Viterbi
    runs ONCE over the whole (F, ...) batch.  `il` may carry leading
    batch dims matching ebits[1:-1].  `valid` (F, ...) bool gates the
    ring per burst: where False the ring is untouched and that output
    slot is garbage (the receiver feeds only TCH9 bursts,
    gmr1_rx.c:321-347).  Returns (new_il, l2 (F, ..., l2_bytes), sacch,
    status, metric), identical to sequential decode() calls on the
    valid bursts."""
    bits_status, bits_sacch, epp = _demux(ebits, ciph)
    eps = []
    for f in range(epp.shape[0]):
        il, ep = interleave.deinterleave_inter(
            il, epp[f], None if valid is None else valid[f])
        eps.append(ep)
    l2, metric = _fec(torch.stack(eps), mode)
    return il, l2, bits_sacch, bits_status, metric


def decode(ebits, mode: Tch9Mode, il: InterleaverState, ciph=None):
    """One burst.  Returns (new_il, l2, sacch, status, metric).

    The l2 output corresponds to the burst INTER_DEPTH-1 frames ago once
    the interleaver has filled (reference semantics; tch9.c:167)."""
    bits_status, bits_sacch, epp = _demux(ebits, ciph)
    il, ep = interleave.deinterleave_inter(il, epp)
    l2, metric = _fec(ep, mode)
    return il, l2, bits_sacch, bits_status, metric
