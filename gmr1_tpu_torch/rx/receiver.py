"""GMR-1 channel state and control-message parsers (reference
src/gmr1_rx.c; counterpart of the host-side parts of
gmr1_tpu/rx/receiver.py that the wideband receiver uses).

The per-carrier `Receiver` class is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

START_DISCARD = 8000     # gmr1_rx.c:52


@dataclass
class Tch3State:          # gmr1_rx.c:60-80
    active: bool = False
    tn: int = 0
    p: int = 0
    ciph: int = 0
    energy_dkab: float = 0.0
    energy_burst: float = 0.0
    weak_cnt: int = 0
    ebits: np.ndarray = field(default_factory=lambda: np.zeros((4, 104), np.int8))
    bi_fn: np.ndarray = field(default_factory=lambda: np.full(4, -1, np.int64))
    sync_id: int = 0
    burst_cnt: int = 0


@dataclass
class Tch9State:          # gmr1_rx.c:82-91
    active: bool = False
    tn: int = 0
    il: object = None
    # first frame allowed into the CSD deinterleaver (rx_tch9 starts on
    # the frame AFTER the assignment, gmr1_rx.c:437-441)
    from_fn: int = 0


@dataclass
class ChanDesc:           # gmr1_rx.c:93-115
    sps: int
    align: int = START_DISCARD
    freq_err: float = 0.0
    fn: int = 0
    sa_sirfn_delay: int = 0
    sa_bcch_stn: int = 0
    bcch_energy: float = float("nan")   # gmr1_rx.c:858 (local in ref)
    tch3: Tch3State = field(default_factory=Tch3State)
    tch9: Tch9State = field(default_factory=Tch9State)


def bcch_tdma_align(cd: ChanDesc, l2: np.ndarray, sps: int) -> None:
    """Parse SI1 w/ Seg2Abis -> fn + slot realign (gmr1_rx.c:194-233)."""
    if (l2[0] & 0xF8) != 0x08 or (l2[9] & 0xFC) != 0x80:
        return
    l2 = [int(b) for b in l2]
    sa_sirfn_delay = (l2[10] >> 3) & 0x0F
    sa_bcch_stn = ((l2[10] << 2) & 0x1C) | (l2[11] >> 6)
    superframe = ((l2[11] & 0x3F) << 7) | (l2[12] >> 1)
    multiframe = ((l2[12] & 0x01) << 1) | (l2[13] >> 7)
    mffn_high = (l2[13] & 0x40) >> 6
    fn = (superframe << 6) | (multiframe << 4) | (mffn_high << 3) \
        | ((2 + sa_sirfn_delay) & 7)
    cd.align += (cd.sa_bcch_stn - sa_bcch_stn) * 39 * sps
    cd.fn = fn
    cd.sa_sirfn_delay = sa_sirfn_delay
    cd.sa_bcch_stn = sa_bcch_stn


def ccch_is_imm_ass(l2) -> bool:          # gmr1_rx.c:235-239
    return l2[1] == 0x06 and l2[2] == 0x3F


def ccch_imm_ass_parse(l2) -> tuple[int, int]:   # gmr1_rx.c:241-246
    p = (int(l2[8]) & 0xFC) >> 2
    tn = ((int(l2[8]) & 0x03) << 3) | (int(l2[9]) >> 5)
    return tn, p


def facch3_is_ass_cmd_1(l2) -> bool:      # gmr1_rx.c:248-252
    return l2[3] == 0x06 and l2[4] == 0x2E


def facch3_ass_cmd_1_parse(l2) -> int:    # gmr1_rx.c:254-258
    return ((int(l2[5]) & 0x03) << 3) | (int(l2[6]) >> 5)
