"""The benchmark's traffic: GMR-1 downlink recordings and their truth.

A recording is what an SDR records of the L-band downlink: every live
carrier of the configuration at its own frequency, each with its own
payloads and its own random carrier phase, plus white noise.  `plan`
draws, on the host and from (seed, recording index), every burst each
carrier sends and the truth the receiver must reproduce; `synthesize`
builds the samples on the card with plain torch: each carrier's 4-sps
baseband (symbol impulses shaped by the raised-cosine spectrum, plus the
FCCH chirps and DKAB tones), one FFT a carrier, its band placed at the
carrier's bins of one wideband spectrum, one inverse FFT.  A bin is
1 / recording_s Hz on both sides, so the placement is exact.

The configuration's `arfcns` is the live range; a configuration whose
rate is off the 31.25 kHz grid states it as every grid column its
capture spans, as the sky fills them.  Two optional keys add what such a
deployment hears besides:
  beam2_every   every ARFCN of the live range that divides by it also
                carries a second spot beam (gmr1_rx.c:643-741): its own
                FCCH 3 frames after the first beam's, in place of the
                first beam's CCCH, and its own SI1s 3 frames after the
                first beam's, announcing sa_sirfn_delay 3.  Neither beam
                sends a CCCH or a call there, so every frame's fn says
                which beam sent it.  The second beam has its own timing:
                a few symbols after the first.  No public source gives
                the share of ARFCNs with two beams or what each sends:
                the key and this shape are chip_smoke.py's synthetic
                stream (build_stream(beam2=True)), not measured traffic.
  wide_channels [[arfcn, width], ...]: wide carriers, each FCCH, SI1 and
                a CCCH at width x 23.4 ksym/s (936-symbol frames at that
                rate) on the columns it spans, left empty for it with one
                guard column on each side; each has its own timing, and
                its frames are due from its own receiver's latency
                (`_wide_due`).

Control on every carrier: FCCH at k % 8 == 0, SI1 (BCCH) at k % 8 == 2
and a CCCH at k % 8 == 3 that is never an IMM.ASS unless it starts a call.
With `calls`, every carrier runs calls one after another from a random
start, alternating the two stories the receiver's tests cover, half the
carriers starting with each:
  e2e       IMM.ASS (TN 10, P 9); speech on TN 10 for `speech_s` seconds;
            FACCH3 ASS.CMD.1 to TN 13 on the next four frames aligned to
            fn % 4 == 0; two DKABs; FACCH9 on TN 13 with the first DKAB;
            a ciphered 9k6 CSD train of 5 bursts on TN 13; silence, so
            TCH3 tears down.
  reassign  IMM.ASS; ASS.CMD.1 to TN 13 at +1..+4, CSD on TN 13 at
            +5..+9, ASS.CMD.1 to TN 14 at +9..+12, CSD on TN 14 at
            +13..+17; silence.
The next call's IMM.ASS comes once TCH3 has torn down.  The receiver
keeps a TCH9 assignment until the next one, so between trains it decodes
the idle slot's noise every frame.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from . import coding, modem

SPS = 4
SYM_RATE = 23400.0
GRID = 31250.0
FRAME4 = modem.FRAME_SYMS * SPS          # 3744 samples a frame at 4 sps
TN3, P3 = 10, 9                          # the IMM.ASS TCH3 slot, DKAB P
TRAIN = 5                                # bursts of a CSD train
BEAM2_FRAMES = 3                         # frames a second beam lags by
# a carrier receiver's acquisition (gmr1_rx.c): samples it skips (:52),
# then the FCCH scan (:605) and the multi-beam scan from it (:643), in ms
# of 23.4 ksym/s at SPS samples a symbol
START_DISCARD, SCAN_MS, BEAMS_MS = 8000, 330, 650
KEY = bytes(8)                           # the receiver's default A5/1 key

# GSMTap channel types (libosmocore gsmtap.h)
BCCH, CCCH = 0x01, 0x02
FACCH3, DKAB = 0x10 | 0x02, 0x10 | 0x03
FACCH9, CSD = 0x18 | 0x02, 0x18
TYPE_NAMES = {BCCH: "BCCH", CCCH: "CCCH", FACCH3: "FACCH3", DKAB: "DKAB",
              FACCH9: "FACCH9", CSD: "CSD"}
# slots a burst of the type spans, and frames from its fn to its last burst
SLOTS = {BCCH: 6, CCCH: 6, FACCH3: 3, DKAB: 3, FACCH9: 9, CSD: 9}
LAST = {FACCH3: 3}


@dataclass
class Carrier:
    arfcn: int
    story: str | None = None           # first call's story, None: no calls
    beam: int = 0                      # 1: the ARFCN's second beam
    width: int = 1                     # subchannels of a wide carrier
    lead_s: float = 0.0                # noise before its frame 0


@dataclass
class Plan:
    """Everything a recording sends, and what the receiver owes for it."""
    fs: float
    center: float
    band_base: float
    n: int                              # samples at fs
    lead_s: float                       # noise before frame 0
    fn_base: int                        # fn of frame 0 (a multiple of 8)
    carriers: list
    due_from: int                       # first frame whose frames are due
    due_to: int                         # frames >= due_to are not due
    # bursts by kind: lists of (carrier index, frame k, slot, payload...)
    bursts: dict = field(default_factory=dict)
    # truth: (arfcn, type, fn) -> (bytes, due); CSD keyed at the fn the
    # deinterleaver yields it; speech: arfcn -> [frames in order]
    frames: dict = field(default_factory=dict)
    speech: dict = field(default_factory=dict)
    seed: int = 0
    index: int = 0
    by_content: dict | None = None     # check.judge's index, made once
    # (arfcn, type, fn) -> index of the carrier that sent it
    sender: dict = field(default_factory=dict)
    first: dict | None = None          # arfcn -> its first carrier, made once

    def two_beams(self) -> set:
        """The ARFCNs that carry a second beam."""
        return {c.arfcn for c in self.carriers if c.beam}

    def timing(self, arfcn: int, gtype: int, fn: int) -> Carrier:
        """The carrier whose timing a frame emitted at (arfcn, type, fn)
        follows: its sender, else the ARFCN's first carrier, else (a
        stray ARFCN) the first beam's."""
        ci = self.sender.get((arfcn, gtype, fn))
        if ci is None:
            if self.first is None:
                self.first = {}
                for i, c in enumerate(self.carriers):
                    self.first.setdefault(c.arfcn, i)
            ci = self.first.get(arfcn)
        if ci is not None:
            return self.carriers[ci]
        return Carrier(arfcn, lead_s=self.lead_s)

    def frame_end_s(self, arfcn: int, gtype: int, fn: int, tn: int) -> float:
        """Seconds from the recording's start to the end of the last
        burst of a frame the receiver emits as (arfcn, type, fn, tn), on
        the timing of the carrier that sent it."""
        c = self.timing(arfcn, gtype, fn)
        k = fn - self.fn_base + LAST.get(gtype, 0)
        syms = k * modem.FRAME_SYMS + (tn + SLOTS.get(gtype, 3)) * modem.SLOT
        return c.lead_s + syms / (SYM_RATE * c.width)


def _imm_ass(rng) -> np.ndarray:
    l2 = rng.integers(0, 256, 24, dtype=np.uint8)
    l2[1], l2[2] = 0x06, 0x3F
    l2[8] = ((P3 & 0x3F) << 2) | ((TN3 >> 3) & 3)
    l2[9] = (TN3 & 7) << 5
    return l2


def _ass_cmd_1(rng, tn9: int) -> np.ndarray:
    l2 = rng.integers(0, 256, 10, dtype=np.uint8)
    l2[3], l2[4] = 0x06, 0x2E
    l2[5] = (l2[5] & 0xFC) | ((tn9 >> 3) & 0x03)
    l2[6] = (l2[6] & 0x1F) | ((tn9 & 0x07) << 5)
    l2[9] &= 0xF0
    return l2


def off_grid(cfg: dict) -> bool:
    """Is the configuration's rate off the 31.25 kHz grid of its M
    channels (the receiver then pre-resamples the capture onto it)?"""
    return float(cfg["fs"]) != cfg["n_chans"] * GRID


def carriers(cfg: dict, mix: dict) -> list:
    """The configuration's carriers: every ARFCN of `arfcns` (a [first,
    last] range) but the columns of its wide carriers and their guards,
    then the second beams (`beam2_every`), then the wide carriers."""
    lo, hi = cfg["arfcns"]
    wide = cfg.get("wide_channels", [])
    empty = {b for a, w in wide
             for b in range(a - (w - 1) // 2 - 1, a + (w + 2) // 2 + 1)}
    every = cfg.get("beam2_every", 0)
    out, two = [], []
    for a in range(lo, hi + 1):
        if a in empty:
            continue
        if every and a % every == 0:
            out.append(Carrier(a))
            two.append(Carrier(a, beam=1))
        else:
            out.append(Carrier(a, ("e2e", "reassign")[a % 2]
                               if mix.get("calls") else None))
    return out + two + [Carrier(a, width=w) for a, w in wide]


def plan(cfg: dict, mix: dict, seed: int, index: int) -> Plan:
    """Draw recording `index` of `seed`: its carriers' bursts and truth."""
    rng = np.random.default_rng([seed, index])
    fs, rec_s = float(cfg["fs"]), float(mix["recording_s"])
    cars = carriers(cfg, mix)
    center = cfg["band_base_hz"] + GRID * cfg["center_arfcn"]
    n_frames = int(round(rec_s / 0.04))
    tail = cfg["block_frames"] + 3
    p = Plan(fs=fs, center=center, band_base=cfg["band_base_hz"],
             n=int(round(fs * rec_s)),
             lead_s=int(rng.uniform(*mix["lead_s"]) * SYM_RATE * SPS)
             / (SYM_RATE * SPS),
             fn_base=8 * int(rng.integers(2, 1 << 14)), carriers=cars,
             due_from=8, due_to=n_frames - tail - 2, seed=seed, index=index)
    b = {k: [] for k in ("fcch", "dkab", "bcch", "ccch", "speech", "facch3",
                         "facch9", "csd")}
    p.bursts = b
    two = p.two_beams()
    # the second beams' and the wide carriers' timing and payloads come
    # from a stream of their own: the first beams' draws stay as they are
    rng2 = np.random.default_rng([seed, index, 4])
    for c in cars:
        c.lead_s = p.lead_s
        if c.beam:
            c.lead_s += int(rng2.integers(0, 4 * modem.SLOT * SPS)) \
                / (SYM_RATE * SPS)
        elif c.width > 1:
            rate = SYM_RATE * c.width * SPS
            c.lead_s = int(rng2.uniform(*mix["lead_s"]) * rate) / rate

    def truth(ci, gtype, k, payload, due=(p.due_from, p.due_to)):
        key = (cars[ci].arfcn, gtype, p.fn_base + k)
        p.frames[key] = (bytes(payload), due[0] <= k < due[1])
        p.sender[key] = ci

    for ci, c in enumerate(cars):
        if c.width > 1:
            _wide(rng2, ci, c, p, b, truth, int(round(rec_s / 0.04))
                  * c.width)
            continue
        if c.beam:
            _beam2(rng2, ci, p, b, truth, n_frames)
            continue
        fr = n_frames - 1               # the last frame may not fit whole
        ks = np.arange(fr)
        b["fcch"] += [(ci, int(k), 0) for k in ks[ks % 8 == 0]]
        kb = ks[ks % 8 == 2]
        si1 = _si1s(rng, p.fn_base + kb, np.zeros_like(kb))
        for k, l2 in zip(kb.tolist(), si1):
            b["bcch"].append((ci, k, 0, l2))
            truth(ci, BCCH, k, l2)
        if c.arfcn in two:              # the second beam's FCCH is here
            continue
        if c.story is None:
            calls = set()
        else:
            calls = _calls(rng, c, ci, p, b, truth, mix["speech_s"])
        kc = [k for k in range(3, fr, 8) if k not in calls]
        l2s = rng.integers(0, 256, (len(kc), 24), dtype=np.uint8)
        l2s[:, 1] = 0x00                            # never an IMM.ASS
        for k, l2 in zip(kc, l2s):
            b["ccch"].append((ci, k, 0, l2))
            truth(ci, CCCH, k, l2)
    return p


def _beam2(rng, ci: int, p: Plan, b: dict, truth, n_frames: int) -> None:
    """An ARFCN's second beam: FCCH at k % 8 == 3 and SI1s announcing
    sa_sirfn_delay 3 at k % 8 == 5 (tests/test_wideband.py:255-290)."""
    ks = np.arange(n_frames - 1)
    b["fcch"] += [(ci, int(k), 0) for k in ks[ks % 8 == BEAM2_FRAMES]]
    kb = ks[ks % 8 == 2 + BEAM2_FRAMES]
    si1 = _si1s(rng, p.fn_base + kb, np.full_like(kb, BEAM2_FRAMES))
    for k, l2 in zip(kb.tolist(), si1):
        b["bcch"].append((ci, k, 0, l2))
        truth(ci, BCCH, k, l2)


def _wide_due(p: Plan, c: Carrier, n_frames: int) -> tuple[int, int]:
    """A wide carrier's due frames [first, last), from the latency of its
    own receiver.  That receiver reads the carrier's 4-sps stream, whose
    rate is width x 23.4 ksym/s, so its frames and its windows in samples
    are those of a narrow carrier.  It skips START_DISCARD samples, takes
    the FCCH of the SCAN_MS after them, and decodes from the strongest
    FCCH of the BEAMS_MS from there: that SI cycle, or one or two later,
    as the noise has it.  So frames are due from 16 (two cycles of the
    BEAMS_MS) after the last FCCH that starts inside the first scan.  It decodes a frame while two
    frames from its start lie inside its stream, and the stream runs to
    the recording's end (the block that holds it is fed whole): frames
    are due while three lie before that end, a frame of room for the
    channelizer's delay of under a millisecond."""
    lead = int(round(c.lead_s * SYM_RATE * c.width * SPS))
    scan_end = START_DISCARD + SCAN_MS * int(SYM_RATE) * SPS // 1000
    if lead >= scan_end:
        raise ValueError(f"wide carrier {c.arfcn}: no FCCH starts inside "
                         "its receiver's first scan")
    last_fcch = (scan_end - lead) // FRAME4 // 8 * 8
    later = BEAMS_MS * int(SYM_RATE) * SPS // 1000 // FRAME4 // 8 * 8
    due_to = int((p.n / p.fs - c.lead_s) * n_frames / (p.n / p.fs)) - 2
    return last_fcch + later, due_to


def _wide(rng, ci: int, c: Carrier, p: Plan, b: dict, truth,
          n_frames: int) -> None:
    """A wide carrier's control: FCCH, SI1 and a CCCH (never an IMM.ASS)
    every 8 of its frames, n_frames of them in the recording; due as
    `_wide_due` says."""
    ks = np.arange(n_frames - 1)
    b["fcch"] += [(ci, int(k), 0) for k in ks[ks % 8 == 0]]
    kb = ks[ks % 8 == 2]
    due = _wide_due(p, c, n_frames)
    for k, l2 in zip(kb.tolist(), _si1s(rng, p.fn_base + kb,
                                        np.zeros_like(kb))):
        b["bcch"].append((ci, k, 0, l2))
        truth(ci, BCCH, k, l2, due)
    kc = ks[ks % 8 == 3]
    l2s = rng.integers(0, 256, (len(kc), 24), dtype=np.uint8)
    l2s[:, 1] = 0x00
    for k, l2 in zip(kc.tolist(), l2s):
        b["ccch"].append((ci, k, 0, l2))
        truth(ci, CCCH, k, l2, due)


def _si1s(rng, fns: np.ndarray, delay: np.ndarray) -> np.ndarray:
    """SI1s with Seg2Abis encoding each fn (stn 0, sa_sirfn_delay)."""
    l2 = rng.integers(0, 256, (len(fns), 24), dtype=np.uint8)
    sf, mf, hb = fns >> 6, (fns >> 4) & 3, (fns >> 3) & 1
    l2[:, 0], l2[:, 9], l2[:, 10] = 0x08, 0x80, (delay & 0x0F) << 3
    l2[:, 11] = sf >> 7
    l2[:, 12] = ((sf & 0x7F) << 1) | (mf >> 1)
    l2[:, 13] = ((mf & 1) << 7) | (hb << 6)
    return l2


def _calls(rng, c: Carrier, ci: int, p: Plan, b: dict, truth,
           speech_s) -> set:
    """Schedule one carrier's calls; returns the frames of their IMM.ASS."""
    story = c.story
    k = 8 * int(rng.integers(1, 4)) + 3          # first IMM.ASS
    starts = set()
    speech = p.speech.setdefault(c.arfcn, [])

    def csd(k0, tn9):
        """A ciphered 9k6 CSD train of TRAIN bursts from frame k0."""
        pay = rng.integers(0, 256, (TRAIN, 60), dtype=np.uint8)
        b["csd"].append((ci, k0, tn9, pay))
        # the depth-3 deinterleaver yields payload j with burst j + 2,
        # and bursts 0 and 1 of a train with its ring half empty
        for j in range(TRAIN - 2):
            truth(ci, CSD, k0 + j + 2, pay[j])

    def facch3(k0, tn9):
        l2 = _ass_cmd_1(rng, tn9)
        b["facch3"].append((ci, k0, TN3, l2))
        truth(ci, FACCH3, k0, l2)

    while True:
        if story == "e2e":
            n_sp = int(rng.integers(round(25 * speech_s[0]),
                                    round(25 * speech_s[1]) + 1))
            kf = -(-(k + n_sp + 2) // 4) * 4     # FACCH3 on fn % 4 == 0
            end = kf + 16
        else:
            n_sp, kf, end = 0, k + 1, k + 23
        if end >= p.due_to:
            break
        starts.add(k)
        l2 = _imm_ass(rng)
        b["ccch"].append((ci, k, 0, l2))
        truth(ci, CCCH, k, l2)
        if story == "e2e":
            sp = rng.integers(0, 256, (n_sp, 2, 10), dtype=np.uint8)
            for j in range(n_sp):
                b["speech"].append((ci, k + 1 + j, TN3, sp[j, 0], sp[j, 1]))
                speech += [sp[j, 0].tobytes(), sp[j, 1].tobytes()]
            facch3(kf, 13)
            for j in (4, 5):
                bits = rng.integers(0, 2, 8, dtype=np.uint8)
                b["dkab"].append((ci, kf + j, TN3, bits))
                truth(ci, DKAB, kf + j, bits)
            l2 = rng.integers(0, 256, 38, dtype=np.uint8)
            l2[37] &= 0xF0                      # 300 message bits
            b["facch9"].append((ci, kf + 4, 13, l2))
            truth(ci, FACCH9, kf + 4, l2)
            csd(kf + 5, 13)
        else:
            facch3(k + 1, 13)
            csd(k + 5, 13)
            facch3(k + 9, 14)
            csd(k + 13, 14)
        # TCH3 tears down after 9 weak frames; the next IMM.ASS comes on
        # a CCCH frame (k % 8 == 3) after it, 0-2 cycles later
        k = -(-(end + 1 - 3) // 8) * 8 + 3 + 8 * int(rng.integers(0, 3))
        story = "reassign" if story == "e2e" else "e2e"
    return starts


# --------------------------------------------------------------------------
# synthesis on the device
# --------------------------------------------------------------------------

def _rc_spectrum(n4: int, dev) -> torch.Tensor:
    """DFT (n4 bins) of the raised-cosine pulse (beta 0.35, TX RRC x RX
    RRC) sampled at 4 sps: 4 x its continuous spectrum, f in cycles a
    symbol; zero past (1 + beta) / 2."""
    beta = 0.35
    f = torch.fft.fftfreq(n4, d=1.0 / SPS, device=dev,
                          dtype=torch.float64).abs()
    lo, hi = (1 - beta) / 2, (1 + beta) / 2
    h = torch.where(f <= lo, torch.ones_like(f),
                    0.5 * (1 + torch.cos(np.pi / beta * (f - lo))))
    return (SPS * torch.where(f >= hi, torch.zeros_like(f), h)).to(
        torch.complex64)


def _dkab_table() -> np.ndarray:
    """The 256 DKAB waveforms (bit patterns MSB first) at 4 sps."""
    bits = np.unpackbits(np.arange(256, dtype=np.uint8)[:, None], axis=1)
    return np.stack([modem.dkab(P3, b, SPS) for b in bits])


def _encoded(p: Plan, bursts: dict, ks: torch.Tensor, dev) -> list:
    """Every burst in `bursts` ({kind: [burst, ...]}, one chunk of
    carriers) as (carrier indices, start samples at each carrier's 4 sps
    on its own timing,
    waveforms (B, L) complex64, shaped): `shaped` for symbol streams at
    1 sps (pulse-shaped later), else raw 4-sps waveforms.  ks: the A5/1
    downlink keystreams of every frame of the recording (frame, 658)."""
    out = []
    lead = np.array([int(round(c.lead_s * SYM_RATE * c.width * SPS))
                     for c in p.carriers])

    def add(ci, k, tn, wave, shaped):
        st = lead[np.asarray(ci)] + np.asarray(k) * FRAME4 \
            + np.asarray(tn) * modem.SLOT * SPS
        out.append((np.asarray(ci), st, wave, shaped))

    def cols(r):
        return (np.array([x[0] for x in r]), np.array([x[1] for x in r]),
                np.array([x[2] for x in r]))

    def u8(r, i):
        return torch.as_tensor(np.stack([x[i] for x in r]), device=dev)

    r = bursts.get("fcch")
    if r:
        ch = torch.as_tensor(modem.fcch(SPS), dtype=torch.complex64,
                             device=dev)
        add(*cols(r), ch.expand(len(r), -1), False)
    r = bursts.get("dkab")
    if r:
        tab = torch.as_tensor(_dkab_table(), dtype=torch.complex64,
                              device=dev)
        idx = np.packbits(np.stack([x[3] for x in r]), axis=1)[:, 0]
        add(*cols(r), tab[torch.as_tensor(idx.astype(np.int64),
                                          device=dev)], False)
    r = bursts.get("bcch")
    if r:
        add(*cols(r), modem.mod(modem.BCCH, coding.bcch(u8(r, 3))), True)
    r = bursts.get("ccch")
    if r:
        add(*cols(r), modem.mod(modem.DC6, coding.ccch(u8(r, 3))), True)
    r = bursts.get("speech")
    if r:
        add(*cols(r), modem.mod(modem.NT3_SPEECH,
                                coding.tch3(u8(r, 3), u8(r, 4))), True)
    r = bursts.get("facch3")
    if r:
        ci, k, tn = cols(r)
        e = coding.facch3(u8(r, 3))                       # (B, 4, 104)
        j = np.arange(4)
        add(np.repeat(ci, 4), (k[:, None] + j).ravel(), np.repeat(tn, 4),
            modem.mod(modem.NT3_FACCH, e.reshape(-1, 104), 0), True)
    r = bursts.get("facch9")
    if r:
        ci, k, tn = cols(r)
        add(ci, k, tn, modem.mod(modem.NT9, coding.facch9(
            u8(r, 3), ks[torch.as_tensor(k, device=dev)]), 0), True)
    r = bursts.get("csd")
    if r:
        t_max = max(len(x[3]) for x in r)
        pay = np.zeros((len(r), t_max, 60), np.uint8)
        for i, x in enumerate(r):          # bursts past a train's end are
            pay[i, :len(x[3])] = x[3]      # padding: the interleaver is causal
        ci, k, tn = cols(r)
        kk = np.minimum(k[:, None] + np.arange(t_max), len(ks) - 1)
        e = coding.tch9_train(torch.as_tensor(pay, device=dev),
                              ks[torch.as_tensor(kk, device=dev)])
        live = np.arange(t_max)[None, :] < np.array([len(x[3])
                                                     for x in r])[:, None]
        e = e[torch.as_tensor(live, device=dev)]          # (bursts, 662)
        add(np.repeat(ci, live.sum(1)), kk[live],
            np.repeat(tn, live.sum(1)), modem.mod(modem.NT9, e, 1), True)
    return out


def synthesize(p: Plan, sigma: float, dev, chunk: int = 64) -> np.ndarray:
    """The recording's samples, planar (N, 2) float32 on the host.
    Carriers go in chunks of one group (first beams, second beams, each
    wide carrier), each group at its own symbol rate."""
    rec_s = p.n / p.fs
    big = torch.zeros(p.n, dtype=torch.complex64, device=dev)
    rng = np.random.default_rng([p.seed, p.index, 1])
    phase = rng.random(len(p.carriers))
    n_frames = int(round(rec_s / 0.04))
    ks = torch.as_tensor(coding.a5_dl(KEY, p.fn_base + np.arange(n_frames),
                                      658), device=dev)
    by_ci: dict = {}
    for kind, lst in p.bursts.items():
        for x in lst:
            by_ci.setdefault(x[0], {}).setdefault(kind, []).append(x)
    groups: list = []
    for ci, c in enumerate(p.carriers):
        if groups and groups[-1][0] == (c.width, c.beam):
            groups[-1][1].append(ci)
        else:
            groups.append(((c.width, c.beam), [ci]))
    for (width, _beam), cis in groups:
        n4 = int(round(rec_s * SYM_RATE * width * SPS))
        h = _rc_spectrum(n4, dev)
        half = int((0.675 * SYM_RATE * width + 3000.0) * rec_s)
        kb = torch.arange(-half, half + 1, device=dev)
        for j in range(0, len(cis), chunk):
            sel = np.asarray(cis[j:j + chunk])
            bursts: dict = {}
            for ci in sel.tolist():
                for kind, lst in by_ci.get(ci, {}).items():
                    bursts.setdefault(kind, []).extend(lst)
            _place(p, big, sel, _encoded(p, bursts, ks, dev), n4, h, kb,
                   phase, rec_s, dev)
    x = torch.fft.ifft(big)
    del big
    g = torch.Generator(device=dev)
    g.manual_seed(int(np.random.default_rng([p.seed, p.index, 2])
                      .integers(1 << 62)))
    out = torch.view_as_real(x)
    out.add_(torch.randn(out.shape, generator=g, device=dev) * sigma)
    return out.cpu().numpy()


def _place(p: Plan, big, sel: np.ndarray, enc: list, n4: int, h, kb,
           phase: np.ndarray, rec_s: float, dev) -> None:
    """Add the carriers `sel` (one chunk of one group, whose bursts are
    `enc`) at their bins of the wideband spectrum `big`."""
    c0 = int(sel[0])
    raw = torch.zeros((len(sel), n4), dtype=torch.complex64, device=dev)
    imp = torch.zeros_like(raw)
    for ci, st, wave, shaped in enc:
        row = torch.as_tensor(ci - c0, device=dev)
        step = SPS if shaped else 1
        off = torch.arange(wave.shape[-1], device=dev) * step
        idx = row[:, None] * n4 + torch.as_tensor(st, device=dev)[
            :, None] + off
        keep = idx < (row[:, None] + 1) * n4          # inside the file
        torch.view_as_real(imp if shaped else raw).view(-1, 2) \
            .index_add_(0, idx[keep], torch.view_as_real(
                wave.to(torch.complex64)[keep]))
    spec = torch.fft.fft(raw) + torch.fft.fft(imp) * h
    del raw, imp
    sub = spec[:, kb % n4]                           # (C, 2 half + 1)
    del spec
    rot = torch.as_tensor(np.exp(2j * np.pi * phase[sel]) * (p.n / n4),
                          dtype=torch.complex64, device=dev)
    off_hz = np.array([_freq(p, p.carriers[ci]) - p.center for ci in sel])
    gb = torch.as_tensor(np.round(off_hz * rec_s).astype(np.int64),
                         device=dev)[:, None] + kb
    val = torch.view_as_real(sub * rot[:, None])
    for par in (0, 1):      # neighbours' bands overlap: add the even
        # and the odd carriers apart, so no call adds twice to a bin
        # and the sum is the same on every run
        torch.view_as_real(big).index_add_(
            0, (gb[par::2] % p.n).reshape(-1),
            val[par::2].reshape(-1, 2))


def _freq(p: Plan, c: Carrier) -> float:
    """A carrier's center: on its grid line, half a channel up for an
    even width (channelizer.arfcn.Channel.frequency's rule)."""
    return p.band_base + GRID * (c.arfcn + 0.5 * (c.width % 2 == 0))
