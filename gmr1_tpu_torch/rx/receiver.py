"""GMR-1 receiver application (reference src/gmr1_rx.c; counterpart of
gmr1_tpu/rx/receiver.py).

One carrier over mmap'd captures: control flow runs on the host (the
FSMs are tiny and sequential); the signal math of each burst - FCCH
sync, demod, FEC decode, A5/1 keystreams - runs on the receiver's
device, so a CUDA receiver launches the Viterbi and A5/1 kernels once
per burst.  Burst windows are host slices of the capture, moved to the
device one at a time; every decision reads its result back at once, in
the reference's order.

Flow (gmr1_rx.c:900-991):
  fcch_single_init -> fcch_multi_scan -> process_bcch per beam:
  per 40 ms TDMA frame: BCCH @ sirfn%8==2, CCCH others, the TCH3 FSM
  (DKAB / FACCH3 / speech) and the TCH9 FSM (FACCH9 / TCH9 CSD).

The channel state and the control-message parsers here are shared with
the wideband receiver.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import checked_device
from ..l1 import bcch, ccch, facch3, facch9, tch3, tch9
from ..ops import a5
from ..ops.interleave import InterleaverState
from ..sdr import bursts as BU
from ..sdr import dkab, fcch, modem
from ..sdr.defs import SYM_RATE
from . import gsmtap
from .cfile import CFile

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


def burst_energy(win: np.ndarray) -> float:
    """Mean |x|^2 excluding len>>5 border samples (gmr1_rx.c:172-182)
    over a planar (N, 2) host window: a float64 sum divided by n, rounded
    to float32 as the JAX package's native helper returns it."""
    win = np.asarray(win, np.float32)
    n = win.shape[0]
    b = n >> 5
    return float(np.float32(
        np.sum(win[b:n - b].astype(np.float64) ** 2) / n))


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


class Receiver:
    """One carrier receiver over mmap'd captures (gmr1_rx main).

    `device` is where each burst's math runs: the card by default, and
    without CUDA that raises."""

    def __init__(self, bcch_file: CFile, sps: int,
                 tch_file: CFile | None = None, kc: bytes | None = None,
                 tch_csd_file: CFile | None = None,
                 sink: gsmtap.GsmtapSink | None = None,
                 fcch_type: fcch.FcchBurst = fcch.FCCH,
                 verbose: bool = False,
                 device: str | torch.device = "cuda"):
        self.device = checked_device(device)
        self.bcch = bcch_file
        self.tch = tch_file
        self.tch_csd = tch_csd_file
        self.sps = sps
        self.kc = np.frombuffer(kc, np.uint8) if kc else np.zeros(8, np.uint8)
        self.sink = sink
        self.fcch_type = fcch_type
        self.verbose = verbose
        self.frames: list[tuple[int, int, int, bytes]] = []  # (type, fn, tn, l2)
        self.speech: list[bytes] = []    # decoded TCH3 vocoder frames
        self.csd: list[bytes] = []       # decoded TCH9 CSD blocks
        self._s_phase = None             # stream_run: None, acq, frames, done
        self._s_beams: list = []

    # --- helpers ---------------------------------------------------------

    def _log(self, msg: str) -> None:
        if self.verbose:
            print(msg)

    def _emit(self, chan_type: int, fn: int, tn: int, l2) -> None:
        l2b = bytes(bytearray(np.asarray(l2, np.uint8)))
        self.frames.append((chan_type, fn, tn, l2b))
        if self.sink is not None:
            self.sink.send(chan_type, fn, tn, l2b)

    def _dev(self, win: np.ndarray) -> torch.Tensor:
        """A host burst window on the receiver's device."""
        return torch.from_numpy(np.array(win, np.float32)).to(self.device)

    def _window(self, src, begin: int, length: int):
        w = src.window(begin, length)
        return None if w is None else self._dev(w)

    def _burst_map(self, cd: ChanDesc, burst_type, tn: int, win: int,
                   tch: int):
        """Window for a burst at slot tn (gmr1_rx.c:149-170).

        Returns (host planar window, e_toa) or (None, err)."""
        src = {0: self.bcch, 1: self.tch, 2: self.tch_csd}[tch]
        if src is None:
            return None, -1
        e_toa = win >> 1
        begin = cd.align + (self.sps * tn * 39) - e_toa
        length = burst_type.len_syms * self.sps + win
        if begin + length > len(self.bcch):     # bounds vs bcch (ref :164)
            return None, -2
        w = src.window(begin, length)
        if w is None:
            return None, -2
        return w, e_toa

    def _a5(self, n: int, fn: int, nbits: int):
        """Downlink A5/1 keystream of one frame on the device (None for
        A5/0): kernel A5 on a CUDA receiver."""
        if n == 0:
            return None
        fns = torch.tensor([fn], dtype=torch.int64, device=self.device)
        return a5.keystream(self.kc, fns, nbits, with_ul=False)[0][0]

    # --- acquisition (gmr1_rx.c:605-744) ---------------------------------

    def fcch_single_init(self, cd: ChanDesc) -> bool:
        n330 = (330 * SYM_RATE * self.sps) // 1000
        win = self._window(self.bcch, cd.align, n330)
        if win is None:
            return False
        cd.align += int(fcch.rough(self.fcch_type, win, self.sps))
        blen = self.fcch_type.len_syms * self.sps
        win = self._window(self.bcch, cd.align, blen)
        if win is None:
            return False
        toa, ferr = fcch.fine(self.fcch_type, win, self.sps)
        cd.align += int(toa)
        cd.freq_err = float(ferr)
        return True

    def fcch_multi_scan(self, cd: ChanDesc) -> list[int]:
        """Validated FCCH TOAs relative to base_align (gmr1_rx.c:643-729)."""
        blen = self.fcch_type.len_syms * self.sps
        base_align = max(cd.align - blen, 0)
        n650 = (650 * SYM_RATE * self.sps) // 1000
        win = self._window(self.bcch, base_align, n650)
        if win is None:
            return []
        mtoa = fcch.rough_multi(self.fcch_type, win, self.sps,
                                -cd.freq_err)
        out, ref_snr, ref_ferr = [], 0.0, 0.0
        for i, t in enumerate(mtoa):
            w = self._window(self.bcch, base_align + t, blen)
            if w is None:
                continue
            toa, ferr = fcch.fine(self.fcch_type, w, self.sps, -cd.freq_err)
            toa, ferr = int(toa), float(ferr)
            w = self._window(self.bcch, base_align + t + toa, blen)
            if w is None:
                continue
            snr = float(fcch.snr(self.fcch_type, w, self.sps,
                                 -(cd.freq_err + ferr)))
            if i == 0:
                ref_snr, ref_ferr = snr, ferr
            else:
                if snr < 2.0 or snr < ref_snr / 6.0:
                    continue
                if abs(ref_ferr - ferr) * SYM_RATE / (2 * np.pi) > 500.0:
                    continue
            self._log(f"[.] Potential FCCH @{base_align + t + toa} "
                      f"snr={snr:.1f}")
            out.append(t + toa)
        self._base_align = base_align
        return out

    # --- per-channel processing ------------------------------------------

    def rx_bcch(self, cd: ChanDesc) -> float | None:
        win, e_toa = self._burst_map(cd, BU.BCCH, cd.sa_bcch_stn,
                                     20 * self.sps, 0)
        if win is None:
            return None
        r = modem.demod(BU.BCCH, self._dev(win), sps=self.sps,
                        win=20 * self.sps, freq_shift=-cd.freq_err)
        l2, bad, _metric = bcch.decode(r.ebits)
        energy = burst_energy(win)
        if not int(bad):
            l2 = l2.cpu().numpy()
            cd.align += int(round(float(r.toa))) - e_toa
            cd.freq_err += float(r.freq_err)
            bcch_tdma_align(cd, l2, self.sps)
            self._emit(gsmtap.GMR1_BCCH, cd.fn, cd.sa_bcch_stn, l2)
            self._log(f"[.] BCCH fn={cd.fn} OK")
        return energy

    def rx_ccch(self, cd: ChanDesc, min_energy: float) -> None:
        win, _ = self._burst_map(cd, BU.DC6, cd.sa_bcch_stn,
                                 10 * self.sps, 0)
        if win is None:
            return
        if burst_energy(win) < min_energy:   # False for nan -> proceed
            return
        r = modem.demod(BU.DC6, self._dev(win), sps=self.sps,
                        win=10 * self.sps, freq_shift=-cd.freq_err)
        l2, bad, _metric = ccch.decode(r.ebits)
        if not int(bad):
            l2 = l2.cpu().numpy()
            if ccch_is_imm_ass(l2):
                st = cd.tch3
                st.active = True
                st.tn, st.p = ccch_imm_ass_parse(l2)
                st.energy_burst = min_energy * 0.75 if np.isfinite(
                    min_energy) else 0.0
                st.energy_dkab = st.energy_burst / 8.0
                st.weak_cnt = 0
                st.ciph = 0
                st.sync_id = 0
                st.ebits[:] = 0
                self._log(f"[+] TCH3 assigned on TN {st.tn}")
            self._emit(gsmtap.GMR1_CCCH, cd.fn, cd.sa_bcch_stn, l2)

    # --- TCH3 (gmr1_rx.c:356-600) ----------------------------------------

    def _tch3_facch_flush(self, cd: ChanDesc) -> None:
        st = cd.tch3
        eb = torch.as_tensor(st.ebits.reshape(-1).astype(np.int8),
                             device=self.device)

        def run(with_ciph: bool):
            ciph = torch.cat([
                self._a5(1, int(st.bi_fn[i]) & 0xFFFFFFFF, 96)
                for i in range(4)]) if with_ciph else None
            l2, _sbits, bad, _metric = facch3.decode(eb, ciph)
            return l2.cpu().numpy(), int(bad)

        l2, bad = run(bool(st.ciph))
        if st.ciph == 0 and bad:
            l2, bad = run(True)          # cipher retry (gmr1_rx.c:417-428)
            if not bad:
                st.ciph = 1
        if not bad:
            self._emit(gsmtap.GMR1_TCH3 | gsmtap.GMR1_FACCH,
                       cd.fn - 3, st.tn, l2)
            if facch3_is_ass_cmd_1(l2) and self.tch_csd is not None:
                cd.tch9.active = True
                cd.tch9.tn = facch3_ass_cmd_1_parse(l2)
                il = tch9.interleaver_init()
                cd.tch9.il = InterleaverState(buf=il.buf.to(self.device),
                                              n=il.n.to(self.device))
        st.sync_id ^= 1
        st.burst_cnt = 0
        st.bi_fn[:] = -1
        st.ebits[:] = 0

    def _rx_tch3_facch(self, cd: ChanDesc, win) -> None:
        st = cd.tch3
        bi = cd.fn & 3
        r = modem.demod(BU.NT3_FACCH, win, sps=self.sps,
                        win=self.sps + self.sps // 2,
                        freq_shift=-cd.freq_err)
        sync_id = int(r.sync_id)
        if sync_id != st.sync_id:
            self._tch3_facch_flush(cd)
        st.ebits[bi] = r.ebits.cpu().numpy()
        st.sync_id = sync_id
        st.bi_fn[bi] = cd.fn
        st.burst_cnt += 1
        if st.burst_cnt == 4:
            self._tch3_facch_flush(cd)

    def _rx_tch3_speech(self, cd: ChanDesc, win) -> None:
        st = cd.tch3
        r = modem.demod(BU.NT3_SPEECH, win, sps=self.sps,
                        win=self.sps + self.sps // 2,
                        freq_shift=-cd.freq_err)
        ciph = self._a5(st.ciph, cd.fn, 208)
        f0, f1, _sbits, _metrics = tch3.decode(r.ebits, ciph)
        self.speech.append(f0.cpu().numpy().tobytes())
        self.speech.append(f1.cpu().numpy().tobytes())

    def rx_tch3(self, cd: ChanDesc) -> None:
        st = cd.tch3
        if not st.active:
            return
        w = self.sps + self.sps // 2
        win, e_toa = self._burst_map(cd, BU.NT3_FACCH, st.tn, w, 1)
        if win is None:
            return
        be = burst_energy(win)
        win = self._dev(win)
        det = (st.energy_dkab + st.energy_burst) / 4.0
        if be < det:
            r = dkab.demod(win, self.sps, st.p, freq_shift=-cd.freq_err)
            if not bool(r.found):
                st.weak_cnt += 1
                if st.weak_cnt > 8:       # channel teardown
                    self._log(f"[-] TCH3 END @{cd.fn}")
                    st.active = False
            else:
                st.energy_dkab = 0.1 * be + 0.9 * st.energy_dkab
                self._emit(gsmtap.GMR1_TCH3 | gsmtap.GMR1_DKAB, cd.fn,
                           st.tn, r.ebits.cpu().numpy().view(np.uint8))
            return
        st.weak_cnt = 0
        st.energy_burst = 0.1 * be + 0.9 * st.energy_burst
        bt_id, _sid, _toa, _pwr = modem.detect(
            (BU.NT3_FACCH, BU.NT3_SPEECH), win, sps=self.sps, win=w,
            freq_shift=-cd.freq_err, e_toa=float(e_toa))
        if int(bt_id) == 0:
            self._rx_tch3_facch(cd, win)
        else:
            self._rx_tch3_speech(cd, win)

    # --- TCH9 (gmr1_rx.c:263-353) ----------------------------------------

    def rx_tch9(self, cd: ChanDesc) -> None:
        st = cd.tch9
        if not st.active:
            return
        w = self.sps + self.sps // 2
        win, _ = self._burst_map(cd, BU.NT9, st.tn, w, 2)
        if win is None:
            return
        r = modem.demod(BU.NT9, self._dev(win), sps=self.sps, win=w,
                        freq_shift=-cd.freq_err)
        ciph = self._a5(1, cd.fn, 658)
        if int(r.sync_id) == 0:          # FACCH9
            l2, _sacch, _status, bad, _metric = facch9.decode(r.ebits, ciph)
            if not int(bad):
                self._emit(gsmtap.GMR1_TCH9 | gsmtap.GMR1_FACCH,
                           cd.fn, st.tn, l2.cpu().numpy())
        else:                            # TCH9 9k6 CSD
            st.il, l2, _sacch, _status, _metric = tch9.decode(
                r.ebits, tch9.MODE_9K6, st.il, ciph)
            l2 = l2.cpu().numpy()
            self._emit(gsmtap.GMR1_TCH9, cd.fn, st.tn, l2)
            self.csd.append(l2.tobytes())

    # --- TDMA loop (gmr1_rx.c:852-895) -----------------------------------

    def _frame_step(self, cd: ChanDesc) -> None:
        """One TDMA frame of the per-beam FSM walk (the body of the
        reference's process loop, gmr1_rx.c:856-895)."""
        sirfn = (cd.fn - cd.sa_sirfn_delay) & 63
        if sirfn % 8 == 2:
            e = self.rx_bcch(cd)
            if e is not None:
                cd.bcch_energy = e
        if sirfn % 8 not in (0, 2):
            self.rx_ccch(cd, cd.bcch_energy / 2.0)
        self.rx_tch3(cd)
        self.rx_tch9(cd)
        cd.fn += 1
        cd.align += self.sps * 24 * 39

    def process_bcch(self, cd: ChanDesc) -> None:
        frame_len = self.sps * 24 * 39
        while True:
            self._frame_step(cd)
            if cd.align + 2 * frame_len > len(self.bcch):
                break

    def run(self) -> int:
        """Full receive: acquisition + all beams (gmr1_rx.c:961-975).

        Returns the number of L2 frames emitted."""
        cd = ChanDesc(sps=self.sps)
        if not self.fcch_single_init(cd):
            self._log("[!] primary FCCH acquisition failed")
            return 0
        self._log(f"[+] Primary FCCH @{cd.align} "
                  f"freq_err={cd.freq_err * SYM_RATE / 2 / np.pi:.1f} Hz")
        for t in self.fcch_multi_scan(cd):
            cdl = copy.deepcopy(cd)
            cdl.align = self._base_align + t
            self.process_bcch(cdl)
        return len(self.frames)

    # --- incremental drive over a growing stream --------------------------

    def _acq_need(self) -> int:
        """Stream prefix (samples) that guarantees every acquisition
        window access succeeds: the 330 ms rough scan from START_DISCARD
        plus the 650 ms multi-beam window anchored <= one burst before
        the refined primary TOA (fcch_single_init + fcch_multi_scan)."""
        n330 = (330 * SYM_RATE * self.sps) // 1000
        n650 = (650 * SYM_RATE * self.sps) // 1000
        blen = self.fcch_type.len_syms * self.sps
        return START_DISCARD + n330 + n650 + blen

    def stream_run(self, eof: bool = False) -> bool:
        """Incremental run() over a growing stream (cfile.BoundedStream).

        Call after each feed; processes every TDMA frame whose data is
        fully resident and returns without blocking for more.  With
        eof=True it drains to the exact end bound of the offline run().
        Per-beam frame sets are identical to run(); only the emission
        ORDER differs (beams interleave per call instead of completing
        sequentially).  Returns True once fully done.  The caller may
        trim() the stream below `stream_keep_from()` between calls."""
        if self._s_phase is None:
            self._s_phase = "acq"
        if self._s_phase == "done":
            return True
        frame_len = self.sps * 24 * 39
        if self._s_phase == "acq":
            if len(self.bcch) < self._acq_need() and not eof:
                return False
            cd = ChanDesc(sps=self.sps)
            if not self.fcch_single_init(cd):
                self._log("[!] primary FCCH acquisition failed")
                self._s_phase = "done"
                return True
            self._log(f"[+] Primary FCCH @{cd.align} "
                      f"freq_err={cd.freq_err * SYM_RATE / 2 / np.pi:.1f} Hz")
            for t in self.fcch_multi_scan(cd):
                cdl = copy.deepcopy(cd)
                cdl.align = self._base_align + t
                # [cd, started, done]: run()'s do-while processes the
                # first frame unconditionally, later frames only while
                # align + 2 frames fits the stream
                self._s_beams.append([cdl, False, False])
            self._s_phase = "frames"
        done = True
        for beam in self._s_beams:
            cd, started, bdone = beam
            if bdone:
                continue
            while True:
                fits = cd.align + 2 * frame_len <= len(self.bcch)
                if not started:
                    if not (fits or eof):
                        break
                    started = beam[1] = True
                elif not fits:
                    if eof:
                        bdone = beam[2] = True
                    break
                self._frame_step(cd)
            done = done and bdone
        if done and eof:
            self._s_phase = "done"
        return self._s_phase == "done"

    def stream_keep_from(self) -> int:
        """Oldest absolute stream position a future stream_run() call
        may still read (burst windows reach back e_toa before align;
        SI1 slot realign can move align back by up to ~1 frame)."""
        if self._s_phase in (None, "acq"):
            return 0
        live = [b[0].align for b in self._s_beams if not b[2]]
        if not live:
            return len(self.bcch)
        return max(0, min(live) - 2 * self.sps * 24 * 39)
