"""Block-streamed wideband control-channel receiver.

Counterpart of gmr1_tpu/rx/wideband.py `WidebandReceiver` in its
single-device form (`mesh=None`, one FCCH beam per carrier, narrow
carriers, float32 ingest): one wideband capture in, every carrier's
BCCH and CCCH L2 frames out.

  acquisition  the capture prefix streams through the ingest step twice:
               pass 1 accumulates the FCCH dual-chirp correlation power
               per block, pass 2 gathers each candidate's fine/SNR window
               (one gather per block), then fine TOA, frequency and SNR.
  ingest step  once per TDMA block (block_frames frames, 0.32 s at 8):
               PFB analysis of the block with the carried overlap-save
               halo -> per-carrier RRC resample by ONE per-frame window
               matrix with the carried bank history -> rolling stream
               buffer of (F+1) frames of tail + F new frames per carrier.
  control      BCCH + CCCH windows gathered from the device-resident
  phase        streams, demodulated and decoded for every carrier in one
               batch (`_ctrl_core`); a few result tensors come back.
  host walk    the per-carrier control FSM (gmr1_rx.c:746-850): SI1
               frame-number / slot realign, closed-loop time and
               frequency corrections applied at the next block boundary,
               CCCH energy gate, IMM.ASS channel state, GSMTap output.

The traffic channels (TCH3/TCH9, FACCH, DKAB) and the other JAX-side
options (`mesh`, `beams > 1`, `wide_channels`, int16 ingest) are not
ported yet: an IMM.ASS sets the carrier's TCH3 state exactly as the JAX
receiver does, but no traffic phase runs.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..channelizer.arfcn import _BASES, BASE_BANDWIDTH
from ..channelizer.pfb import Channelizer
from ..l1 import bcch, ccch
from ..ops import cplx
from ..sdr import bursts as BU
from ..sdr import fcch, modem
from ..sdr.defs import SYM_RATE
from . import gsmtap
from .cfile import ArraySource, SampleSource
from .receiver import (ChanDesc, bcch_tdma_align, ccch_imm_ass_parse,
                       ccch_is_imm_ass)

torch.backends.cuda.matmul.allow_tf32 = False   # the RRC window matmul is f32

ROWS_PER_FRAME = 2500     # bank rows per TDMA frame: 936*62500/23400


def _energy(w):
    """Mean |x|^2 excluding len>>5 border samples (gmr1_rx.c:172-182)."""
    n = w.shape[-2]
    b = n >> 5
    return torch.sum(cplx.abs2(w[..., b:n - b, :]), dim=-1) / n


def _windows_rows(streams, rows, idx, wlen: int):
    """streams (M, Ns, 2), rows (C,), idx (C, F) -> (C, F, wlen, 2).

    One gather fusing the carrier-row select with the window slice;
    starts are clamped into [0, Ns - wlen] like the JAX dynamic_slice."""
    ns = streams.shape[1]
    start = torch.clamp(idx, 0, ns - wlen)
    pos = start[..., None] + torch.arange(wlen, device=streams.device)
    return streams.reshape(-1, 2)[rows[:, None, None] * ns + pos]


def _acq_pwr_block(ft, buf, sps: int, t_tail: int):
    """Incremental FCCH scan, one block: symbol-rate dual-chirp
    correlation power for the windows ENDING in this block's new samples
    (buf is the (M, T_buf, 2) stream buffer) -> (M, S_b/sps)."""
    y = buf[:, ::sps]
    return fcch.scan_pwr(ft, y[:, t_tail // sps - (ft.len_syms - 1):])


def _acq_fine_snr(ft, w3, off, sps: int, blen: int):
    """Fine TOA + freq err + SNR per candidate from its margin window
    w3 (C, 3*blen, 2) with the rough TOA at offset `off` (C,).  Returns
    (rel in [0, 2*blen], freq_err, snr)."""
    rows = torch.arange(w3.shape[0], device=w3.device)

    def cut(o):
        return _windows_rows(w3, rows, o[:, None], blen)[:, 0]
    toa_f, ferr = fcch.fine(ft, cut(off), sps)
    rel = torch.clamp(off + toa_f, 0, 2 * blen)
    return rel, ferr, fcch.snr(ft, cut(rel), sps, -ferr)


def _ctrl_core(streams, rows, fs, idx_b, idx_c, sps: int):
    """BCCH + CCCH windows: demod + FEC decode (gmr1_rx.c:746-850)."""
    win_b, win_c = 20 * sps, 10 * sps
    wb = _windows_rows(streams, rows, idx_b, BU.BCCH.len_syms * sps + win_b)
    rb = modem.demod(BU.BCCH, wb, sps=sps, win=win_b, freq_shift=fs)
    l2b, badb, _ = bcch.decode(rb.ebits)
    wc = _windows_rows(streams, rows, idx_c, BU.DC6.len_syms * sps + win_c)
    rc = modem.demod(BU.DC6, wc, sps=sps, win=win_c, freq_shift=fs)
    l2c, badc, _ = ccch.decode(rc.ebits)
    return dict(l2b=l2b, badb=badb, toab=rb.toa, ferrb=rb.freq_err,
                eb=_energy(wb), l2c=l2c, badc=badc, ec=_energy(wc))


@dataclass
class _Carrier:
    col: int                 # channel-bank column
    arfcn: int
    cd: ChanDesc
    snr: float
    frames: list = field(default_factory=list)   # (type, fn, tn, bytes)
    bcch_energy: float = float("nan")
    done: bool = False


class WidebandReceiver:
    """Decode the control channels of every carrier of a wideband capture
    (see the module doc).

    `wb` is planar float32 (N, 2), complex64 (N,) host samples or a
    `cfile.SampleSource`.  `device` is where the streams live and every
    phase runs; "cuda" on a machine without CUDA raises.  The remaining
    arguments are the JAX receiver's; `mesh`, `beams`, `wide_channels`
    and `h2d_dtype` accept only their defaults so far.
    """

    def __init__(self, wb, samp_rate: float, center_freq: float,
                 sps: int = 4, kc: bytes | None = None,
                 sink: gsmtap.GsmtapSink | None = None,
                 arfcns: list[int] | None = None, snr_min: float = 2.0,
                 block_frames: int = 8, fcch_type: fcch.FcchBurst = fcch.FCCH,
                 band: str = "L", uplink: bool = False,
                 verbose: bool = False, mesh=None, beams: int = 1,
                 wide_channels=None, h2d_dtype: str = "float32",
                 device: str | torch.device = "cpu"):
        unported = [name for name, off in (
            ("mesh", mesh is not None), ("beams", beams != 1),
            ("wide_channels", bool(wide_channels)),
            ("h2d_dtype", h2d_dtype != "float32")) if off]
        if unported:
            raise NotImplementedError(
                f"not ported yet: {', '.join(unported)} (single device, one "
                "beam, narrow carriers, float32 ingest only)")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device='cuda' was asked for, but "
                               "torch.cuda.is_available() is false")
        self.sps = sps
        self.kc = np.frombuffer(kc, np.uint8) if kc else np.zeros(8, np.uint8)
        self.sink = sink
        self.snr_min = snr_min
        self.block_frames = block_frames
        self.fcch_type = fcch_type
        self.verbose = verbose
        self.base_freq = _BASES[(band, uplink)]
        self.chz = Channelizer(samp_rate, center_freq, sps=sps)
        self.rrc = self.chz._rrc_resampler(1)
        if not isinstance(wb, SampleSource):
            wb = ArraySource(np.asarray(wb))
        # samples are consumed strictly forward; only the acquisition
        # prefix blocks are kept (on the device) for replay
        self._src = wb
        self._rotate = bool(self.chz.rotation)
        self._replay_dev: list = []
        self._n_pulled = 0           # samples pulled from the source
        self._n_in = 0               # samples consumed by the block loop
        self._eof = False
        self.n_stream = None         # known at EOF
        self.arfcn_filter = arfcns
        self.carriers: list[_Carrier] = []
        self.frames: list[tuple[int, int, int, int, bytes]] = []
        # wall-clock per pipeline section, accumulated across run()
        self.prof: dict[str, float] = {}
        self._build_ingest()

    def _tick(self, key: str, t0: float) -> float:
        t1 = time.perf_counter()
        self.prof[key] = self.prof.get(key, 0.0) + (t1 - t0)
        return t1

    # --- streamed ingest -------------------------------------------------

    def _build_ingest(self) -> None:
        F, sps, dev = self.block_frames, self.sps, self.device
        ana = self.chz.analyzer
        m = self.chz.n_chans
        self.frame_out = 936 * sps
        self.R_b = F * ROWS_PER_FRAME
        self.S_b = F * self.frame_out
        self.T_tail = (F + 1) * self.frame_out
        self.T_buf = self.T_tail + self.S_b
        self.n_block = self.R_b * ana.hop
        self._halo_len = ana.p * m
        self._hist = self.rrc.tpb
        # one per-frame RRC window matrix: outputs [f*frame_out,
        # (f+1)*frame_out) of the block come from rows_full[k0 + f*2500,
        # + k_span) — the geometry repeats exactly every frame
        k_min1, w = self.rrc.window_matrix(self.frame_out, self.frame_out)
        self._k0 = k_min1 - ROWS_PER_FRAME + self._hist
        if self._k0 < 0:
            raise ValueError(f"RRC history too short ({k_min1}, {self._hist})")
        self._k_span = w.shape[1]
        self._w_t = torch.as_tensor(w.T.copy(), device=dev)  # (k_span, n)
        self._state = (
            torch.zeros((self._halo_len, 2), device=dev),
            torch.zeros((m, self._hist, 2), device=dev),
            torch.zeros((m, self.T_tail, 2), device=dev))

    def _resample(self, rows_full):
        """(M, H + R_b, 2) bank rows -> (M, S_b, 2) carrier streams."""
        f_cnt = self.block_frames
        span = self._k0 + (f_cnt - 1) * ROWS_PER_FRAME + self._k_span
        xw = rows_full[:, self._k0:span].unfold(1, self._k_span,
                                                ROWS_PER_FRAME)
        m = xw.shape[0]
        # one 2-D GEMM over (M*F*2, k_span) rows: matmul on the 4-D
        # window view runs as a batched product on a far slower path
        s = (xw.reshape(-1, self._k_span) @ self._w_t).view(
            m, f_cnt, 2, -1)                              # (M, F, 2, n)
        return s.transpose(2, 3).reshape(m, self.S_b, 2)

    def _step(self, x, halo, bank_hist, stream_tail):
        """One ingest step: (new samples, carried state) -> (streams,
        next state)."""
        blk = torch.cat([halo, x])
        rows = self.chz.analyzer.block(blk).permute(1, 0, 2)   # (M, R_b, 2)
        rows_full = torch.cat([bank_hist, rows], dim=1)
        stream = torch.cat([stream_tail, self._resample(rows_full)], dim=1)
        return stream, (blk[-self._halo_len:], rows_full[:, -self._hist:],
                        stream[:, -self.T_tail:])

    def _put(self, x: np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    def _rotate_x(self, x: np.ndarray, n0: int) -> np.ndarray:
        """Grid pre-rotation with exact float64 phase from absolute
        sample offset n0."""
        if not (self._rotate and x.shape[0]):
            return x
        ph = self.chz.rotation * (
            n0 + np.arange(x.shape[0], dtype=np.float64))
        ph = np.mod(ph, 2.0 * np.pi).astype(np.float32)
        c, s = np.cos(ph), np.sin(ph)
        return np.stack([x[:, 0] * c - x[:, 1] * s,
                         x[:, 0] * s + x[:, 1] * c], axis=-1)

    def _pull(self, n: int) -> np.ndarray:
        """Read n samples from the source (short at EOF), rotated."""
        x = self._rotate_x(np.asarray(self._src.read(n), np.float32),
                           self._n_pulled)
        self._n_pulled += x.shape[0]
        return x

    def _pull_block(self) -> tuple[np.ndarray, int]:
        """Next n_block samples, zero-padded at EOF, + the valid count."""
        x = self._pull(self.n_block)
        nv = x.shape[0]
        if nv < self.n_block:
            x = np.concatenate(
                [x, np.zeros((self.n_block - nv, 2), np.float32)])
        return x, nv

    def _pin_eof(self, n_valid: int) -> None:
        """A short block pins the stream length (EOF)."""
        if n_valid < self.n_block and not self._eof:
            self._eof = True
            rows = self._n_in // self.chz.analyzer.hop
            self.n_stream = int(np.floor(rows * self.rrc.ratio))

    def _next_put_block(self):
        """Next block on the device: the acquisition replay list first,
        then the source."""
        if self._replay_dev:
            x, nv = self._replay_dev.pop(0)
        else:
            x, nv = self._pull_block()
            x = self._put(x)
        self._n_in += nv
        self._pin_eof(nv)
        return x

    def _ingest_block(self, b: int) -> None:
        """Run the ingest step for block b; sets self.streams (M, T_buf,
        2) and self._buf0 (absolute output sample of buffer index 0)."""
        t = time.perf_counter()
        self.streams, self._state = self._step(self._next_put_block(),
                                               *self._state)
        self._buf0 = b * self.S_b - self.T_tail
        self._tick("ingest", t)

    # --- helpers -----------------------------------------------------

    def _log(self, msg: str) -> None:
        if self.verbose:
            print(msg)

    def _col2arfcn(self, col: int) -> int:
        signed = col - self.chz.n_chans if col >= self.chz.n_chans // 2 \
            else col
        f = self.chz.pfb_center_freq + signed * BASE_BANDWIDTH
        return int(round((f - self.base_freq) / BASE_BANDWIDTH))

    def _emit(self, car: _Carrier, chan_type: int, fn: int, tn: int,
              l2) -> None:
        l2b = bytes(bytearray(np.asarray(l2, np.uint8)))
        car.frames.append((chan_type, fn, tn, l2b))
        self.frames.append((car.arfcn, chan_type, fn, tn, l2b))
        if self.sink is not None:
            self.sink.send(chan_type, fn, tn, l2b, arfcn=car.arfcn)

    def _fetch_start(self, tensors: dict):
        """Start the device-to-host copies of `tensors`; returns the
        handle `_fetch_wait` takes."""
        host = {k: v.to("cpu", non_blocking=True) for k, v in tensors.items()}
        ev = None
        if self.device.type == "cuda":
            ev = torch.cuda.Event()
            ev.record()
        return host, ev

    @staticmethod
    def _fetch_wait(handle) -> dict:
        host, ev = handle
        if ev is not None:
            ev.synchronize()
        return {k: v.numpy() for k, v in host.items()}

    # --- acquisition ---------------------------------------------------

    def _acq_pull_blocks(self, n_abl: int):
        """Pull n_abl ingest blocks to the device once, keeping them for
        the two acquire passes and the main loop's replay.  Returns
        (device block list, valid input samples)."""
        blocks, valid = [], 0
        for _ in range(n_abl):
            x, nv = self._pull_block()
            xd = self._put(x)
            self._replay_dev.append((xd, nv))
            blocks.append(xd)
            valid += nv
        return blocks, valid

    def _acq_replay(self, blocks):
        """Iterate (block_idx, stream_buffer) by streaming the kept
        blocks through the ingest step from fresh state."""
        state = self._state
        for b, x in enumerate(blocks):
            stream, state = self._step(x, *state)
            yield b, stream

    def acquire(self) -> list[_Carrier]:
        """Batched FCCH scan over every grid channel (fcch_single_init of
        gmr1_rx.c:605 vectorized across the transponder), streamed over
        the 330 ms capture prefix in two passes (see the module doc)."""
        sps, ft = self.sps, self.fcch_type
        blen = ft.len_syms * sps
        n_b = ft.len_syms
        scan = (330 * SYM_RATE * sps) // 1000
        acq_len = scan + 2 * blen
        m = self.chz.n_chans
        hop = self.chz.analyzer.hop
        n_abl = -(-acq_len // self.S_b)
        t = time.perf_counter()

        blocks, valid_in = self._acq_pull_blocks(n_abl)
        avail_out = int(np.floor((valid_in // hop) * self.rrc.ratio))
        if avail_out < scan + blen:
            raise ValueError("capture shorter than the 330 ms FCCH scan")
        n_corr = -(-min(scan + blen, avail_out - blen) // sps) - n_b + 1

        # ---- pass 1: correlation-power scan -----------------------------
        parts = [_acq_pwr_block(ft, buf, sps, self.T_tail)
                 for _, buf in self._acq_replay(blocks)]
        pwr = torch.cat(parts, dim=1)[:, n_b - 1:n_b - 1 + n_corr]
        del parts
        toa_r = fcch.rough_from_pwr(ft, pwr, sps).cpu().numpy()
        del pwr
        toa_r = np.clip(toa_r, 0, acq_len - 2 * blen).astype(np.int64)

        # ---- pass 2: gather candidate fine/SNR windows ------------------
        total = n_abl * self.S_b
        wlen = 3 * blen                     # [toa_r - blen, toa_r + 2*blen)
        cand = []                           # (col, s0)
        per_block: list[list[int]] = [[] for _ in range(n_abl)]
        for col in range(m):
            if self.arfcn_filter is not None \
               and self._col2arfcn(col) not in self.arfcn_filter:
                continue
            s0 = min(max(int(toa_r[col]) - blen, 0), total - wlen)
            bw = max(0, -(-(s0 + wlen) // self.S_b) - 1)
            per_block[bw].append(len(cand))
            cand.append((col, s0))

        toa = np.zeros(m, np.int64)
        ferr = np.zeros(m, np.float32)
        snr = np.full(m, np.nan, np.float32)          # non-candidate: skip
        if cand:
            # per replay block: ONE batched window gather
            w3_parts, order = [], []
            for b, buf in self._acq_replay(blocks):
                grp = per_block[b]
                if not grp:
                    continue
                base = b * self.S_b - self.T_tail
                cols = torch.as_tensor([cand[ci][0] for ci in grp],
                                       device=self.device)
                starts = torch.as_tensor([[cand[ci][1] - base] for ci in grp],
                                         device=self.device)
                w3_parts.append(_windows_rows(buf, cols, starts, wlen)[:, 0])
                order += grp
            w3 = torch.cat(w3_parts)[torch.as_tensor(
                np.argsort(order), device=self.device)]
            off = torch.as_tensor([int(toa_r[c]) - s0 for c, s0 in cand],
                                  device=self.device)
            got = self._fetch_wait(self._fetch_start(dict(zip(
                ("rel", "ferr", "snr"),
                _acq_fine_snr(ft, w3, off, sps, blen)))))
            for ci, (c, s0) in enumerate(cand):
                toa[c] = s0 + int(got["rel"][ci])
                ferr[c] = float(got["ferr"][ci])
                snr[c] = float(got["snr"][ci])
        self.carriers = []
        for col in range(m):
            arfcn = self._col2arfcn(col)
            if self.arfcn_filter is not None \
               and arfcn not in self.arfcn_filter:
                continue
            s = float(snr[col])
            if not np.isfinite(s) or s < self.snr_min:
                continue
            cd = ChanDesc(sps=sps)
            cd.align = int(toa[col])
            cd.freq_err = float(ferr[col])
            self.carriers.append(_Carrier(col=col, arfcn=arfcn, cd=cd, snr=s))
            self._log(f"[+] ARFCN {arfcn} FCCH @{cd.align} snr={s:.1f} "
                      f"freq={cd.freq_err * SYM_RATE / 2 / np.pi:.1f} Hz")
        self._tick("acquire", t)
        return self.carriers

    def seed_carriers(self, acq) -> list[_Carrier]:
        """Set the carriers from (col, arfcn, align, freq_err, snr)
        tuples — e.g. taken from another receiver's acquire() — instead
        of acquiring, so the block loop can be checked on its own."""
        self.carriers = []
        for col, arfcn, align, freq_err, snr in acq:
            cd = ChanDesc(sps=self.sps)
            cd.align = int(align)
            cd.freq_err = float(freq_err)
            self.carriers.append(_Carrier(col=int(col), arfcn=int(arfcn),
                                          cd=cd, snr=float(snr)))
        return self.carriers

    # --- block engine ---------------------------------------------------

    def _ready(self, car: _Carrier) -> bool:
        """Carrier's next F frames fully resident in the buffer?"""
        a = car.cd.align - self._buf0
        return 64 <= a <= self.T_buf - (self.block_frames + 2) \
            * self.frame_out

    def _build_meta(self, cars, f_cnt: int) -> dict:
        """Per-block control schedule of `cars` as whole-array numpy:
        BCCH on sirfn%8==2, CCCH on sirfn%8 not in {0, 2}
        (gmr1_rx.c:867,800) — 1 BCCH + 6 CCCH windows per carrier per
        8-frame block — and each window's start in the stream buffer."""
        sps, buf0, fo = self.sps, self._buf0, self.frame_out
        n = len(cars)

        def vec(get, dt):
            return np.fromiter((get(c) for c in cars), dt, n)

        align = vec(lambda c: c.cd.align, np.int64)
        fn0 = vec(lambda c: c.cd.fn, np.int64)
        delay = vec(lambda c: c.cd.sa_sirfn_delay, np.int64)
        stn = vec(lambda c: c.cd.sa_bcch_stn, np.int64)
        fns = fn0[:, None] + np.arange(f_cnt)
        r8 = ((fns - delay[:, None]) & 63) % 8
        is_b = r8 == 2
        is_c = (r8 != 0) & (r8 != 2)
        nb = max(1, int(is_b.sum(1).max(initial=0)))
        nc = max(1, int(is_c.sum(1).max(initial=0)))
        # first-nb true frame indices per carrier, in fn order; surplus
        # columns demodulate garbage the walk never reads
        fr_b = np.argsort(~is_b, axis=1, kind="stable")[:, :nb]
        fr_c = np.argsort(~is_c, axis=1, kind="stable")[:, :nc]

        def idx(frames, win, wlen):
            out = (align[:, None] - buf0 + sps * 39 * stn[:, None]
                   - (win >> 1) + frames * fo)
            return np.clip(out, 0, self.T_buf - wlen - 1)

        return dict(
            col=vec(lambda c: c.col, np.int64),
            freq=vec(lambda c: c.cd.freq_err, np.float32),
            idx_b=idx(fr_b, 20 * sps, BU.BCCH.len_syms * sps + 20 * sps),
            idx_c=idx(fr_c, 10 * sps, BU.DC6.len_syms * sps + 10 * sps),
            is_b=is_b, is_c=is_c,
            jb=np.cumsum(is_b, 1) - 1, jc=np.cumsum(is_c, 1) - 1)

    def _process_block(self, active: list[_Carrier], prefetch) -> None:
        t = time.perf_counter()
        sps, F, dev = self.sps, self.block_frames, self.device
        frame_len = self.frame_out
        mb = self._build_meta(active, F)
        fs = -torch.as_tensor(mb["freq"], device=dev)[:, None]
        res = _ctrl_core(self.streams, torch.as_tensor(mb["col"], device=dev),
                         fs, torch.as_tensor(mb["idx_b"], device=dev),
                         torch.as_tensor(mb["idx_c"], device=dev), sps)
        handle = self._fetch_start(res)
        t = self._tick("phase", t)
        # the next block's ingest is queued behind this block's phase:
        # its host read and upload overlap the phase on the device
        prefetch()
        t = time.perf_counter()
        res = self._fetch_wait(handle)
        t = self._tick("fetch", t)

        # ---- host FSM: BCCH / CCCH (gmr1_rx.c:746-850) -------------------
        is_b, is_c, jb, jc = mb["is_b"], mb["is_c"], mb["jb"], mb["jc"]
        pending = []
        for i, car in enumerate(active):
            cd = car.cd
            d_align, d_freq = 0, 0.0
            for f in range(F):
                fn = cd.fn + f
                if is_b[i, f]:
                    j = jb[i, f]
                    car.bcch_energy = float(res["eb"][i, j])
                    if not res["badb"][i, j]:
                        l2 = res["l2b"][i, j]
                        # closed-loop tracking (gmr1_rx.c:782-789),
                        # applied at the block boundary
                        d_align = int(round(float(res["toab"][i, j]))) \
                            - (20 * sps >> 1)
                        d_freq = float(res["ferrb"][i, j])
                        # SI1 realign sets cd.fn to THIS frame's true fn;
                        # rebase it to the block start (sirfn%8 is
                        # preserved, so the block schedule stays valid)
                        bcch_tdma_align(cd, l2, sps)
                        fn = cd.fn
                        cd.fn = fn - f
                        self._emit(car, gsmtap.GMR1_BCCH, fn,
                                   cd.sa_bcch_stn, l2)
                if is_c[i, f] and not res["badc"][i, jc[i, f]]:
                    j = jc[i, f]
                    min_e = car.bcch_energy / 2.0
                    if not (float(res["ec"][i, j]) < min_e):  # nan-safe
                        l2 = res["l2c"][i, j]
                        if ccch_is_imm_ass(l2):
                            st3 = cd.tch3
                            st3.active = True
                            st3.tn, st3.p = ccch_imm_ass_parse(l2)
                            st3.energy_burst = min_e * 0.75 \
                                if np.isfinite(min_e) else 0.0
                            st3.energy_dkab = st3.energy_burst / 8.0
                            st3.weak_cnt = 0
                            st3.ciph = 0
                            st3.sync_id = 0
                            st3.ebits[:] = 0
                            self._log(f"[+] ARFCN {car.arfcn} TCH3 on "
                                      f"TN {st3.tn}")
                        self._emit(car, gsmtap.GMR1_CCCH, fn,
                                   cd.sa_bcch_stn, l2)
            pending.append((d_align, d_freq))

        # ---- advance block ----------------------------------------------
        # one frame of slot offset + the largest burst window fits in two
        # extra frame lengths: stop when the NEXT block would need samples
        # past the capture end (gmr1_rx.c:893-894)
        for car, (d_align, d_freq) in zip(active, pending):
            cd = car.cd
            cd.align += F * frame_len + d_align
            cd.freq_err += d_freq
            cd.fn += F
            if self.n_stream is not None \
               and cd.align + (F + 2) * frame_len > self.n_stream:
                car.done = True
        self._tick("walk", t)

    # --- top level --------------------------------------------------------

    def run(self) -> int:
        """Acquire + decode the whole capture.  Returns #L2 frames."""
        if not self.carriers:
            self.acquire()
        if not self.carriers:
            self._log("[!] no FCCH found on any carrier")
            return 0
        # carriers lag the ingest frontier by up to T_tail + their initial
        # align, so after EOF keep draining with zero-input blocks until
        # every carrier hits its done bound
        drain_max = self.T_tail // self.S_b + 3
        b = drained = 0
        self.block_walls: list[float] = []
        pending = None   # prefetched (streams, buf0, was_eof) of block b
        while True:
            t_iter = time.perf_counter()
            if all(c.done for c in self.carriers):
                break
            if self._eof and drained >= drain_max:
                break
            if pending is None:
                was_eof = self._eof
                self._ingest_block(b)
                pending = (self.streams, self._buf0, was_eof)
            self.streams, self._buf0, was_eof = pending
            pending = None
            if was_eof:
                drained += 1

            def prefetch(bb=b):
                nonlocal pending
                save = (self.streams, self._buf0)
                was = self._eof
                self._ingest_block(bb + 1)
                pending = (self.streams, self._buf0, was)
                self.streams, self._buf0 = save

            active = [c for c in self.carriers
                      if not c.done and self._ready(c)]
            if active:
                self._process_block(active, prefetch)
            else:
                prefetch()
            b += 1
            self.block_walls.append(time.perf_counter() - t_iter)
        return len(self.frames)
