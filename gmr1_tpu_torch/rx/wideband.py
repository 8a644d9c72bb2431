"""Block-streamed wideband receiver.

Counterpart of gmr1_tpu/rx/wideband.py `WidebandReceiver` in its
single-device form (`mesh=None`, float32 ingest): one wideband capture
in, every carrier's BCCH, CCCH, TCH3 (speech, FACCH3, DKAB) and TCH9
(FACCH9, 9k6 CSD) frames out.

  acquisition  the capture prefix streams through the ingest step twice:
               pass 1 accumulates the FCCH dual-chirp correlation power
               per block (330 ms, or the 650 ms multi-beam window with
               `beams` > 1), pass 2 gathers each candidate's fine/SNR
               window (one gather per block), then fine TOA, frequency
               and SNR; with `beams` > 1 every ARFCN forks up to `beams`
               carriers gated against its strongest beam
               (gmr1_rx.c:643-741).  Off the grid only the columns of
               the band the pre-resampler lets it separate
               (Channelizer.band) are candidates, and a candidate that
               is the image of its inward neighbour's carrier is refused.
  pre-resample an off-grid sample rate lands on the 31.25 kHz grid block
               by block through the exact-rational StreamPreResampler
               (the raw tail stays on the host, one GEMM a block; the
               `pre` section).
  ingest step  once per TDMA block (block_frames frames, 0.32 s at 8):
               PFB analysis of the block with the carried overlap-save
               halo -> per-carrier RRC resample by ONE per-frame window
               matrix with the carried bank history -> rolling stream
               buffer of (F+1) frames of tail + F new frames per carrier.
  wide         each configured wide carrier (width 2/3/5) synthesizes its
               stream from the block's bank rows (WideStreamer) into a
               BoundedStream that its own per-carrier Receiver decodes
               incrementally (stream_run) during the block loop.
  block phase  `_phase_block`, computed speculatively from the pre-block
               channel state.  The control half runs for every carrier:
               BCCH + CCCH demod and decode.  The traffic half runs only
               for the carrier slots that hold a TCH3 or TCH9 channel at
               the block boundary (none on a control-only grid): the TCH3
               slot path (energy, DKAB, burst type, FACCH3 demod, speech
               decode under the A5/1 keystream); NT9 demod and FACCH9
               decode; the chained TCH9 9k6 decode over the
               device-resident deinterleaver rings (one row per carrier
               slot; the rows of other slots stay as they were).  Only the
               small decoded results come back; soft bits stay on the
               device.
  host walks   the per-carrier FSMs (gmr1_rx.c:356-850) select from the
               fetched results: SI1 frame-number / slot realign,
               closed-loop time and frequency corrections applied at the
               next block boundary, CCCH energy gate, IMM.ASS, the TCH3
               energy/DKAB/teardown walk, FACCH3 4-burst groups (soft
               bits gathered only for the bursts found) with the cipher
               retry, ASS.CMD.1 -> TCH9, FACCH9 and CSD emission.  Rare
               mid-block events (activation, realign, reassignment) re-run
               a small phase for just those carriers (`_phase_tch3s`,
               `_phase_tch9s`, `_chain_fix`).

  reader       on the single-device streaming path the next block's
               source read, float64 grid rotation and int16 quantization
               run on one worker thread while this block's meta build and
               phase dispatch run (JAX's `_q_start`,
               gmr1_tpu/rx/wideband.py:724-749); counters and EOF are
               committed on the main thread when the block is taken.  On
               the card the worker writes into one of two pinned staging
               buffers, and the upload is a non-blocking copy on a copy
               stream that the compute stream waits for; a buffer is
               written again only once its last copy has finished.

Options of the JAX receiver that change the ingest:

  mesh         a `parallel.Mesh`: each block's time shards (the halo
               prepended by the host, `overlapped_shards`) are analysed
               one a device and resharded to carrier-sharded rows
               (`analyze_reshard`, bf16 transport); every device resamples
               and keeps the streams of its own carriers (`ShardedRows`).
               When the carrier count C divides by the mesh size D, the
               block phase splits over the carriers
               (gmr1_tpu/rx/wideband.py:1150-1167): slots [j C/D,
               (j+1) C/D) form group j, whose phase, TCH9 rings and
               correction phases run on mesh.devices[j]; otherwise they
               run on the mesh's first device.  Either way each carrier's
               windows are gathered on the device that owns its column
               and only the windows move.  The acquisition passes run on
               the first device, and each wide channel reads only its own
               columns.
  h2d_dtype    "int16": each block is peak-normalized and quantized on the
               host with its dequant factor in one leading int16 row (one
               row a shard in mesh mode), halving the upload; it is
               dequantized on the device at the top of the step, and the
               overlap-save halo stays float32 there.
"""

from __future__ import annotations

import concurrent.futures
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import checked_device
from ..channelizer.arfcn import _BASES, BASE_BANDWIDTH
from ..channelizer.pfb import Channelizer, StreamPreResampler
from ..l1 import bcch, ccch, facch3, facch9, tch3, tch9
from ..ops import a5 as a5op
from ..ops import cplx
from ..ops.consts import upload
from ..ops.interleave import InterleaverState
from ..parallel.ingest import (ShardedRows, analyze_reshard,
                               ici_bytes_per_step, overlapped_shards)
from ..sdr import bursts as BU
from ..sdr import dkab, fcch, modem
from ..sdr.defs import SYM_RATE
from ..trace import section, span
from . import gsmtap
from .cfile import ArraySource, BoundedStream, SampleSource
from .receiver import (ChanDesc, Receiver, bcch_tdma_align,
                       ccch_imm_ass_parse, ccch_is_imm_ass,
                       facch3_ass_cmd_1_parse, facch3_is_ass_cmd_1)

torch.backends.cuda.matmul.allow_tf32 = False   # the RRC window matmul is f32

ROWS_PER_FRAME = 2500     # bank rows per TDMA frame: 936*62500/23400
QUANT_ROWS = 1 << 16      # int16 quantization pass: a chunk stays in cache
# the burst windows the phases decode, by kind (WidebandReceiver.counts)
WINDOW_KINDS = ("bcch", "ccch", "tch3", "nt9")


def _energy(w):
    """Mean |x|^2 excluding len>>5 border samples (gmr1_rx.c:172-182)."""
    n = w.shape[-2]
    b = n >> 5
    return torch.sum(cplx.abs2(w[..., b:n - b, :]), dim=-1) / n


def _windows_rows(streams, rows, idx, wlen: int):
    """streams (M, Ns, 2), rows (C,), idx (C, F) -> (C, F, wlen, 2).

    One gather fusing the carrier-row select with the window slice;
    starts are clamped into [0, Ns - wlen] like the JAX dynamic_slice.
    Carrier-sharded streams (mesh mode): each carrier's windows are
    gathered on the device that owns its column and only the windows move
    to rows' device (in JAX the one collective of the block phase,
    gmr1_tpu/rx/wideband.py:1150-1153)."""
    if isinstance(streams, ShardedRows):
        out = torch.empty((*idx.shape, wlen, 2), device=rows.device)
        for j, sel, local in streams.owners(rows):
            part = streams.parts[j]
            out[sel] = _windows_rows(part, local, idx[sel].to(part.device),
                                     wlen).to(rows.device)
        return out
    ns = streams.shape[1]
    start = torch.clamp(idx, 0, ns - wlen)
    pos = start[..., None] + torch.arange(wlen, device=streams.device)
    return streams.reshape(-1, 2)[rows[:, None, None] * ns + pos]


def _acq_pwr_block(ft, buf, sps: int, t_tail: int):
    """Incremental FCCH scan, one block: symbol-rate dual-chirp
    correlation power for the windows ENDING in this block's new samples
    (buf is the (M, T_buf, 2) stream buffer) -> (M, S_b/sps).  Sharded
    buffers scan on each device; only the powers move."""
    if isinstance(buf, ShardedRows):
        return torch.cat([_acq_pwr_block(ft, p, sps, t_tail).to(buf.device)
                          for p in buf.parts])
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


def _bt_from_demods(rf, rs, e_toa: float):
    """Burst-type classification from the two demod results: the peak
    powers and e_toa-distance gate of modem.detect (pi4cxpsk.c:657-659),
    without redoing the sync correlations.  0 = FACCH, 1 = speech."""
    def score(r):
        return r.pwr / torch.clamp(torch.abs(e_toa - r.toa), min=1e-6)
    return torch.argmax(torch.stack([score(rf), score(rs)], dim=-1), dim=-1)


def _keystreams(key, fn0, f_cnt: int, nbits: int):
    """Downlink A5/1 streams (C, F, nbits) of frames fn0 + [0, F)."""
    fns = fn0[:, None] + torch.arange(f_cnt, device=fn0.device)
    return a5op.keystream(key, fns, nbits, with_ul=False)[0]


def _tch3_core(streams, rows, fs, fn0, p, flags, idx_t, key, sps: int,
               ks208=None):
    """Full TCH3 slot path (gmr1_rx.c:531-600 restructured): energy,
    DKAB, burst-type detect, FACCH demod and a speculative speech decode
    under the A5/1 keystream, gated by the carrier's learned cipher flag
    (flags bit 1).  `ks208` shares the NT9 keystream's prefix: A5 is a
    stream cipher, so the 208-bit stream of (key, fn) IS the first 208
    bits of the 658-bit one.  Returns (small results, FACCH soft bits
    (C, F, 104), which stay on the device)."""
    w = sps + sps // 2
    wt = _windows_rows(streams, rows, idx_t, BU.NT3_FACCH.len_syms * sps + w)
    rd = dkab.demod(wt, sps, p[:, None], fs)
    rf = modem.demod(BU.NT3_FACCH, wt, sps=sps, win=w, freq_shift=fs)
    rs = modem.demod(BU.NT3_SPEECH, wt, sps=sps, win=w, freq_shift=fs)
    bt = _bt_from_demods(rf, rs, float(w >> 1))
    if ks208 is None:
        ks208 = _keystreams(key, fn0, idx_t.shape[1], 208)
    ciph = ks208 * ((flags >> 1) & 1)[:, None, None].to(ks208.dtype)
    f0, f1, _s, _m = tch3.decode(rs.ebits, ciph)
    small = dict(et=_energy(wt), dk_bits=rd.ebits, dk_found=rd.found,
                 bt=bt.to(torch.int8), f_sid=rf.sync_id.to(torch.int8),
                 s_f0=f0, s_f1=f1)
    return small, rf.ebits


def _tch9_core(streams, rows, fs, fn0, idx_9, key, sps: int):
    """NT9 windows: demod + speculative FACCH9 decode for every
    (carrier, frame) (gmr1_rx.c:276-353).  The A5/1 keystream (the
    reference hardcodes A5/1 for NT9, gmr1_rx.c:310,326) is computed
    once and shared with the CSD chain and the TCH3 path.  Returns
    (small results, NT9 soft bits (C, F, 662), keystreams (C, F, 658))."""
    w = sps + sps // 2
    wt = _windows_rows(streams, rows, idx_9, BU.NT9.len_syms * sps + w)
    r = modem.demod(BU.NT9, wt, sps=sps, win=w, freq_shift=fs)
    ks = _keystreams(key, fn0, idx_9.shape[1], 658)
    l2f9, _sa, _st, badf9, _m = facch9.decode(r.ebits, ks)
    small = dict(sid9=r.sync_id.to(torch.int8), l2f9=l2f9, badf9=badf9)
    return small, r.ebits, ks


def _chain_core(e9, ks, il, sid, flags):
    """Chained 9k6 CSD decode over the depth-3 rings: valid = (sync_id
    == 1) & started & tch9-active, so the chain runs with the block
    phase (identical to the sequential per-burst walk, gmr1_rx.c:321-347
    / tch9.c:109).  Returns (updated rings, l2 (F, C, 60))."""
    f_cnt = e9.shape[1]
    shifts = 16 + torch.arange(f_cnt, device=flags.device)
    started = (flags[:, None] >> shifts) & 1
    act9 = (flags & 1)[:, None]
    valid = (sid == 1) & ((started & act9) != 0)
    il2, l2a, _sa, _st, _m = tch9.decode_frames(
        e9.transpose(0, 1), tch9.MODE_9K6, il, ks.transpose(0, 1),
        valid.transpose(0, 1))
    return il2, l2a


def _phase_block(streams, m: dict, il, key, sps: int):
    """The whole block of a carrier group (see the module doc).  `m` is
    the block meta on the device: the control half runs on every slot,
    the traffic half on the rows of m["tr"] alone (`_meta_dev`; None when
    no slot holds a traffic channel, and then nothing of it runs).
    Returns (small, big): `small` is fetched to the host, every tensor
    carrier-major, a row a slot for the control results and a row of
    m["tr"] for the traffic ones (a split mesh's groups concatenate on
    axis 0); `big` (FACCH soft bits, NT9 soft bits and keystreams of
    m["tr"]'s rows, the post-block rings: `il` itself without a traffic
    half) stays on the device for the rare correction phases."""
    fs = -m["freq"][:, None]
    small = _ctrl_core(streams, m["rows"], fs, m["idx_b"], m["idx_c"], sps)
    t = m["tr"]
    if t is None:
        return small, dict(il2=il)
    slots, il_t = t["slots"], il
    if slots is not None:       # a sub-batch of the group's slots
        fs = -t["freq"][:, None]
        il_t = InterleaverState(buf=il.buf[slots], n=il.n[slots])
    rows, fn0, flags = t["rows"], t["fn0"], t["flags"]
    s9, e9, ks = _tch9_core(streams, rows, fs, fn0, t["idx_9"], key, sps)
    s3, f_ebits = _tch3_core(streams, rows, fs, fn0, t["p"], flags,
                             t["idx_t"], key, sps, ks208=ks[..., :208])
    small.update(s3)
    small.update(s9)
    il2, l2a = _chain_core(e9, ks, il_t, s9["sid9"], flags)
    if slots is not None:       # the other rows stay the pre-block ones
        il2 = InterleaverState(buf=il.buf.index_copy(0, slots, il2.buf),
                               n=il.n.index_copy(0, slots, il2.n))
    small["l2a"] = l2a.transpose(0, 1)      # carrier-major, as all of small
    big = dict(f_ebits=f_ebits, e9=e9, ks=ks, il2=il2)
    return small, big


def _phase_tch3s(streams, m: dict, key, sps: int):
    """Supplemental TCH3 slot path for a carrier subset (same-block
    activations, realigned carriers whose block-phase windows went
    stale)."""
    return _tch3_core(streams, m["rows"], -m["freq"][:, None], m["fn0"],
                      m["p"], m["flags"], m["idx"], key, sps)


def _phase_tch9s(streams, m: dict, key, sps: int):
    """Supplemental NT9 demod + FACCH9 for a carrier subset."""
    return _tch9_core(streams, m["rows"], -m["freq"][:, None], m["fn0"],
                      m["idx"], key, sps)


def _chain_fix(il_prev, il2, fix, e9, ks):
    """Correct the chained CSD decode for a carrier subset: re-run the
    chain from the PRE-block ring rows (il_prev) with the corrected
    validity (host-computed after the FSM walks) and write the results
    into the block phase's post-block rings (il2).  `fix` is (Cs, 3)
    int64 [slot | reset | valid bits]; e9/ks are the subset's soft bits
    and keystreams.  The port pads no batch, so the slots are unique and
    scatter with index_copy_, in place: il2 is the block phase's fresh
    ring, held by nothing else, or il_prev itself where the group ran no
    traffic half, whose rows are gathered before they are written."""
    slots, reset, vbits = fix[:, 0], fix[:, 1], fix[:, 2]
    f_cnt = e9.shape[1]
    valid = ((vbits[:, None] >> torch.arange(f_cnt, device=fix.device))
             & 1) != 0
    keep = 1 - reset
    sub = InterleaverState(
        buf=il_prev.buf[slots] * keep[:, None, None].to(il_prev.buf.dtype),
        n=il_prev.n[slots] * keep)
    sub2, l2a, _sa, _st, _m = tch9.decode_frames(
        e9.transpose(0, 1), tch9.MODE_9K6, sub, ks.transpose(0, 1),
        valid.transpose(0, 1))
    il2.buf.index_copy_(0, slots, sub2.buf)
    il2.n.index_copy_(0, slots, sub2.n)
    return il2, l2a


@dataclass
class _Carrier:
    col: int                 # channel-bank column
    arfcn: int
    cd: ChanDesc
    snr: float
    frames: list = field(default_factory=list)   # (type, fn, tn, bytes)
    speech: list = field(default_factory=list)   # decoded TCH3 frames
    csd: list = field(default_factory=list)      # decoded TCH9 CSD blocks
    bcch_energy: float = float("nan")
    done: bool = False


class WidebandReceiver:
    """Decode every carrier of a wideband capture (see the module doc).

    `wb` is planar float32 (N, 2), complex64 (N,) host samples or a
    `cfile.SampleSource`.  `device` is where the streams live and every
    phase runs: the card by default, and without CUDA that raises.
    `mesh` (a `parallel.Mesh`) shards the ingest over its devices (see
    the module doc; M and the block's rows must divide by its size, and
    each shard's rows must be even); the phases then run on
    mesh.devices[0], and a `device` that disagrees with it raises.
    `h2d_dtype` is "float32" or "int16" (on-grid rates only).  The
    remaining arguments are the JAX receiver's.
    """

    def __init__(self, wb, samp_rate: float, center_freq: float,
                 sps: int = 4, kc: bytes | None = None,
                 sink: gsmtap.GsmtapSink | None = None,
                 arfcns: list[int] | None = None, snr_min: float = 2.0,
                 block_frames: int = 8, fcch_type: fcch.FcchBurst = fcch.FCCH,
                 band: str = "L", uplink: bool = False,
                 verbose: bool = False, mesh=None, beams: int = 1,
                 wide_channels=None, h2d_dtype: str = "float32",
                 device: str | torch.device = "cuda"):
        if h2d_dtype not in ("float32", "int16"):
            raise ValueError(h2d_dtype)
        self._h2d_int16 = h2d_dtype == "int16"
        if mesh is None:
            self.device = checked_device(device)
        else:
            dev, d0 = torch.device(device), mesh.devices[0]
            if dev.type != d0.type or dev.index not in (None, d0.index):
                raise ValueError(f"device={str(device)!r} disagrees with the "
                                 f"mesh's first device {d0}, where the "
                                 "phases run")
            self.device = d0
        self.mesh = mesh
        self.sps = sps
        self.kc = np.frombuffer(kc, np.uint8) if kc else np.zeros(8, np.uint8)
        self.sink = sink
        self.snr_min = snr_min
        self.block_frames = block_frames
        self.fcch_type = fcch_type
        self.verbose = verbose
        self.beams = beams
        self.base_freq = _BASES[(band, uplink)]
        # wide carriers (width 2/3/5) are explicit config, as in the
        # reference channelizer CLI (utils/gmr1_rx_sdr.py:216-339)
        self.wide_channels = list(wide_channels or [])
        self.chz = Channelizer(samp_rate, center_freq, sps=sps,
                               need_nx=bool(self.wide_channels))
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
        self.wide_carriers: list[_Carrier] = []
        self.frames: list[tuple[int, int, int, int, bytes]] = []
        # device-resident TCH9 deinterleaver rings, one row per carrier
        # slot, one InterleaverState a carrier group on the group's device
        # (created at the first block, advanced by the block phase)
        self._il: list[InterleaverState] | None = None
        self._a5_seen: dict[tuple[int, int], np.ndarray] = {}
        # wall-clock per pipeline section (trace.span), accumulated
        # across run()
        self.prof: dict[str, float] = {}
        # burst windows a kind: "dec.<kind>" demodulated and decoded by
        # some phase, "read.<kind>" whose result a walk read; carrier
        # slots: "phase.slots" the block phases' control half ran on,
        # "phase.traffic_slots" their traffic half; accumulated across
        # run(); "acq.out_of_band": FCCH candidates the acquisition
        # refused for lying outside the usable band (Channelizer.band),
        # "acq.image": those refused as the image of the inward
        # neighbour's carrier; "pre.blocks": blocks the pre-resampler made
        self.counts: dict[str, int] = {
            f"{w}.{k}": 0 for w in ("dec", "read") for k in WINDOW_KINDS}
        self.counts.update({"phase.slots": 0, "phase.traffic_slots": 0,
                            "acq.out_of_band": 0, "acq.image": 0,
                            "pre.blocks": 0})
        # the block reader's worker time, one entry a job taken,
        # accumulated across run() (off the main thread: not a section)
        self.reader_s: list[float] = []
        self._last_put = None        # the last block put (device_block_time)
        self._last_meta = None       # the last block phase's host meta
        # the block reader (_q_start): one worker thread while run() runs,
        # at most one job in flight; on the card two pinned staging
        # buffers, the copy event of each, and the copy stream
        self._q_pool: concurrent.futures.ThreadPoolExecutor | None = None
        self._q_job: concurrent.futures.Future | None = None
        self._stage: list[torch.Tensor] | None = None
        self._stage_ev: list = [None, None]
        self._stage_k = 0
        self._copy_stream = None
        self._build_ingest()
        self._pre = None
        if self._h2d_int16 and self.chz.pre_resamp is not None:
            raise ValueError("h2d_dtype=int16 requires an on-grid fs (the "
                             "off-grid pre-resampler streams device chunks, "
                             "so there is no host transfer to quantize)")
        if self.chz.pre_resamp is not None:
            self._pre = StreamPreResampler(self.chz.pre_resamp,
                                           self.n_block, self._pull,
                                           device=self.device)

    def _count(self, what: str, **kinds) -> None:
        """Add burst windows of each kind to counts["<what>.<kind>"]."""
        for kind, n in kinds.items():
            self.counts[f"{what}.{kind}"] += int(n)

    def _quant(self, x: np.ndarray, out: np.ndarray | None = None
               ) -> np.ndarray:
        """Host-side ingest quantization for h2d_dtype=int16: peak-normalize
        the block and prepend one row carrying the dequant factor (f32
        bitcast into 2 int16), so the scale rides the same transfer.
        Works on (n, 2) blocks and (d, n, 2) mesh shard stacks alike (one
        shared scale, one row a shard); an (n, 2) block may be written
        into `out`, (n + 1, 2) int16 (a staging buffer)."""
        if not self._h2d_int16:
            return x
        x = np.asarray(x, np.float32)
        # min/max instead of abs(x).max(): no |x| temporary, and the peak
        # normalization bounds |q| <= 32000, so no clip before the cast
        peak = float(max(x.max(initial=0.0), -x.min(initial=0.0)))
        scale = 32000.0 / peak if peak > 0.0 else 1.0
        inv_row = np.frombuffer(
            np.float32(1.0 / scale).tobytes(), np.int16).reshape(1, 2)
        if x.ndim == 3:                      # (d, n, 2) shard stack
            q32 = x * scale
            np.rint(q32, out=q32)
            rows = np.broadcast_to(inv_row[None], (x.shape[0], 1, 2))
            return np.concatenate([rows, q32.astype(np.int16)], axis=1)
        if out is None:
            out = np.empty((x.shape[0] + 1, 2), np.int16)
        out[0] = inv_row[0]
        # scale, round and narrow chunk by chunk (the same values as
        # whole-array passes, fewer trips through memory)
        q32 = np.empty((min(QUANT_ROWS, x.shape[0]), 2), np.float32)
        for r0 in range(0, x.shape[0], QUANT_ROWS):
            blk = x[r0:r0 + QUANT_ROWS]
            q = q32[:blk.shape[0]]
            np.multiply(blk, scale, out=q)
            np.rint(q, out=q)
            np.copyto(out[1 + r0:1 + r0 + blk.shape[0]], q, casting="unsafe")
        return out

    def _dequant(self, z):
        """Device side of _quant: (n + 1, 2) int16 -> (n, 2) float32."""
        if not self._h2d_int16:
            return z
        inv = z[0].contiguous().view(torch.float32)
        return z[1:].to(torch.float32) * inv

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
        w_t = w.T.copy()                                     # (k_span, n)
        devs = (dev,) if self.mesh is None else self.mesh.devices
        # keyed by the tensor's own device ("cuda:0" where dev is "cuda")
        self._w_t = {str(w.device): w for w in
                     (upload(w_t, torch.device(d)) for d in devs)}
        if self.mesh is None:
            self._state = (
                torch.zeros((self._halo_len, 2), device=dev),
                torch.zeros((m, self._hist, 2), device=dev),
                torch.zeros((m, self.T_tail, 2), device=dev))
        else:
            # carrier-sharded state on each device; the raw halo tail
            # stays on the host, which builds the overlapped shards
            d = self.mesh.size
            r_local = self.R_b // d
            if m % d or self.R_b % d or r_local % 2:
                raise ValueError(f"a mesh of {d} devices needs M ({m}) and "
                                 f"the block's rows ({self.R_b}) to divide "
                                 "by it and an even shard row count (the "
                                 "2x-oversample sign restarts at each "
                                 "shard's row 0)")
            self.ici_bytes_per_block = ici_bytes_per_step(ana, r_local, d)
            self._htail = np.zeros((self._halo_len, 2), np.float32)
            self._state = (
                [torch.zeros((m // d, self._hist, 2), device=d_)
                 for d_ in devs],
                [torch.zeros((m // d, self.T_tail, 2), device=d_)
                 for d_ in devs])
        # each wide channel: a streamed synthesizer over the block's bank
        # rows, a BoundedStream and an incrementally driven per-carrier
        # Receiver, so wide carriers decode DURING the block loop with
        # O(block) retained memory (the reference splits and decodes
        # them in the same streaming flowgraph, gmr1_rx_sdr.py:566-589)
        self._wide = [self.chz.wide_streamer(ch, self.R_b)
                      for ch in self.wide_channels]
        self._wide_streams = [BoundedStream() for _ in self._wide]
        self._wide_rx = [
            Receiver(bs, sps, tch_file=bs, tch_csd_file=bs,
                     kc=self.kc.tobytes(), fcch_type=self.fcch_type,
                     verbose=self.verbose, device=dev)
            for bs in self._wide_streams]
        self._wide_fwd = [0] * len(self._wide)

    @section("resample")
    def _resample(self, rows_full):
        """(M, H + R_b, 2) bank rows -> (M, S_b, 2) carrier streams."""
        f_cnt = self.block_frames
        span = self._k0 + (f_cnt - 1) * ROWS_PER_FRAME + self._k_span
        xw = rows_full[:, self._k0:span].unfold(1, self._k_span,
                                                ROWS_PER_FRAME)
        m = xw.shape[0]
        # one 2-D GEMM over (M*F*2, k_span) rows: matmul on the 4-D
        # window view runs as a batched product on a far slower path
        s = (xw.reshape(-1, self._k_span) @ self._w_t[str(xw.device)]).view(
            m, f_cnt, 2, -1)                              # (M, F, 2, n)
        return s.transpose(2, 3).reshape(m, self.S_b, 2)

    @section("step")
    def _step(self, x, *state):
        """One ingest step: (the put block, carried state) -> (streams,
        the block's bank rows (M, R_b, 2), next state); in mesh mode both
        are ShardedRows."""
        if self.mesh is not None:
            return self._sstep(x, *state)
        halo, bank_hist, stream_tail = state
        blk = torch.cat([halo, self._dequant(x)])
        rows = self.chz.analyzer.block(blk).permute(1, 0, 2)   # (M, R_b, 2)
        rows_full = torch.cat([bank_hist, rows], dim=1)
        stream = torch.cat([stream_tail, self._resample(rows_full)], dim=1)
        return stream, rows, (blk[-self._halo_len:],
                              rows_full[:, -self._hist:],
                              stream[:, -self.T_tail:])

    def _sstep(self, shards, bank_hist, stream_tail):
        """Mesh ingest step (gmr1_tpu/rx/wideband.py:672-680): the shared
        ingest (parallel/ingest.py) gives each device its carriers' rows,
        which it resamples into its own stream buffer."""
        rows = analyze_reshard(self.chz.analyzer, self.mesh,
                               [self._dequant(s) for s in shards])
        streams, hist, tail = [], [], []
        for r, bh, st in zip(rows, bank_hist, stream_tail):
            rows_full = torch.cat([bh, r], dim=1)
            s = torch.cat([st, self._resample(rows_full)], dim=1)
            streams.append(s)
            hist.append(rows_full[:, -self._hist:])
            tail.append(s[:, -self.T_tail:])
        return ShardedRows(streams), ShardedRows(rows), (hist, tail)

    def _put(self, x):
        """A block on the device: host arrays are uploaded (int16-quantized
        under h2d_dtype="int16"), tensors (the pre-resampler's blocks are
        already there) pass through.  Mesh mode: the overlapped shard
        stack from the host-carried halo tail, in float32, then quantized
        with one shared scale, one shard on each device."""
        if self.mesh is not None:
            if isinstance(x, torch.Tensor):
                x = x.cpu().numpy()
            sh, self._htail = overlapped_shards(
                np.asarray(x, np.float32), self._htail, self._halo_len,
                self.mesh.size)
            return self.mesh.put(self._quant(sh))
        if isinstance(x, torch.Tensor):
            return x.to(self.device)
        if self.device.type != "cuda":
            return torch.from_numpy(np.ascontiguousarray(self._quant(x)))
        k = self._stage_next()
        self._stage_fill(k, x)
        return self._stage_upload(k)

    def _stage_next(self) -> int:
        """The next pinned staging buffer (they alternate), allocated at
        the first call: float32 (n_block, 2), or int16 (n_block + 1, 2)
        under h2d_dtype="int16".  Main thread only."""
        if self._stage is None:
            shape = (self.n_block + int(self._h2d_int16), 2)
            dt = torch.int16 if self._h2d_int16 else torch.float32
            self._stage = [torch.empty(shape, dtype=dt, pin_memory=True)
                           for _ in range(2)]
            self._copy_stream = torch.cuda.Stream(self.device)
        k = self._stage_k
        self._stage_k ^= 1
        return k

    def _stage_fill(self, k: int, x: np.ndarray) -> None:
        """Write the host block x (int16-quantized under h2d_dtype="int16")
        into staging buffer k once buffer k's last copy to the device has
        finished (the worker calls this)."""
        ev = self._stage_ev[k]
        if ev is not None:
            ev.synchronize()
        if self._h2d_int16:
            self._quant(x, out=self._stage[k].numpy())
        else:
            np.copyto(self._stage[k].numpy(), x)

    def _stage_upload(self, k: int) -> torch.Tensor:
        """Staging buffer k on the device: a non-blocking copy on the copy
        stream, whose event the compute stream waits for; the device
        tensor is recorded on the compute stream, so the allocator keeps
        it until the compute stream is done with it."""
        cur = torch.cuda.current_stream(self.device)
        host = self._stage[k]
        with torch.cuda.stream(self._copy_stream):
            x = torch.empty(host.shape, dtype=host.dtype, device=self.device)
            x.copy_(host, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record(self._copy_stream)
        self._stage_ev[k] = ev
        cur.wait_event(ev)
        x.record_stream(cur)
        return x

    def _rotate_x(self, x: np.ndarray, n0: int) -> np.ndarray:
        """Grid pre-rotation with exact float64 phase from absolute
        sample offset n0 (pure: the reader's worker calls it)."""
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

    def _pull_block(self):
        """Next n_block on-grid samples, zero-padded at EOF, + the valid
        count; off-grid rates come through the pre-resampler, as a tensor
        on the device."""
        if self._pre is not None:
            with span("pre", self.prof):
                x, nv = self._pre.produce_block()
            self.counts["pre.blocks"] += 1
            return x, int(nv)
        return self._pad(self._pull(self.n_block))

    def _pad(self, x: np.ndarray) -> tuple[np.ndarray, int]:
        """(x zero-padded to n_block samples, its valid count)."""
        nv = x.shape[0]
        if nv < self.n_block:
            x = np.concatenate(
                [x, np.zeros((self.n_block - nv, 2), np.float32)])
        return x, nv

    def _q_start(self) -> None:
        """Submit the NEXT block's host work (source read, rotation, int16
        quantization; on the card also the write into a staging buffer)
        to the worker thread, to overlap this block's meta build and
        phase dispatch (gmr1_tpu/rx/wideband.py:724-749).  Only the
        single-device streaming path offloads: no mesh, no pre-resampler,
        no acquisition block left to replay, not at EOF, no job in flight.
        The counters and EOF are committed on the main thread when the
        job is taken (_next_put_block)."""
        if (self._q_job is not None or self.mesh is not None
                or self._pre is not None or self._replay_dev or self._eof):
            return
        if self._q_pool is None:
            self._q_pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="gmr1-block-reader")
        n0, n = self._n_pulled, self.n_block
        k = self._stage_next() if self.device.type == "cuda" else None

        def work():
            t = time.perf_counter()
            x, nv = self._pad(self._rotate_x(
                np.asarray(self._src.read(n), np.float32), n0))
            if k is None:
                x = self._quant(x)
            else:
                self._stage_fill(k, x)
                x = k
            return x, nv, time.perf_counter() - t
        self._q_job = self._q_pool.submit(work)

    def _q_stop(self) -> None:
        """Shut the worker down (run() returns or raises); a job still in
        flight is cancelled or waited for, and its block dropped."""
        if self._q_pool is not None:
            self._q_pool.shutdown(wait=True, cancel_futures=True)
        self._q_pool = self._q_job = None

    def _pin_eof(self, n_valid: int) -> None:
        """A short block pins the stream length (EOF)."""
        if n_valid < self.n_block and not self._eof:
            self._eof = True
            rows = self._n_in // self.chz.analyzer.hop
            self.n_stream = int(np.floor(rows * self.rrc.ratio))

    def _next_put_block(self):
        """Next block on the device: the acquisition replay list first,
        then the reader's job (_q_start), then the source.  A worker's
        exception raises here."""
        if self._replay_dev:
            x, nv = self._replay_dev.pop(0)
        elif self._q_job is not None:
            job, self._q_job = self._q_job, None
            with span("ingest_wait", self.prof):
                x, nv, busy = job.result()
            self.reader_s.append(busy)
            self._n_pulled += nv
            x = torch.from_numpy(x) if self.device.type != "cuda" \
                else self._stage_upload(x)
        else:
            x, nv = self._pull_block()
            x = self._put(x)
        self._n_in += nv
        self._pin_eof(nv)
        return x

    @section("ingest")
    def _ingest_block(self, b: int) -> None:
        """Run the ingest step for block b; sets self.streams (M, T_buf,
        2) and self._buf0 (absolute output sample of buffer index 0), and
        feeds every wide channel's synthesizer into its stream."""
        self._last_put = self._next_put_block()
        self.streams, rows, self._state = self._step(self._last_put,
                                                     *self._state)
        for ws, bs in zip(self._wide, self._wide_streams):
            bs.feed(ws.feed_cols(rows.take(ws.cols))
                    if isinstance(rows, ShardedRows) else ws.feed(rows))
        self._buf0 = b * self.S_b - self.T_tail

    # --- helpers -----------------------------------------------------

    def _log(self, msg: str) -> None:
        if self.verbose:
            print(msg)

    def _in_band(self, col: int) -> bool:
        """Does column col lie inside the band the front end can
        separate (every column on the grid)?"""
        band, m = self.chz.band, self.chz.n_chans
        return band is None or abs(col - m if col >= m // 2 else col) <= band

    def _images(self, toa: np.ndarray, energy: np.ndarray) -> np.ndarray:
        """(n_chans, beams) bool: the FCCH candidates that are the image
        of their inward neighbour's carrier (Channelizer.image_db), off
        the grid.  An image is a copy of that carrier: the same burst at
        the same time, image_db below it.  A candidate is refused when a
        candidate of column c - k (k = Channelizer.image_step columns
        inward) starts within a symbol of it and the candidate's burst
        energy lies nearer that image level than the neighbour's own, in
        dB: a carrier of its own on an empty column's place stands about
        level with its neighbour."""
        m, k = self.chz.n_chans, self.chz.image_step
        s = np.arange(m) - m * (np.arange(m) >= m // 2)
        inner = (s - k * np.sign(s)) % m
        lim = self.chz.image_db[np.minimum(np.abs(s), m // 2 - 1)] / 2.0
        with np.errstate(divide="ignore", invalid="ignore"):
            db = 10.0 * np.log10(energy[:, :, None]
                                 / energy[inner][:, None, :])
        near = np.abs(toa[:, :, None] - toa[inner][:, None, :]) <= self.sps
        return np.any(near & (db < lim[:, None, None]), axis=2)

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

    @staticmethod
    def _fetch_start(parts: list[dict]):
        """Start the device-to-host copies of `parts`, one dict of tensors
        a carrier group, each on its own device; returns the handle
        `_fetch_wait` takes (one event a device)."""
        host = [{k: v.to("cpu", non_blocking=True) for k, v in p.items()}
                for p in parts]
        evs = []
        for dev in {v.device for p in parts for v in p.values()}:
            if dev.type == "cuda":
                ev = torch.cuda.Event()
                ev.record(torch.cuda.current_stream(dev))
                evs.append(ev)
        return host, evs

    @staticmethod
    def _fetch_wait(handle) -> dict:
        """The fetched arrays, the groups' parts concatenated in order on
        axis 0 (every fetched result is carrier-major); a key that some
        parts lack (a block phase's traffic results) joins the parts that
        have it."""
        host, evs = handle
        for ev in evs:
            ev.synchronize()
        return {k: np.concatenate([h[k].numpy() for h in host if k in h])
                for k in dict.fromkeys(k for h in host for k in h)}

    @staticmethod
    def _in_order(res: dict, pos_lists) -> dict:
        """Results of a carrier subset fetched group by group (positions
        pos_lists in the subset) -> in the subset's order."""
        inv = np.argsort(np.concatenate(pos_lists))
        return {k: v[inv] for k, v in res.items()}

    def _groups(self) -> list[tuple[torch.device, int, int]]:
        """The carrier-slot groups of the block phase, [(device, first
        slot, end slot)]: one a mesh device when the slot count divides by
        the mesh size (gmr1_tpu/rx/wideband.py:1150-1167), else a single
        group on self.device."""
        n = len(self.carriers)
        if self.mesh is None or n % self.mesh.size:
            return [(self.device, 0, n)]
        per = n // self.mesh.size
        return [(d, j * per, (j + 1) * per)
                for j, d in enumerate(self.mesh.devices)]

    def _by_group(self, cars, slot: dict) -> list:
        """A carrier subset split by group: [(group index, device,
        positions in cars, local slots)], groups in order."""
        out = []
        for j, (dev, lo, hi) in enumerate(self._groups()):
            pos = [i for i, c in enumerate(cars) if lo <= slot[id(c)] < hi]
            if pos:
                out.append((j, dev, pos, [slot[id(cars[i])] - lo
                                          for i in pos]))
        return out

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
            stream, _rows, state = self._step(x, *state)
            yield b, stream

    @section("acquire")
    def acquire(self) -> list[_Carrier]:
        """Batched FCCH scan over every grid channel (fcch_single_init of
        gmr1_rx.c:605 vectorized across the transponder), streamed over
        the capture prefix in two passes (see the module doc), with
        multi-beam forking when `beams` > 1 (gmr1_rx.c:643-741)."""
        sps, ft = self.sps, self.fcch_type
        blen = ft.len_syms * sps
        n_b = ft.len_syms
        n330 = (330 * SYM_RATE * sps) // 1000
        n650 = (650 * SYM_RATE * sps) // 1000
        scan = n330 if self.beams <= 1 else n650
        acq_len = scan + 2 * blen
        m = self.chz.n_chans
        hop = self.chz.analyzer.hop
        n_abl = -(-acq_len // self.S_b)

        blocks, valid_in = self._acq_pull_blocks(n_abl)
        avail_out = int(np.floor((valid_in // hop) * self.rrc.ratio))
        if avail_out < n330 + blen:
            raise ValueError("capture shorter than the 330 ms FCCH scan")
        # clip the scan to the real stream length: windows past EOF are
        # zero-padded and would null SI-cycle-mixed multi-beam candidates
        n_corr = -(-min(scan + blen, avail_out - blen) // sps) - n_b + 1

        # ---- pass 1: correlation-power scan -----------------------------
        parts = [_acq_pwr_block(ft, buf, sps, self.T_tail)
                 for _, buf in self._acq_replay(blocks)]
        pwr = torch.cat(parts, dim=1)[:, n_b - 1:n_b - 1 + n_corr]
        del parts
        if self.beams <= 1:
            toa_r = fcch.rough_from_pwr(ft, pwr, sps).cpu().numpy()[:, None]
            valid = np.ones_like(toa_r, bool)
        else:
            toa_r, valid = fcch.rough_multi_batch_pwr(ft, pwr, sps,
                                                      k=self.beams)
        del pwr
        toa_r = np.clip(toa_r, 0, acq_len - 2 * blen).astype(np.int64)

        # ---- pass 2: gather candidate fine/SNR windows ------------------
        total = n_abl * self.S_b
        wlen = 3 * blen                     # [toa_r - blen, toa_r + 2*blen)
        cand = []                           # (col, beam, s0)
        per_block: list[list[int]] = [[] for _ in range(n_abl)]
        for col in range(m):
            if not self._in_band(col):
                self.counts["acq.out_of_band"] += int(valid[col].sum())
                continue
            if self.arfcn_filter is not None \
               and self._col2arfcn(col) not in self.arfcn_filter:
                continue
            for k in range(toa_r.shape[1]):
                if not valid[col, k]:
                    continue
                s0 = min(max(int(toa_r[col, k]) - blen, 0), total - wlen)
                bw = max(0, -(-(s0 + wlen) // self.S_b) - 1)
                per_block[bw].append(len(cand))
                cand.append((col, k, s0))

        toa = np.zeros(toa_r.shape, np.int64)
        ferr = np.zeros(toa_r.shape, np.float32)
        snr = np.full(toa_r.shape, np.nan, np.float32)  # non-cand: skip
        energy = np.full(toa_r.shape, np.nan, np.float32)
        images = self.chz.image_db is not None
        if cand:
            # per replay block: ONE batched window gather
            w3_parts, order = [], []
            for b, buf in self._acq_replay(blocks):
                grp = per_block[b]
                if not grp:
                    continue
                base = b * self.S_b - self.T_tail
                cols = upload(np.asarray([cand[ci][0] for ci in grp]),
                               self.device)
                starts = upload(np.asarray([[cand[ci][2] - base]
                                             for ci in grp]), self.device)
                w3_parts.append(_windows_rows(buf, cols, starts, wlen)[:, 0])
                order += grp
            w3 = torch.cat(w3_parts)[upload(np.argsort(order), self.device)]
            off = upload(np.asarray([int(toa_r[c, k]) - s0
                                      for c, k, s0 in cand]), self.device)
            fine = dict(zip(("rel", "ferr", "snr"),
                            _acq_fine_snr(ft, w3, off, sps, blen)))
            if images:       # the burst's energy at its fine TOA
                fine["e"] = _energy(_windows_rows(
                    w3, torch.arange(len(cand), device=w3.device),
                    fine["rel"][:, None], blen)[:, 0])
            got = self._fetch_wait(self._fetch_start([fine]))
            for ci, (c, k, s0) in enumerate(cand):
                toa[c, k] = s0 + int(got["rel"][ci])
                ferr[c, k] = float(got["ferr"][ci])
                snr[c, k] = float(got["snr"][ci])
                if images:
                    energy[c, k] = float(got["e"][ci])
        if images:           # an image is no carrier, nor a beam's ref
            image = self._images(toa, energy)
            self.counts["acq.image"] += int(image.sum())
            snr[image] = np.nan
        self.carriers = []
        for col in range(m):
            arfcn = self._col2arfcn(col)
            if not self._in_band(col) or (self.arfcn_filter is not None
                                          and arfcn not in self.arfcn_filter):
                continue
            finite = np.isfinite(snr[col])
            ref = int(np.nanargmax(snr[col])) if finite.any() else 0
            ref_snr = float(snr[col, ref]) if finite.any() else 0.0
            for k in range(toa.shape[1]):
                s = float(snr[col, k])
                if not np.isfinite(s) or s < self.snr_min:
                    continue
                # multi-beam gates against the strongest beam on this
                # ARFCN (gmr1_rx.c:706-714): snr >= ref/6, |df| <= 500 Hz
                if self.beams > 1:
                    if s < ref_snr / 6.0:
                        continue
                    dhz = abs(float(ferr[col, k]) - float(ferr[col, ref])) \
                        * SYM_RATE / (2 * np.pi)
                    if k != ref and dhz > 500.0:
                        continue
                cd = ChanDesc(sps=sps)
                cd.align = int(toa[col, k])
                cd.freq_err = float(ferr[col, k])
                self.carriers.append(_Carrier(col=col, arfcn=arfcn, cd=cd,
                                              snr=s))
                self._log(f"[+] ARFCN {arfcn} FCCH @{cd.align} snr={s:.1f} "
                          f"freq={cd.freq_err * SYM_RATE / 2 / np.pi:.1f} Hz")
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

    def _build_meta(self, active_ids, F: int) -> dict:
        """Per-block schedule of EVERY carrier slot as whole-array numpy
        (row i = self.carriers[i], so each carrier keeps its TCH9 ring
        row from block to block; `act` marks the active ones).  Control:
        BCCH on sirfn%8==2, CCCH on sirfn%8 not in {0, 2}
        (gmr1_rx.c:867,800), 1 BCCH + 6 CCCH windows per carrier per
        8-frame block; TCH3 windows at tch3.tn and NT9 windows at
        tch9.tn on every frame.  `flags`: bit 0 tch9-active (and
        active), bit 1 the TCH3 cipher flag, bits 16..16+F the frames
        at or after tch9.from_fn (gmr1_rx.c:437-441).  `t`: the slots
        whose traffic half runs, the active ones with TCH3 or TCH9 up at
        the block boundary (the walks read no other slot's traffic
        results); `trow`: a slot's row in the traffic results (the rows
        of `t` in order), -1 outside `t`."""
        cars = self.carriers
        sps, buf0, fo = self.sps, self._buf0, self.frame_out
        n = len(cars)

        def vec(get, dt):
            return np.fromiter((get(c) for c in cars), dt, n)

        align = vec(lambda c: c.cd.align, np.int64)
        fn0 = vec(lambda c: c.cd.fn, np.int64)
        delay = vec(lambda c: c.cd.sa_sirfn_delay, np.int64)
        stn = vec(lambda c: c.cd.sa_bcch_stn, np.int64)
        tn3 = vec(lambda c: c.cd.tch3.tn, np.int64)
        ci3 = vec(lambda c: c.cd.tch3.ciph, np.int64)
        tn9 = vec(lambda c: c.cd.tch9.tn, np.int64)
        a9 = vec(lambda c: c.cd.tch9.active, bool)
        ff9 = vec(lambda c: c.cd.tch9.from_fn, np.int64)
        a3 = vec(lambda c: c.cd.tch3.active, bool)
        act = vec(lambda c: id(c) in active_ids, bool)
        t = np.flatnonzero(act & (a3 | a9))
        trow = np.full(n, -1, np.int64)
        trow[t] = np.arange(t.size)
        fns = fn0[:, None] + np.arange(F)
        r8 = ((fns - delay[:, None]) & 63) % 8
        is_b = r8 == 2
        is_c = (r8 != 0) & (r8 != 2)
        nb = max(1, int(is_b.sum(1).max(initial=0)))
        nc = max(1, int(is_c.sum(1).max(initial=0)))
        # first-nb true frame indices per carrier, in fn order; surplus
        # columns demodulate garbage the walk never reads
        fr_b = np.argsort(~is_b, axis=1, kind="stable")[:, :nb]
        fr_c = np.argsort(~is_c, axis=1, kind="stable")[:, :nc]

        def idx(tn, frames, win, wlen):
            out = (align[:, None] - buf0 + sps * 39 * tn[:, None]
                   - (win >> 1) + frames * fo)
            return np.clip(out, 0, self.T_buf - wlen - 1)

        w = sps + sps // 2
        fa = np.arange(F)[None, :]
        started = fns >= ff9[:, None]
        sbits = (started.astype(np.int64) << (16 + np.arange(F))).sum(1)
        return dict(
            rows=vec(lambda c: c.col, np.int64),
            freq=vec(lambda c: c.cd.freq_err, np.float32),
            fn0=fn0, p=vec(lambda c: c.cd.tch3.p, np.int64),
            flags=(a9 & act).astype(np.int64) | ((ci3 & 1) << 1) | sbits,
            idx_b=idx(stn, fr_b, 20 * sps, BU.BCCH.len_syms * sps + 20 * sps),
            idx_c=idx(stn, fr_c, 10 * sps, BU.DC6.len_syms * sps + 10 * sps),
            idx_t=idx(tn3, fa, w, BU.NT3_FACCH.len_syms * sps + w),
            idx_9=idx(tn9, fa, w, BU.NT9.len_syms * sps + w),
            fns=fns, is_b=is_b, is_c=is_c, jb=np.cumsum(is_b, 1) - 1,
            jc=np.cumsum(is_c, 1) - 1, a9=a9, act=act, started=started,
            t=t, trow=trow)

    def _build_sub_meta(self, cars, kind: str, F: int) -> dict:
        """Meta of a supplemental subset phase: `idx` is the one slot
        (tch3.tn or tch9.tn) the phase demodulates."""
        sps, buf0, fo = self.sps, self._buf0, self.frame_out
        w = sps + sps // 2
        wlen = (BU.NT3_FACCH if kind == "tch3" else BU.NT9).len_syms \
            * sps + w
        tn = np.asarray([c.cd.tch3.tn if kind == "tch3" else c.cd.tch9.tn
                         for c in cars], np.int64)
        align = np.asarray([c.cd.align for c in cars], np.int64)
        base = align - buf0 + sps * 39 * tn - (w >> 1)
        return dict(
            rows=np.asarray([c.col for c in cars], np.int64),
            freq=np.asarray([c.cd.freq_err for c in cars], np.float32),
            fn0=np.asarray([c.cd.fn for c in cars], np.int64),
            p=np.asarray([c.cd.tch3.p for c in cars], np.int64),
            flags=np.asarray([(c.cd.tch3.ciph & 1) << 1 for c in cars],
                             np.int64),
            idx=np.clip(base[:, None] + np.arange(F) * fo, 0,
                        self.T_buf - wlen - 1))

    # a block meta's device keys: the control half's, and those only the
    # traffic half reads
    _CTRL_META = ("rows", "freq", "idx_b", "idx_c")
    _TRAFFIC_META = ("fn0", "p", "flags", "idx_t", "idx_9")

    def _meta_dev(self, m: dict, device, lo: int = 0,
                  hi: int | None = None) -> dict:
        """The device half of a meta dict, its carrier rows [lo, hi) (a
        carrier group), on `device`.  A block meta's traffic half goes to
        "tr": the rows of the group's slots in m["t"], with "slots" their
        ring rows in the group; the same tensors as the control half's
        and "slots" None where that is every slot; None where it is
        none."""
        if "t" not in m:        # a correction phase's subset, all device
            return {k: upload(v[lo:hi], device) for k, v in m.items()}
        out = {k: upload(m[k][lo:hi], device) for k in self._CTRL_META}
        n = out["rows"].shape[0]
        t = m["t"][(m["t"] >= lo) & (m["t"] < lo + n)] - lo
        if not t.size:
            out["tr"] = None
        elif t.size == n:
            out["tr"] = dict(rows=out["rows"], freq=out["freq"], slots=None,
                             **{k: upload(m[k][lo:hi], device)
                                for k in self._TRAFFIC_META})
        else:
            out["tr"] = dict(slots=upload(t, device), **{
                k: upload(m[k][lo:hi][t], device)
                for k in ("rows", "freq") + self._TRAFFIC_META})
        return out

    def _a5(self, fn: int, nbits: int) -> np.ndarray:
        """Host downlink keystream of one frame (the FACCH3 flushes).
        Every carrier shares the key, so carriers in step share their
        frames' streams: they are kept by (fn, nbits)."""
        ks = self._a5_seen.get((fn, nbits))
        if ks is None:
            if len(self._a5_seen) >= 4096:
                self._a5_seen.clear()
            ks = self._a5_seen[fn, nbits] = a5op.keystream_np(
                self.kc, fn, nbits)[0]
        return ks

    @section("block")
    def _process_block(self, active: list[_Carrier], prefetch) -> None:
        prof = self.prof
        sps, F = self.sps, self.block_frames
        frame_len = self.frame_out
        with span("phase", prof):
            self._q_start()     # the next block's read overlaps this one's

            # ---- one phase on PRE-block state ---------------------------
            # everything depends only on block-boundary channel state, so
            # the whole block (control for every carrier; TCH3 + NT9 + CSD
            # chain over the rings for those with a traffic channel) runs
            # before any fetch; rare same-block activations / realigns
            # re-run a small correction phase for just those carriers.  A
            # split mesh runs it once a carrier group, on the group's
            # device, over the group's own rings
            with span("meta", prof):
                slot = {id(c): i for i, c in enumerate(self.carriers)}
                mb = self._build_meta({id(c) for c in active}, F)
                self._last_meta = mb
                n_t = mb["t"].size
                self._count("dec", bcch=mb["idx_b"].size,
                            ccch=mb["idx_c"].size, tch3=n_t * F, nt9=n_t * F)
                self._count("phase", slots=len(self.carriers),
                            traffic_slots=n_t)
                groups = self._groups()
                sizes = [hi - lo for _, lo, hi in groups]
                if self._il is None \
                        or [il.n.shape[0] for il in self._il] != sizes:
                    self._il = [InterleaverState(
                        buf=torch.zeros((hi - lo, tch9.INTER_DEPTH,
                                         tch9.INTER_WIDTH), device=d),
                        n=torch.zeros((hi - lo,), dtype=torch.int64,
                                      device=d))
                        for d, lo, hi in groups]
                metas = [self._meta_dev(mb, d, lo, hi)
                         for d, lo, hi in groups]
            il_prev = self._il
            with span("dispatch", prof):
                smalls, bigs = [], []
                for m, il in zip(metas, il_prev):
                    small, big = _phase_block(self.streams, m, il, self.kc,
                                              sps)
                    smalls.append(small)
                    bigs.append(big)
                handle = self._fetch_start(smalls)
        # the next block's ingest is queued behind this block's phase:
        # its host read and upload overlap the phase on the device
        prefetch()
        with span("fetch", prof):
            res = self._fetch_wait(handle)

        # ---- host FSM pass 1: BCCH/CCCH + TCH3 activation ----------------
        with span("walk", prof):
            tch3_new, tch3_from, pre3, pre9 = self._walk_control(
                active, slot, mb, res)

        # ---- TCH3 walk over the speculative block-phase results ---------
        with span("walk_tch3", prof):
            new_ids = {id(c) for c in tch3_new}
            fev: list = []
            # carriers (re)assigned or realigned in pass 1 have stale
            # block-phase windows: walk the supplemental phase instead
            cars3 = [c for c in active if pre3[id(c)][0]
                     and id(c) not in new_ids
                     and c.cd.align == pre3[id(c)][1]]
            if cars3:
                slots3 = np.fromiter((slot[id(c)] for c in cars3), np.int64,
                                     len(cars3))
                # their rows of the traffic results, and of each group's
                # soft bits (the group's rows follow those of the groups
                # before it)
                rows3 = mb["trow"][slots3]
                t_lo = np.searchsorted(mb["t"], [lo for _, lo, _ in groups])
                fev += self._walk_tch3_vec(
                    cars3, rows3, res, {}, F,
                    [(bigs[j]["f_ebits"], int(r - t_lo[j]))
                     for j, r in zip(slots3 // sizes[0], rows3)])
            supp = tch3_new + [
                c for c in active
                if pre3[id(c)][0] and id(c) not in new_ids
                and c.cd.align != pre3[id(c)][1] and c.cd.tch3.active]
            if supp:
                with span("supp", prof):
                    parts, f_src = [], [None] * len(supp)
                    for _j, d, pos, _local in self._by_group(supp, slot):
                        m = self._build_sub_meta([supp[i] for i in pos],
                                                 "tch3", F)
                        self._count("dec", tch3=m["idx"].size)
                        s3, feb = _phase_tch3s(
                            self.streams, self._meta_dev(m, d), self.kc, sps)
                        parts.append((pos, s3))
                        for r, i in enumerate(pos):
                            f_src[i] = (feb, r)
                    res_s = self._in_order(
                        self._fetch_wait(self._fetch_start(
                            [p for _, p in parts])),
                        [pos for pos, _ in parts])
                fev += self._walk_tch3_vec(supp, np.arange(len(supp)), res_s,
                                           tch3_from, F, f_src)
            jobs = self._facch_collect(fev)

        with span("facch", prof):
            self._t9_assigned: set[int] = set()
            if jobs:
                self._walk_facch(jobs, *self._decode_facch(jobs))

        # ---- TCH9 emission + corrections ---------------------------------
        # the chain already ran in the block phase from pre-block state;
        # only carriers whose state changed during the walks (activation
        # with an in-block start, reassignment, SI1 realign) re-run their
        # ring rows from the pre-block rings with corrected windows and
        # validity.  `fix_bound` caps the block phase's emissions: the
        # chain is causal, so for a mid-block reassignment the frames
        # BEFORE the handover decoded right on the old slot and are
        # still emitted (as the reference's sequential walk does,
        # gmr1_rx.c:276-353)
        with span("tch9", prof):
            fix9: list[_Carrier] = []
            resets: list[int] = []
            fix_bound: dict[int, int] = {}
            for c in active:
                a0, al0, f0_, tn0 = pre9[id(c)]
                st9 = c.cd.tch9
                if not st9.active:
                    continue
                assigned = id(c) in self._t9_assigned
                if not a0:
                    if st9.from_fn <= c.cd.fn + F - 1:
                        fix9.append(c)
                        resets.append(1)     # fresh assignment: zero ring
                        fix_bound[id(c)] = -1 << 62   # nothing from main
                elif assigned and (c.cd.align, c.cd.fn) == (al0, f0_):
                    # reassignment re-inits the ring (rx_tch9_init); the
                    # block phase's results stay valid up to the handover
                    fix9.append(c)
                    resets.append(1)
                    fix_bound[id(c)] = st9.from_fn
                elif assigned or (c.cd.align, c.cd.fn, st9.tn) \
                        != (al0, f0_, tn0):
                    # realigned mid-block: the old windows are suspect for
                    # the whole block, so re-run it all
                    fix9.append(c)
                    resets.append(1 if assigned else 0)
                    fix_bound[id(c)] = -1 << 62
            self._tch9_emit_main(active, slot, mb, res, fix_bound, pre9)
            self._il = [big["il2"] for big in bigs]
            if fix9:
                self._tch9_fix(fix9, resets, slot, il_prev, F)

        # ---- advance block -----------------------------------------------
        # one frame of slot offset + the largest burst window fits in two
        # extra frame lengths: stop when the NEXT block would need samples
        # past the capture end (gmr1_rx.c:893-894)
        with span("walk", prof):
            for car in active:
                cd = car.cd
                d_align, d_freq = cd._pending
                del cd._pending
                cd.align += F * frame_len + d_align
                cd.freq_err += d_freq
                cd.fn += F
                if self.n_stream is not None \
                   and cd.align + (F + 2) * frame_len > self.n_stream:
                    car.done = True

    def _walk_control(self, active, slot: dict, mb: dict, res: dict):
        """Host FSM pass 1 over the block phase's results: BCCH (SI1
        realign, closed-loop tracking, deferred to the block's end in
        cd._pending) and CCCH (IMM.ASS activates TCH3).  Returns
        (carriers newly on TCH3, {carrier: first active frame}, the
        pre-walk TCH3 and TCH9 state of every active carrier)."""
        sps, F = self.sps, self.block_frames
        pre3 = {id(c): (c.cd.tch3.active, c.cd.align) for c in active}
        pre9 = {id(c): (c.cd.tch9.active, c.cd.align, c.cd.fn,
                        c.cd.tch9.tn) for c in active}
        tch3_new: list[_Carrier] = []
        tch3_from: dict[int, int] = {}       # carrier -> first active f
        is_b, is_c, jb, jc = mb["is_b"], mb["is_c"], mb["jb"], mb["jc"]
        act = mb["act"]
        self._count("read", bcch=is_b[act].sum(), ccch=is_c[act].sum())
        for car in active:
            i = slot[id(car)]
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
                        # SI1 realign sets cd.fn to THIS frame's true fn
                        # (and shifts cd.align for a BCCH slot change);
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
                            if not any(c is car for c in tch3_new):
                                tch3_new.append(car)
                            tch3_from[id(car)] = f + 1
                            self._log(f"[+] ARFCN {car.arfcn} TCH3 on "
                                      f"TN {st3.tn}")
                        self._emit(car, gsmtap.GMR1_CCCH, fn,
                                   cd.sa_bcch_stn, l2)
            cd._pending = (d_align, d_freq)   # applied after the walks
        return tch3_new, tch3_from, pre3, pre9

    # --- TCH3 host FSM (gmr1_rx.c:356-600 over batched results) ---------

    def _walk_tch3_vec(self, tch3_set, rows, res, tch3_from, F, f_src):
        """TCH3 FSM walk: the energy gates, DKAB/weak counting and EMA
        trackers (gmr1_rx.c:531-600) as whole-array numpy per frame,
        per-carrier Python only on events.  Speech is already decoded;
        this walk selects it.  FACCH bursts come back as events for the
        deferred soft-bit gather (_facch_collect): f_src[i] is
        (device-resident (C', F, 104) soft-bit tensor, row) of tch3_set
        position i; `rows` maps a position to its result row."""
        n = len(tch3_set)
        rows = np.asarray(rows)
        act = np.fromiter((c.cd.tch3.active for c in tch3_set), bool, n)
        ebv = np.fromiter((c.cd.tch3.energy_burst for c in tch3_set),
                          np.float64, n)
        edv = np.fromiter((c.cd.tch3.energy_dkab for c in tch3_set),
                          np.float64, n)
        wk = np.fromiter((c.cd.tch3.weak_cnt for c in tch3_set),
                         np.int64, n)
        fn0 = np.fromiter((c.cd.fn for c in tch3_set), np.int64, n)
        f0v = np.fromiter((tch3_from.get(id(c), 0) for c in tch3_set),
                          np.int64, n)
        et = res["et"][rows].astype(np.float64)
        dkf = res["dk_found"][rows]
        bt = res["bt"][rows]
        sidv = res["f_sid"][rows]
        speech_ok = np.zeros((n, F), bool)
        fev = [[] for _ in range(n)]
        n_read = 0
        for f in range(F):
            a = act & (f >= f0v)
            n_a = int(a.sum())
            if not n_a:
                continue
            n_read += n_a
            be = et[:, f]
            weak = a & (be < (edv + ebv) / 4.0)
            dk = weak & dkf[:, f]
            nodk = weak & ~dkf[:, f]
            wk[nodk] += 1
            tear = nodk & (wk > 8)
            act[tear] = False
            edv[dk] = 0.1 * be[dk] + 0.9 * edv[dk]
            strong = a & ~weak
            wk[strong] = 0
            ebv[strong] = 0.1 * be[strong] + 0.9 * ebv[strong]
            isfa = strong & (bt[:, f] == 0)
            issp = strong & (bt[:, f] != 0)
            speech_ok[issp, f] = True
            for i in np.flatnonzero(dk):
                self._emit(tch3_set[i], gsmtap.GMR1_TCH3 | gsmtap.GMR1_DKAB,
                           int(fn0[i]) + f, tch3_set[i].cd.tch3.tn,
                           res["dk_bits"][rows[i], f].view(np.uint8))
            for i in np.flatnonzero(tear):
                self._log(f"[-] ARFCN {tch3_set[i].arfcn} TCH3 END "
                          f"@{int(fn0[i]) + f}")
            for i in np.flatnonzero(isfa):
                fev[i].append((f, int(fn0[i]) + f, int(sidv[i, f])))
        for i, c in enumerate(tch3_set):
            st = c.cd.tch3
            st.active = bool(act[i])
            st.energy_burst = float(ebv[i])
            st.energy_dkab = float(edv[i])
            st.weak_cnt = int(wk[i])
        for i, f in zip(*np.nonzero(speech_ok)):
            r = rows[i]
            tch3_set[i].speech.append(res["s_f0"][r, f].tobytes())
            tch3_set[i].speech.append(res["s_f1"][r, f].tobytes())
        self._count("read", tch3=n_read)
        return [(tch3_set[i], *f_src[i], fev[i])
                for i in range(n) if fev[i]]

    def _facch_collect(self, fev):
        """Gather the FACCH soft bits the walks found (one gather + fetch
        per source tensor, none on blocks without FACCH bursts), then
        replay the 4-burst accumulate / sync-flip FSM (gmr1_rx.c:454-493)
        in fn order."""
        if not fev:
            return []
        by_src: dict[int, tuple[object, list]] = {}
        for _car, tensor, row, evs in fev:
            _ten, items = by_src.setdefault(id(tensor), (tensor, []))
            items.extend((row, f) for f, _fn, _s in evs)
        got = {}
        for tid, (tensor, items) in by_src.items():
            ij = upload(np.asarray(items, np.int64), tensor.device)
            rows = tensor[ij[:, 0], ij[:, 1]].cpu().numpy()
            got[tid] = dict(zip(items, rows))
        jobs = []
        for car, tensor, row, evs in fev:
            st = car.cd.tch3
            for f, fn, sid in evs:
                if sid != st.sync_id:
                    jobs.append(self._facch_flush(car, fn))
                bi = fn & 3
                st.ebits[bi] = got[id(tensor)][(row, f)]
                st.sync_id = sid
                st.bi_fn[bi] = fn
                st.burst_cnt += 1
                if st.burst_cnt == 4:
                    jobs.append(self._facch_flush(car, fn))
        return [j for j in jobs if j is not None]

    def _facch_flush(self, car: _Carrier, fn: int):
        """Snapshot a 4-burst FACCH3 group for the batched decode
        (_rx_tch3_facch_flush, gmr1_rx.c:394-451)."""
        st = car.cd.tch3
        job = None
        if (st.bi_fn >= 0).any():
            eb = st.ebits.reshape(-1).astype(np.int8).copy()
            ciph = np.concatenate([
                self._a5(int(st.bi_fn[k]) & 0xFFFFFFFF, 96)
                for k in range(4)])
            job = dict(car=car, eb=eb, ciph=ciph, fn=fn,
                       had_ciph=bool(st.ciph))
        st.sync_id ^= 1
        st.burst_cnt = 0
        st.bi_fn[:] = -1
        st.ebits[:] = 0
        return job

    def _decode_facch(self, jobs):
        """Both cipher variants of every flush in one batched decode:
        rows [0, n) clear, rows [n, 2n) under the job's keystream."""
        n = len(jobs)
        self._count("dec", tch3=2 * 4 * n)    # a flush: 4 bursts, twice
        eb = np.stack([j["eb"] for j in jobs])
        ciph = np.zeros((2 * n, 384), np.uint8)
        ciph[n:] = np.stack([j["ciph"] for j in jobs])
        l2, _sbits, bad, _m = facch3.decode(
            upload(np.concatenate([eb, eb]), self.device),
            upload(ciph, self.device))
        return (l2.cpu().numpy(), bad.cpu().numpy()), n

    def _walk_facch(self, jobs, res, n: int) -> None:
        """The reference's cipher retry/learn rule, host-side."""
        l2, bad = res
        for k, j in enumerate(jobs):
            car, st = j["car"], j["car"].cd.tch3
            if j["had_ciph"]:
                l2k, badk = l2[n + k], bad[n + k]
                self._count("read", tch3=4)
            else:
                l2k, badk = l2[k], bad[k]
                # a failed clear decode reads the ciphered one too
                self._count("read", tch3=8 if badk else 4)
                if badk and not bad[n + k]:    # cipher retry hits
                    l2k, badk = l2[n + k], bad[n + k]
                    st.ciph = 1
            if not badk:
                self._emit(car, gsmtap.GMR1_TCH3 | gsmtap.GMR1_FACCH,
                           j["fn"] - 3, st.tn, l2k)
                if facch3_is_ass_cmd_1(l2k):
                    car.cd.tch9.active = True
                    car.cd.tch9.tn = facch3_ass_cmd_1_parse(l2k)
                    # frames before the assignment must not feed the CSD
                    # deinterleaver (the reference starts rx_tch9 on the
                    # next frame, gmr1_rx.c:437-441); the ring row is
                    # reset by the correction chain (_chain_fix)
                    car.cd.tch9.from_fn = j["fn"] + 1
                    self._t9_assigned.add(id(car))
                    self._log(f"[+] ARFCN {car.arfcn} TCH9 on TN "
                              f"{car.cd.tch9.tn}")

    # --- TCH9 (gmr1_rx.c:276-353 over batched demods) ------------------

    def _tch9_emit_main(self, active, slot, mb, res, fix_bound,
                        pre9) -> None:
        """Emit the block phase's speculative TCH9 results (FACCH9 frames
        and chained CSD payloads) for every (carrier, frame) whose
        pre-block state survived the walks; `fix_bound` caps the frames
        of carriers whose state changed mid-block (their later frames
        come from _tch9_fix)."""
        a9, act, started, fns = mb["a9"], mb["act"], mb["started"], \
            mb["fns"]
        # absent where no block phase ran a traffic half
        sid, badf9 = res.get("sid9"), res.get("badf9")
        for car in active:
            i = slot[id(car)]
            if not (a9[i] and act[i]):
                continue
            r = mb["trow"][i]       # its row of the traffic results
            bound = fix_bound.get(id(car))
            ok = started[i] if bound is None \
                else started[i] & (fns[i] < bound)
            self._count("read", nt9=ok.sum())
            # pre-block slot: a mid-block reassignment changes
            # cd.tch9.tn, but these frames decoded on the OLD slot
            tn = pre9[id(car)][3]
            for f in np.flatnonzero(ok):
                if sid[r, f] == 0:
                    if not badf9[r, f]:
                        self._emit(car,
                                   gsmtap.GMR1_TCH9 | gsmtap.GMR1_FACCH,
                                   int(fns[i, f]), tn, res["l2f9"][r, f])
                else:
                    l2 = res["l2a"][r, f]
                    self._emit(car, gsmtap.GMR1_TCH9, int(fns[i, f]),
                               tn, l2)
                    car.csd.append(l2.tobytes())

    def _tch9_fix(self, fix9, resets, slot, il_prev, F: int) -> None:
        """Correction pass for carriers whose TCH9 state changed during
        the walks: re-demodulate their NT9 windows with the updated
        state, emit FACCH9 from the fresh results, and re-run the CSD
        chain for just their ring rows from the pre-block rings
        (_chain_fix), written into the post-block rings (self._il).  Each
        carrier group's part runs on its own device, over its own rings;
        both fetches take every group at once."""
        n = len(fix9)
        parts = []
        with span("supp", self.prof):
            for j, d, pos, local in self._by_group(fix9, slot):
                m = self._build_sub_meta([fix9[i] for i in pos], "tch9", F)
                self._count("dec", nt9=m["idx"].size)
                s9, e9s, kss = _phase_tch9s(
                    self.streams, self._meta_dev(m, d), self.kc, self.sps)
                parts.append((j, d, pos, local, s9, e9s, kss))
            pos_lists = [p[2] for p in parts]
            r9 = self._in_order(self._fetch_wait(self._fetch_start(
                [p[4] for p in parts])), pos_lists)
        fns = np.asarray([[c.cd.fn + f for f in range(F)] for c in fix9],
                         np.int64)
        started = fns >= np.asarray(
            [c.cd.tch9.from_fn for c in fix9])[:, None]
        self._count("read", nt9=started.sum())
        is_f9 = (r9["sid9"] == 0) & started
        is_t9 = (r9["sid9"] == 1) & started
        for i, f in np.argwhere(is_f9):
            if not r9["badf9"][i, f]:
                self._emit(fix9[i], gsmtap.GMR1_TCH9 | gsmtap.GMR1_FACCH,
                           int(fns[i, f]), fix9[i].cd.tch9.tn,
                           r9["l2f9"][i, f])
        fix = np.zeros((n, 3), np.int64)
        fix[:, 1] = resets           # 1 = newly (re)assigned: zero the ring
        fix[:, 2] = (is_t9.astype(np.int64) << np.arange(F)).sum(1)
        l2parts = []
        with span("supp", self.prof):
            for j, d, pos, local, _s9, e9s, kss in parts:
                fix[pos, 0] = local      # the ring row within the group
                self._il[j], l2a = _chain_fix(il_prev[j], self._il[j],
                                              upload(fix[pos], d), e9s, kss)
                l2parts.append(dict(l2a=l2a.transpose(0, 1)))
            l2a = self._in_order(self._fetch_wait(self._fetch_start(
                l2parts)), pos_lists)["l2a"]
        for i, car in enumerate(fix9):
            tn = car.cd.tch9.tn
            for f in np.flatnonzero(is_t9[i]):
                l2 = l2a[i, f]
                self._emit(car, gsmtap.GMR1_TCH9, int(fns[i, f]), tn, l2)
                car.csd.append(l2.tobytes())

    # --- wide carriers (width 2/3/5) --------------------------------------

    def _fwd_wide(self, i: int) -> None:
        """Forward wide channel i's newly decoded frames (ARFCN-tagged) as
        they appear: wide frames emit DURING the run, not at EOF."""
        ch, rxw = self.wide_channels[i], self._wide_rx[i]
        for (t, fn, tn, l2b) in rxw.frames[self._wide_fwd[i]:]:
            self.frames.append((ch.arfcn, t, fn, tn, l2b))
            if self.sink is not None:
                self.sink.send(t, fn, tn, l2b, arfcn=ch.arfcn)
        self._wide_fwd[i] = len(rxw.frames)

    @section("wide")
    def _step_wide(self, eof: bool = False) -> None:
        """Advance every wide channel's incremental Receiver over the
        samples its BoundedStream holds, then trim the stream to the
        receiver's look-back bound: host memory stays O(block) for the
        whole capture (the reference's split-then-decode pipeline,
        utils/gmr1_process_recording.py:89-110, as one streaming
        program)."""
        for i, (bs, rxw) in enumerate(zip(self._wide_streams,
                                          self._wide_rx)):
            rxw.stream_run(eof=eof)
            bs.trim(rxw.stream_keep_from())
            self._fwd_wide(i)

    def _process_wide(self) -> None:
        """EOF drain + per-channel result carriers for the wide path (the
        incremental decode happens in _step_wide during the run)."""
        if self._wide:
            self._step_wide(eof=True)
        for i, (ch, rxw) in enumerate(zip(self.wide_channels,
                                          self._wide_rx)):
            if not len(self._wide_streams[i]):
                continue
            col = self.chz.freq2index(ch.frequency)
            car = _Carrier(col=-1 if col is None else col, arfcn=ch.arfcn,
                           cd=ChanDesc(sps=self.sps), snr=float("nan"))
            car.speech, car.csd = rxw.speech, rxw.csd
            car.frames = list(rxw.frames)
            self.wide_carriers.append(car)
            self._log(f"[+] wide {ch}: {len(rxw.frames)} L2 frames")

    # --- top level --------------------------------------------------------

    def device_block_time(self, iters: int = 4) -> float:
        """Seconds a block of the ingest step plus the block phase, re-run
        on the resident state after run(): the receiver's throughput with
        the host reads, uploads and walks out of the picture.  One warm
        call, then `iters` calls between device synchronizations (on the
        CPU the same calls, timed).  The phase is the last block's, its
        traffic half on that block's slots with a traffic channel; a split
        mesh runs it once a carrier group, as run() does."""
        if self._last_put is None or self._last_meta is None:
            raise RuntimeError("run() first")
        prof = dict(self.prof)      # the re-runs are no section of run()
        metas = [self._meta_dev(self._last_meta, d, lo, hi)
                 for d, lo, hi in self._groups()]
        devs = {str(d) for d in (self.mesh.devices if self.mesh is not None
                                 else (self.device,))}

        def sync():
            for d in devs:
                if torch.device(d).type == "cuda":
                    torch.cuda.synchronize(d)

        def once():
            streams, _rows, _state = self._step(self._last_put, *self._state)
            return [_phase_block(streams, m, il, self.kc, self.sps)
                    for m, il in zip(metas, self._il)]
        once()
        sync()
        t0 = time.perf_counter()
        for _ in range(iters):
            once()
        sync()
        t = (time.perf_counter() - t0) / iters
        self.prof.clear()
        self.prof.update(prof)
        return t

    def run(self) -> int:
        """Acquire + decode the whole capture.  Returns #L2 frames."""
        if not self.carriers:
            self.acquire()
        self.wide_carriers = []
        if not self.carriers and not self._wide:
            self._log("[!] no FCCH found on any carrier")
            return 0
        # carriers lag the ingest frontier by up to T_tail + their initial
        # align, so after EOF keep draining with zero-input blocks until
        # every carrier hits its done bound; wide channels run until EOF
        drain_max = self.T_tail // self.S_b + 3
        b = drained = 0
        self.block_walls: list[float] = []   # per-iteration wall clock
        self.block_profs: list[dict] = []    # per-iteration section split
        pending = None   # prefetched (streams, buf0, was_eof) of block b
        try:
            while True:
                t_iter = time.perf_counter()
                prof0 = dict(self.prof)
                narrow_done = all(c.done for c in self.carriers)
                if narrow_done and (not self._wide or self._eof):
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
                    # block b+1's ingest: it takes the reader's job, so
                    # EOF shows in `was` only once that job is taken
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
                if self._wide:
                    self._step_wide()
                b += 1
                self.block_walls.append(time.perf_counter() - t_iter)
                self.block_profs.append(
                    {k: v - prof0.get(k, 0.0) for k, v in self.prof.items()
                     if v - prof0.get(k, 0.0) > 0.0})
        finally:
            self._q_stop()
        self._process_wide()
        return len(self.frames)
