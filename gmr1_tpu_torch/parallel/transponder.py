"""Multi-device full-transponder pipelines.

Counterpart of gmr1_tpu/parallel/transponder.py.  The reference scales
by one channelizer process feeding per-ARFCN FIFOs to demodulator
processes (utils/gmr1_process_recording.py); here one program runs over
a device set (`ingest.Mesh`):

  1. time-parallel analysis: the wideband block is split in time; each
     device runs the polyphase analysis on its shard, whose P*M filter
     history the host prepends (ingest.overlapped_shards);
  2. reshard: the channel bank moves from time-sharded to
     carrier-sharded, column c to device c // (M/D) (ingest.analyze_reshard);
  3. carrier-parallel back end: each device RRC-resamples, demodulates
     and decodes its carriers.  Outputs come back concatenated in
     carrier order on the mesh's first device, so row c is carrier
     column c, as in JAX.

Constraints: the local time block is a multiple of M (the 2x-oversample
sign pattern restarts at each shard's row 0) and M divides by the number
of devices.
"""

from __future__ import annotations

import numpy as np
import torch

from ..l1 import bcch
from ..ops import cplx
from ..ops.interleave import InterleaverState
from ..sdr import bursts as BU
from ..sdr import modem
from .ingest import (Mesh, analyze_reshard, ici_bytes_per_step,
                     overlapped_shards)

# the window products below are f32 GEMMs
torch.backends.cuda.matmul.allow_tf32 = False


def _check_geometry(chz, mesh: Mesh, n_local: int) -> None:
    m, d = chz.n_chans, mesh.size
    if m % d:
        raise ValueError(f"M={m} does not split over {d} devices")
    if n_local % m:
        raise ValueError(f"the local block ({n_local}) is not a multiple "
                         f"of M={m}")


def _f32_analyzer(chz):
    """The channelizer's analysis bank with the float32 channel DFT.  The
    transponders decode every column, those with no carrier too, and the
    bf16 DFT table's rounding leaks every column into every other: on the
    card's noiseless 1064-carrier transponder capture (M=1088) an empty
    column 53 dB under the carriers decoded a comb's SI1 and passed its
    CRC (ROADMAP queue 3)."""
    ana = chz.analyzer
    return ana.from_numpy(ana.h_poly, ana.chunk_frames, dft_bf16=False)


class ShardedTransponder:
    """Carrier + time sharded channelize -> demod -> decode pipeline.

    One instance is bound to (mesh, channelizer geometry, burst type,
    samples a device).  `step(x)` takes the time-sharded wideband block
    and returns the decoded frames of every carrier and the summed CRC
    failures.  The analysis runs the float32 channel DFT
    (`self.analyzer`, _f32_analyzer)."""

    def __init__(self, chz, mesh: Mesh, n_local: int,
                 burst: BU.Burst = BU.BCCH, sps: int = 4,
                 burst_pos: int = 0, win: int | None = None):
        _check_geometry(chz, mesh, n_local)
        self.chz, self.mesh = chz, mesh
        self.n_devices = d = mesh.size
        self.n_local = n_local
        self.burst, self.sps, self.burst_pos = burst, sps, burst_pos
        self.analyzer = ana = _f32_analyzer(chz)
        self._rrc = chz._rrc_resampler(1)
        r_total = (n_local // ana.hop) * d
        self._blen = burst.len_syms * sps
        # search window: bounded by the resampled stream length
        n_stream = int(np.floor(r_total * self._rrc.ratio))
        if win is None:
            win = 16 * sps
        self.win = max(8, min(win, n_stream - burst_pos - self._blen))
        self._halo_len = ana.p * ana.m

    def _local(self, bank_c):
        """One device's carriers: RRC resample, the burst window, demod
        and decode."""
        streams = self._rrc(bank_c)                        # (Ml, N_s, 2)
        size = self._blen + self.win
        start = min(max(self.burst_pos, 0), streams.shape[1] - size)
        r = modem.demod(self.burst, streams[:, start:start + size],
                        sps=self.sps, win=self.win)
        return bcch.decode(r.ebits)

    def shard_input(self, x: np.ndarray) -> list[torch.Tensor]:
        """A host wideband array (D*n_local, 2) as overlapped
        (halo-prepended) time shards with a zero left edge, one on each
        mesh device."""
        if x.shape[0] != self.n_devices * self.n_local:
            raise ValueError((x.shape, self.n_devices, self.n_local))
        sh, _ = overlapped_shards(
            np.asarray(x, np.float32),
            np.zeros((self._halo_len, 2), np.float32),
            self._halo_len, self.n_devices)
        return self.mesh.put(sh)

    def step(self, x_sharded):
        """Run one step.  Returns (l2 (M, 24), crc_fail (M,), metric (M,),
        n_bad scalar), on the mesh's first device, rows in carrier
        order."""
        outs = [self._local(b) for b in analyze_reshard(
            self.analyzer, self.mesh, x_sharded)]
        dev = self.mesh.devices[0]
        l2, crc_fail, metric = (torch.cat([o[k].to(dev) for o in outs])
                                for k in range(3))
        n_bad = sum(o[1].to(dev).to(torch.int64).sum() for o in outs)
        return l2, crc_fail, metric, n_bad


class StreamingTransponder:
    """Streaming multi-device pipeline: state carried across steps.

    The fixed-schedule core of `rx.wideband.WidebandReceiver(mesh=...)`:
    every carrier runs the full mixed workload on a static slot map with
    no host in the loop.  Each `step(x, carry)` consumes the next
    D*n_local wideband samples (time-sharded) and, over F TDMA frames on
    every carrier:

      * PFB analysis with a real left-edge halo prepended host-side to
        every shard (shard 0's from the previous step's tail), so the
        output stream is seamless across steps;
      * the reshard to carrier-sharded rows, then per carrier:
        - BCCH demod + Viterbi + CRC on frame `bcch_frame`,
        - NT3 speech demod + TCH3 decode on every frame,
        - DKAB demod with the burst/DKAB energy EMA trackers
          (gmr1_rx.c:570-581) carried across steps, a loop over the
          frames, branch-free,
        - NT9 demod + TCH9 9k6 decode chaining the depth-3 inter-burst
          deinterleaver (tch9.c:109) across frames and steps.

    Geometry: at sps=4 one TDMA frame is exactly 2500 channel rows
    (936*4 output samples * 625/936), so F frames = F*2500 rows stream
    through with the RRC polyphase at phase 0 every frame: the static
    per-frame window matrices apply to every step.

    The carry is a list with one dict a device (ema_burst, ema_dkab (Ml,),
    il: InterleaverState with buf (Ml, 3, 648), n (Ml,)), carrier order
    within the mesh order."""

    FRAME_ROWS = 2500          # chan rows per TDMA frame at sps=4

    def __init__(self, chz, mesh: Mesh, frames: int = 8,
                 burst_pos: int = 60, win: int = 16, tn_tch: int = 4,
                 tn_tch9: int = 8, dkab_p: int = 9, bcch_frame: int = 2):
        sps = 4
        d = mesh.size
        self.analyzer = ana = _f32_analyzer(chz)     # as ShardedTransponder
        r_total = frames * self.FRAME_ROWS
        if r_total % d:
            raise ValueError(f"{r_total} rows do not split over {d} devices")
        r_local = r_total // d
        n_local = r_local * ana.hop
        _check_geometry(chz, mesh, n_local)
        self.chz, self.mesh = chz, mesh
        self.n_devices, self.n_local, self.frames = d, n_local, frames
        self.sps, self.m_local = sps, chz.n_chans // d
        self.win, self.dkab_p = win, dkab_p
        frame_len = 936 * sps
        rrc = chz._rrc_resampler(1)
        self.halo_len = ana.p * ana.m
        self._tail = np.zeros((self.halo_len, 2), np.float32)
        self.ici_bytes_per_step = ici_bytes_per_step(ana, r_local, d)

        # static per-frame window geometry (phase-0 alignment, see doc)
        def geom(slot, blen_syms, w, frame_list=None):
            out = []
            for f in (range(frames) if frame_list is None else frame_list):
                pos = burst_pos + f * frame_len + slot * 39 * sps - (w >> 1)
                k_min, wmat = rrc.window_matrix(pos, blen_syms * sps + w)
                if k_min + wmat.shape[1] > r_total:
                    raise ValueError(f"window past the block end (frame "
                                     f"{f}, slot {slot})")
                out.append((k_min, wmat))
            return out
        self.w3 = sps + sps // 2
        self._g_bcch = geom(0, BU.BCCH.len_syms, win, [bcch_frame])
        self._g_tch = geom(tn_tch, BU.NT3_SPEECH.len_syms, self.w3)
        self._g_tch9 = geom(tn_tch9, BU.NT9.len_syms, self.w3)
        self._wdev: dict = {}

    def _windows(self, bank_c, geoms):
        """(F', Ml, n, 2) windows of every carrier, one 2-D GEMM a frame:
        rows[k_min:k_min + K] of each carrier through the (n, K) matrix."""
        key = (id(geoms), str(bank_c.device))
        if key not in self._wdev:
            self._wdev[key] = [torch.as_tensor(w, device=bank_c.device)
                               for _k, w in geoms]
        ml = bank_c.shape[0]
        out = []
        for (k_min, _w), wmat in zip(geoms, self._wdev[key]):
            k_span = wmat.shape[1]
            xw = bank_c[:, k_min:k_min + k_span].permute(1, 0, 2)
            y = wmat @ xw.reshape(k_span, ml * 2)             # (n, Ml*2)
            out.append(y.view(-1, ml, 2).permute(1, 0, 2))
        return torch.stack(out)

    def _local(self, bank_c, carry: dict):
        """One device's carriers for one step -> (outputs, new carry)."""
        from ..l1 import tch3, tch9
        from ..sdr import dkab
        sps, w3 = self.sps, self.w3
        # BCCH on the configured frame
        rb = modem.demod(BU.BCCH, self._windows(bank_c, self._g_bcch)[0],
                         sps=sps, win=self.win)
        l2b, crcb, _ = bcch.decode(rb.ebits)
        # NT3 speech on every frame (batched over F)
        wt = self._windows(bank_c, self._g_tch)           # (F, Ml, n, 2)
        rs = modem.demod(BU.NT3_SPEECH, wt, sps=sps, win=w3)
        sf0, sf1, _s, _smet = tch3.decode(rs.ebits)
        # DKAB + the EMA trackers, frame by frame (sequential EMA state,
        # gmr1_rx.c:570-581, branch-free)
        eb, ed = carry["ema_burst"], carry["ema_dkab"]
        dk_bits, dk_found = [], []
        for wf in wt:
            b = wf.shape[1] >> 5
            be = torch.sum(cplx.abs2(wf[:, b:wf.shape[1] - b]),
                           dim=-1) / wf.shape[1]
            det = (ed + eb) / 4.0
            rd = dkab.demod(wf, sps, self.dkab_p)
            is_dkab = be < det
            eb, ed = (torch.where(is_dkab, eb, 0.1 * be + 0.9 * eb),
                      torch.where(is_dkab & rd.found, 0.1 * be + 0.9 * ed,
                                  ed))
            dk_bits.append(rd.ebits)
            dk_found.append(rd.found & is_dkab)
        # TCH9 with the deinterleaver chained across frames and steps: one
        # batched Viterbi over all F frames (only the ring loops)
        r9 = modem.demod(BU.NT9, self._windows(bank_c, self._g_tch9),
                         sps=sps, win=w3)
        il, l2_t9, _sa, _st, met9 = tch9.decode_frames(
            r9.ebits, tch9.MODE_9K6, carry["il"])
        out = dict(l2b=l2b, crcb=crcb, sf0=sf0, sf1=sf1,
                   dk_bits=torch.stack(dk_bits), dk_found=torch.stack(dk_found),
                   l2_t9=l2_t9, met9=met9)
        return out, dict(ema_burst=eb, ema_dkab=ed, il=il)

    def shard_input(self, x: np.ndarray) -> list[torch.Tensor]:
        """Overlapped halo shards, one on each mesh device; the raw tail
        carries on the host between steps (it owns the stream anyway), so
        streaming stays sample-exact."""
        if x.shape[0] != self.n_devices * self.n_local:
            raise ValueError((x.shape, self.n_devices, self.n_local))
        sh, self._tail = overlapped_shards(
            np.asarray(x, np.float32), self._tail, self.halo_len,
            self.n_devices)
        return self.mesh.put(sh)

    def carry_init(self) -> list[dict]:
        """Initial streaming state, one dict a mesh device."""
        ml = self.m_local
        return [dict(ema_burst=torch.zeros((ml,), device=dev),
                     ema_dkab=torch.zeros((ml,), device=dev),
                     il=InterleaverState(
                         buf=torch.zeros((ml, 3, 648), device=dev),
                         n=torch.zeros((ml,), dtype=torch.int64,
                                       device=dev)))
                for dev in self.mesh.devices]

    def carry_from_numpy(self, carry) -> list[dict]:
        """The carry from host arrays in carrier order, e.g. JAX's carry
        after a step: ema_burst, ema_dkab (M,) and il = (buf (M, 3, 648),
        n (M,)) (any pair with .buf/.n or a 2-tuple)."""
        il = carry["il"]
        buf, n = (il.buf, il.n) if hasattr(il, "buf") else il
        ml = self.m_local

        def part(a, j, dtype, dev):
            a = np.asarray(a)[j * ml:(j + 1) * ml]
            return torch.as_tensor(a.astype(dtype), device=dev)
        return [dict(ema_burst=part(carry["ema_burst"], j, np.float32, dev),
                     ema_dkab=part(carry["ema_dkab"], j, np.float32, dev),
                     il=InterleaverState(buf=part(buf, j, np.float32, dev),
                                         n=part(n, j, np.int64, dev)))
                for j, dev in enumerate(self.mesh.devices)]

    def step(self, x_sharded, carry: list[dict]):
        """One streaming step.  Returns (outputs, new carry); outputs on
        the mesh's first device in carrier order: l2b, crcb (M, ...) and
        the frame-major sf0, sf1, dk_bits, dk_found, l2_t9, met9
        (F, M, ...)."""
        res = [self._local(b, c) for b, c in zip(
            analyze_reshard(self.analyzer, self.mesh, x_sharded), carry)]
        dev = self.mesh.devices[0]
        outs = [o for o, _c in res]
        out = {k: torch.cat([o[k].to(dev) for o in outs],
                            dim=0 if k in ("l2b", "crcb") else 1)
               for k in outs[0]}
        return out, [c for _o, c in res]
