"""Smoke test of the PyTorch port (gmr1_tpu_torch) on one CUDA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --ab OLD    # kernels V, P and A5 of another checkout
                                      # (OLD/gmr1_tpu_torch/kernels) beside
                                      # this one's, and nothing else

Phases, each fatal on failure (the script exits non-zero and prints no
result line):

  1. environment  card name and power limit (nvidia-smi), torch / CUDA
                  versions, nvcc; a CUDA device is required.
  2. build        the three hand-written kernels from
                  gmr1_tpu_torch/kernels/ into gmr1_tpu_torch/_build/,
                  one nvcc per source, all started together.
  3. kernel V     Viterbi kernel vs its plain PyTorch version on the card:
                  K5_12 flush, K5_14 flush, TCH3_K7 and K9_13 tail-biting
                  at B=2048 seeded integer-sbit bursts; K5_12 at the
                  receiver's CCCH batch; the traffic path's shapes at the
                  wideband receiver's batches (TCH3 speech TCH3_K7 T=48,
                  FACCH9 K5_12 T=320, TCH9 9k6 K5_12 T=484, FACCH3 K5_14
                  T=96); every shape the per-carrier receiver decodes,
                  one burst a call (BCCH/CCCH K5_12 T=212, FACCH3 K5_14
                  T=96, FACCH9 K5_12 T=320, TCH9 K5_12 T=484 at B=1,
                  speech TCH3_K7 T=48 at B=2); all-zero (fully tied)
                  tail-biting K5 and K7 bursts; batches of 1, 3 and 33;
                  T of 37, 45 and 70; the 256-state form at the DC12
                  shape (K9_13 tail-biting, B=1064, T=208) and at B=1,
                  all-zero at B=2048, B=3 and 33, T=45, K9_13 flush,
                  a table that is not antipodal, and a synthetic K=8
                  tail-biting code (S=128) at B=33; bits and metric
                  exact.  Each shape
                  is timed eager and by CUDA-graph replay (device time)
                  beside its bound and the serial-chain estimate.
  4. kernel P     PFB branch-filter kernel vs its plain version at the
                  34 MHz geometry (M=1088, P=10, R=20000; and R=10000
                  and 5000, a block's rows on 2 and 4 mesh shards) and
                  at the 30.72 MS/s wide-carrier geometry (M=984, hop=492, the
                  perfect-reconstruction prototype's P): its output and
                  the channel bank within rtol 2e-4 / atol 1e-4; timed
                  beside its bound and the one-call yardstick
                  F.conv1d(groups=hop) (full f32, inputs already in its
                  layout; checked to the same tolerance, never on the
                  port's path); eager and by CUDA-graph replay.  At each
                  of those shapes the bf16 channel DFT (the analysis'
                  default on the card: torch.mm with bf16 operands and a
                  float32 output) against its plain version within 1e-5
                  of the bank's peak, and against the f32 bank at <= -40
                  dB of its RMS; the f32 and bf16 products timed beside
                  their bounds.
  5. kernel A5    A5/1 keystream kernel vs its plain version at the
                  receiver's NT9 batch (8512 frame numbers, 658 bits,
                  downlink and uplink), at batches of 33 and 8513 (off a
                  warp, off a CTA), with a random key and one of eight
                  distinct bytes, and at batch 1 for the per-carrier
                  receiver's 96, 208 and 658 bits, and vs the a5.c
                  transcription `keystream_np`: bit-exact.  Timed eager
                  and by CUDA-graph replay (dl only, dl + ul, batch 1)
                  beside the byte bound and the serial-chain estimate.
  6. carrier      the per-carrier entry point: a one-carrier capture at
                  sps 4 with the e2e story (FCCH, SI1, IMM.ASS, speech,
                  FACCH3 ASS.CMD.1, DKABs, FACCH9, ciphered 9k6 CSD,
                  teardown) through `python -m gmr1_tpu_torch.rx SPS
                  CAP CAP KEY CAP --device cuda` in-process: every
                  GSMTap frame, speech frame and CSD payload held
                  against the synthesis truth; kernels V and A5 launched.
  7. paths        the wideband receiver's newer paths through the CLI:
                  a 30.72 MS/s capture (off the 31.25 kHz grid: the
                  pre-resampler; M=984) with every channel inside the
                  pre-resampler's passband (884) live and control-only, comb stream 0 carrying a second FCCH beam
                  3 frames later (SI1 with sa_sirfn_delay 3), and a
                  width-3 and a width-5 wide carrier (FCCH + SI1) on
                  columns left empty for them; `--wideband CAP --fs
                  30.72e6 --beams 2 --wide AxW --wide BxW --stream
                  --device cuda`: every seeded carrier and both beams
                  decode their own SI1s (and CCCHs) bit-exact, both wide
                  carriers their SI1s, and no other frame is emitted.
  8. slice        a synthetic 34 MHz L-band capture with every usable grid
                  channel live (FCCH every 8 frames, SI1 BCCH at k%8==2,
                  one CCCH burst at k%8==3, noise); the carriers of comb
                  stream 0 also carry a TCH3/TCH9 story (IMM.ASS, speech,
                  FACCH3 ASS.CMD.1, DKABs, FACCH9, ciphered 9k6 CSD,
                  silence) and those of stream 1 a TCH9 re-assignment
                  story (two ASS.CMD.1s, two CSD trains); through
                  WidebandReceiver(device="cuda").run(): every seeded ARFCN
                  acquired, every decoded BCCH/CCCH/FACCH3/FACCH9 L2
                  bit-exact against the synthesis truth, speech, DKAB,
                  CSD order and TCH3 teardown checked per carrier, and
                  all three kernels launched by the receiver, through
                  the block reader (worker thread, pinned staging, copy
                  stream) and the bf16 channel DFT; one block phase a
                  block.  A second run with the f32 DFT
                  (analyzer.dft_bf16 = False): verify_slice and every
                  CRC-protected frame equal to the first run's; both runs'
                  Msamples/s, sections (ingest_wait among them) and
                  device_block_time; the first receiver's
                  device_block_time with the DFT in turns (bf16, f32, f32,
                  bf16).  A third, profiled run: its kernels' busy share,
                  its block uploads pinned, no pageable upload a block.
  9. mesh         the multi-device form on several shards of the card (2
                  and 4 on one card; every card where there are more):
                  analyze_reshard on a [slice] block against the single-
                  device analysis (f32 transport to rtol 2e-4 / atol
                  1e-4, bf16 within one bf16 ulp), also over an NCCL
                  process group of one rank; WidebandReceiver(mesh=) over
                  the whole [slice] capture: verify_slice, every
                  CRC-protected frame equal to [slice]'s, kernels P, V and
                  A5 launched, P D times a block, the block phase split
                  over the 1064 carriers (D groups: D phases a block, each
                  launching V and A5 as [slice]'s one does),
                  device_block_time of the split form; h2d_dtype="int16"
                  on one device through the block reader (verify_slice,
                  Msamples/s beside [slice]'s float32 in the same call);
                  ShardedTransponder and StreamingTransponder
                  (two steps) on 2 shards over a full-width capture on
                  their static slot map, against the port's CPU run bit
                  for bit and against the truth, every column without a
                  carrier failing its CRC; they run the f32 channel DFT,
                  and a witness runs the ShardedTransponder's step with a
                  bf16 DFT (the card's product; on the CPU its plain
                  version, the table alone and a2 alone rounded): the
                  empty columns that pass their CRC, whose SI1 they
                  decode, their power beside the f32 analysis's.
 10. split        `python -m gmr1_tpu_torch.channelizer` in pfb and direct
                  mode on two [slice] blocks written as a cfile, four
                  ARFCNs: SI1s decoded to the truth, the card's streams
                  against the CPU's (pfb mode: the card's f32-DFT streams,
                  made in-process as the CLI makes them; the CLI's
                  default bf16 run within -40 dB of them); TF32 off for
                  cuDNN; the process-
                  recording driver's commands name the port's modules.
 11. l1           one DC12 and one RACH burst a grid carrier (1064
                  each; some RACH decoded with a wrong SB mask) encoded
                  on the card, noised, decoded on the card (DC12: kernel
                  V's K=9 tail-biting form), and 5 chained TCH9 2k4 and
                  4k8 bursts a carrier: bursts, bits, CRC flags, metrics
                  and rings equal the port's CPU run; kernel V timed at
                  the DC12 shape beside its bound.
 12. codec        the AMBE vocoder: decode_frames at bench_codec.py's
                  shape (4096 channels x 50 random frames, seed 11) on
                  the card, frames/s and real-time voice channels; 8 of
                  those channels and tests/test_codec.py's constant-
                  pitch, silence, tone and batched vectors on the card
                  within 1 LSB of the port's CPU PCM on >= 99.9 % of
                  samples; `python -m gmr1_tpu_torch.codec` turns the
                  [carrier] phase's --speech-out file into a WAV (header,
                  160 samples a frame, PCM against the CPU).
 13. tools        gmr1_rach_gen (351 unit-magnitude symbols) and
                  gmr1_gen_mat (G @ u ^ g equal to the encoder) on the
                  card.

Kernel launches are counted per path (carrier, paths, slice, mesh,
split, l1, tools): each
count is set to 0 just before the path runs and read just after, and a
path fails if a kernel it runs was never launched ([paths], whose
carriers are control-only, if it launched kernel A5).  The last three lines
are the card's name and power limit, a JSON object with each kernel's
launches (all paths, and per path), error, times, bound (the larger of
its bytes over 3.35 TB/s and its operations over 67 TFLOP/s f32) and
one-call PyTorch yardstick (null where none exists), and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

SPS = 4
FRAME4 = 936 * SPS            # samples per TDMA frame at 4 sps
F = 8                         # frames per block
F0 = 16                       # true fn of content frame 0 (%8 == 0)
NS = 4                        # payload streams of the comb synthesis
CENTER_ARFCN = 544            # 34 MHz grid channels map to ARFCN 12..1075
FS = 34e6
CONTENT_BLOCKS = 6            # after one leading noise block: 2.24 s
KC = np.zeros(8, np.uint8)    # the receiver's default A5/1 key
TN3, P3 = 10, 9               # the IMM.ASS TCH3 slot and DKAB position
DKAB_BITS = [0, 1, 1, 0, 1, 0, 0, 1]


def _require(ok: bool, what) -> None:
    """Fail the smoke (a check that -O cannot strip)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def _rc(t, beta=0.35):
    """Raised-cosine pulse (TX RRC x RX RRC)."""
    den = 1.0 - (2.0 * beta * t) ** 2
    safe = np.where(np.abs(den) < 1e-8, 1.0, den)
    out = np.sinc(t) * np.cos(np.pi * beta * t) / safe
    return np.where(np.abs(den) < 1e-8, np.sinc(t) * np.pi / 4, out)


def si1_l2(rng, fn, delay=0):
    """SI1 frame w/ Seg2Abis encoding the given BCCH fn (stn=0)."""
    l2 = rng.integers(0, 256, 24, dtype=np.uint8)
    sf, mf, hb = fn >> 6, (fn >> 4) & 3, (fn >> 3) & 1
    l2[0] = 0x08
    l2[9] = 0x80
    l2[10] = (delay & 0x0F) << 3   # stn top bits 0
    l2[11] = sf >> 7
    l2[12] = ((sf & 0x7F) << 1) | (mf >> 1)
    l2[13] = ((mf & 1) << 7) | (hb << 6)
    return l2


def _ks(fn: int, nbits: int) -> np.ndarray:
    """Downlink A5/1 keystream from the a5.c transcription (never from
    the kernel under test)."""
    from gmr1_tpu_torch.ops import a5
    return a5.keystream_np(KC, fn, nbits)[0]


def _dkab_signal(p: int, bits) -> np.ndarray:
    """117-symbol DKAB slot triple at SPS with the pi/4 rotation."""
    sig = np.zeros(117 * SPS, np.complex64)
    for tone, base in enumerate((2 + p, 2 + p + 59)):
        ph = 0.0
        for s in range(5):
            if s:
                ph += np.pi * bits[tone * 4 + (s - 1)]
            for kk in range(SPS):
                i = (base + s) * SPS + kk
                sig[i] += np.exp(1j * (ph + (np.pi / 4) * i / SPS))
    return sig


def _imm_ass_l2(rng, tn: int, p: int) -> np.ndarray:
    l2 = rng.integers(0, 256, 24, dtype=np.uint8)
    l2[1], l2[2] = 0x06, 0x3F
    l2[8] = ((p & 0x3F) << 2) | ((tn >> 3) & 3)
    l2[9] = (tn & 7) << 5
    return l2


def _ass_cmd_1_l2(rng, tn9: int) -> np.ndarray:
    l2 = rng.integers(0, 256, 10, dtype=np.uint8)
    l2[3], l2[4] = 0x06, 0x2E
    l2[5] = (l2[5] & 0xFC) | ((tn9 >> 3) & 0x03)
    l2[6] = (l2[6] & 0x1F) | ((tn9 & 0x07) << 5)
    l2[9] &= 0xF0
    return l2


def _place(bb: np.ndarray, pos: int, x1) -> None:
    """Add a 1-sps burst, raised-cosine shaped to SPS, to the baseband bb
    at sample pos."""
    from gmr1_tpu_torch.ops import cplx
    xc = cplx.to_complex(x1)
    nsym = xc.shape[-1]
    t = np.arange(nsym * SPS)[:, None] / SPS - np.arange(nsym)[None, :]
    bb[pos:pos + nsym * SPS] += xc @ _rc(t).astype(np.float32).T


def build_stream(rng, n_frames: int, story: str | None = None,
                 beam2: bool = False):
    """One payload stream's 4-sps baseband + its truth.

    Control on every stream: FCCH at k%8==0, SI1 at k%8==2, a CCCH at
    k%8==3.  `beam2` adds a second FCCH beam 3 frames later (its FCCH in
    place of the CCCH at k%8==3, its SI1s with sa_sirfn_delay 3 at
    k%8==5, tests/test_wideband.py:255-290).  `story` adds traffic in the
    second 8-frame cycle (base 8):
      "e2e"       IMM.ASS (TN 10, P 9) at k=11, speech at 12-14, FACCH3
                  ASS.CMD.1 to TN 13 at 16-19, DKABs at 20-21, FACCH9 on
                  TN 13 at 20, ciphered 9k6 CSD on TN 13 at 21-25, then
                  silence (TCH3 tears down);
      "reassign"  IMM.ASS at k=11, ASS.CMD.1 to TN 13 at 12-15 and to
                  TN 14 at 20-23, CSD trains on TN 13 at 16-20 and on
                  TN 14 at 24-28."""
    import torch

    from gmr1_tpu_torch.l1 import bcch, ccch, facch3, facch9, tch3, tch9
    from gmr1_tpu_torch.ops import cplx
    from gmr1_tpu_torch.sdr import bursts as BU
    from gmr1_tpu_torch.sdr import fcch, modem

    bb = np.zeros(n_frames * FRAME4, np.complex64)

    def at(k, tn):
        return k * FRAME4 + tn * 39 * SPS

    def place(k, x1, tn=0):
        _place(bb, at(k, tn), x1)

    chirp = cplx.to_complex(fcch._chirp_np(fcch.FCCH, SPS, "dual")) \
        / np.sqrt(2)
    truth = dict(si1={}, ccch={}, facch3={}, facch9={}, speech=[], csd=[],
                 story=story)
    k_ia = 11 if story else None
    for k in range(n_frames):
        if k % 8 == 0:
            bb[k * FRAME4:k * FRAME4 + len(chirp)] += chirp
        elif k % 8 == 2:
            l2 = si1_l2(rng, F0 + k)
            truth["si1"][F0 + k] = bytes(l2)
            place(k, modem.mod(BU.BCCH, bcch.encode(l2)))
        elif beam2 and k % 8 == 3:
            bb[k * FRAME4:k * FRAME4 + len(chirp)] += chirp
        elif beam2 and k % 8 == 5:
            l2 = si1_l2(rng, F0 + k, delay=3)
            truth["si1"][F0 + k] = bytes(l2)
            place(k, modem.mod(BU.BCCH, bcch.encode(l2)))
        elif k % 8 == 3:
            if k == k_ia:
                l2 = _imm_ass_l2(rng, TN3, P3)
            else:
                l2 = rng.integers(0, 256, 24, dtype=np.uint8)
                l2[1] = 0x00                    # not an IMM.ASS
            truth["ccch"][F0 + k] = bytes(l2)
            place(k, modem.mod(BU.DC6, ccch.encode(l2)))
    if story is None:
        return bb, truth

    def facch3_at(ks, tn9):
        l2 = _ass_cmd_1_l2(rng, tn9)
        truth["facch3"][F0 + ks[0]] = bytes(l2)
        fe = facch3.encode(l2, np.zeros(32, np.uint8)).reshape(4, 104)
        for bi, k in enumerate(ks):
            place(k, modem.mod(BU.NT3_FACCH, fe[bi], sync_id=0), TN3)

    def csd_at(ks, tn9):
        il = tch9.interleaver_init(dtype=torch.uint8)
        pay = []
        for k in ks:
            p = rng.integers(0, 256, 60, dtype=np.uint8)
            il, eb = tch9.encode(p, tch9.MODE_9K6, np.zeros(10, np.uint8),
                                 np.zeros(4, np.uint8), il,
                                 _ks(F0 + k, 658))
            place(k, modem.mod(BU.NT9, eb, sync_id=1), tn9)
            pay.append(bytes(p))
        truth["csd"].append(pay)

    if story == "e2e":
        for k in (12, 13, 14):
            f0 = rng.integers(0, 256, 10, dtype=np.uint8)
            f1 = rng.integers(0, 256, 10, dtype=np.uint8)
            truth["speech"] += [bytes(f0), bytes(f1)]
            place(k, modem.mod(BU.NT3_SPEECH, tch3.encode(
                f0, f1, np.zeros(4, np.uint8))), TN3)
        facch3_at((16, 17, 18, 19), 13)
        for k in (20, 21):
            sig = _dkab_signal(P3, DKAB_BITS)
            bb[at(k, TN3):at(k, TN3) + len(sig)] += sig
        l2 = rng.integers(0, 256, 38, dtype=np.uint8)
        l2[37] &= 0xF0                          # 300 message bits
        truth["facch9"][F0 + 20] = bytes(l2)
        place(20, modem.mod(BU.NT9, facch9.encode(
            l2, np.zeros(10, np.uint8), np.zeros(4, np.uint8),
            _ks(F0 + 20, 658)), sync_id=0), 13)
        csd_at(range(21, 26), 13)
    else:
        facch3_at((12, 13, 14, 15), 13)
        facch3_at((20, 21, 22, 23), 14)
        csd_at(range(16, 21), 13)
        csd_at(range(24, 29), 14)
    return bb, truth


def synthesize(fs: float, content_blocks: int, seed: int = 0xA44):
    """Wideband capture with every usable grid channel live: NS baseband
    streams, each multiplied by a frequency comb of its carriers (a comb
    is periodic in M samples: one M-point IFFT), blocks interpolated
    from 4 sps to fs.  Returns (planar (N, 2) float32, center frequency,
    {arfcn: stream}, [truth per stream])."""
    from gmr1_tpu_torch.channelizer import pfb

    center = 1525e6 + 31250 * CENTER_ARFCN
    chz = pfb.Channelizer(fs, center, sps=SPS)
    m = chz.n_chans
    n_block = 2500 * F * chz.analyzer.hop
    _require(n_block % m == 0 and chz.rotation == 0.0, (n_block, m))
    span = m // 2 - 12
    arfcns = [CENTER_ARFCN + o for o in range(-span, span)]
    rng = np.random.default_rng(seed)
    stories = ("e2e", "reassign") + (None,) * (NS - 2)
    streams, truths = zip(*[build_stream(rng, content_blocks * F, st)
                            for st in stories])
    out = _comb_mix(rng, streams, arfcns, fs, m, n_block, content_blocks,
                    lead_noise=True)
    return out, center, {a: a % NS for a in arfcns}, truths


def _comb_mix(rng, streams, arfcns, fs: float, m: int, n_block: int,
              blocks: int, lead_noise: bool) -> np.ndarray:
    """The NS 4-sps streams on their carriers' combs (ARFCN % NS = stream,
    a random phase each), interpolated block by block to fs, plus noise;
    `lead_noise` puts one block of noise first.  Planar (N, 2) float32."""
    combs = []
    for s in range(NS):
        spec = np.zeros(m, np.complex128)
        for a in arfcns:
            if a % NS == s:
                spec[(a - CENTER_ARFCN) % m] = np.exp(2j * np.pi * rng.random())
        combs.append((np.fft.ifft(spec) * m).astype(np.complex64))
    grid = np.arange(streams[0].shape[0], dtype=np.float64)
    ratio = (23400.0 * SPS) / fs
    lead = int(lead_noise)
    out = np.empty(((blocks + lead) * n_block, 2), np.float32)
    if lead:
        out[:n_block] = rng.standard_normal((n_block, 2)) * 0.01
    for b in range(blocks):
        pos = (np.arange(n_block, dtype=np.float64) + b * n_block) * ratio
        wb = np.zeros(n_block, np.complex64)
        for s in range(NS):
            x = (np.interp(pos, grid, streams[s].real)
                 + 1j * np.interp(pos, grid, streams[s].imag))
            wb += x.astype(np.complex64) * np.tile(combs[s], n_block // m)
        blk = out[(b + lead) * n_block:(b + lead + 1) * n_block]
        blk[:, 0] = wb.real
        blk[:, 1] = wb.imag
        blk += rng.standard_normal((n_block, 2)) * 0.01
    return out


def verify_slice(rx, seeded: dict, truths) -> dict:
    """Check every seeded carrier against its stream's truth:
      * every decoded BCCH/CCCH L2 equals the truth at its fn, and each
        carrier has >= 3 SI1 and >= 3 CCCH frames;
      * FACCH3 and FACCH9: every seeded frame decoded, bit-exact at its
        fn; a CRC pass at an fn with no seeded frame (noise, p = 2^-16
        an attempt) is counted and may happen at most 3 times in all;
      * "e2e" carriers: the first 6 speech frames, exactly two DKABs
        with the seeded sign pattern, CSD payloads 0-2 in order;
      * "reassign" carriers: payloads 0-2 of each CSD train in order,
        train b after train a;
      * traffic carriers end with TCH3 torn down; control-only carriers
        carry no TCH frame, speech or CSD.
    Returns counts."""
    from gmr1_tpu_torch.rx import gsmtap as gt

    f3t = gt.GMR1_TCH3 | gt.GMR1_FACCH
    f9t = gt.GMR1_TCH9 | gt.GMR1_FACCH
    dkt = gt.GMR1_TCH3 | gt.GMR1_DKAB
    by_type = {gt.GMR1_BCCH: "si1", gt.GMR1_CCCH: "ccch", f3t: "facch3",
               f9t: "facch9"}
    found = {c.arfcn for c in rx.carriers}
    missing = sorted(set(seeded) - found)
    _require(not missing, f"seeded ARFCNs not acquired: {missing[:20]}")
    n = dict(si1=0, ccch=0, facch3=0, facch9=0, speech=0, dkab=0, csd=0,
             tch9=0, traffic_carriers=0, unseeded_crc_pass=0)
    for car in rx.carriers:
        if car.arfcn not in seeded:
            continue
        tr = truths[seeded[car.arfcn]]
        story = tr["story"]
        got = dict(si1=0, ccch=0, facch3=0, facch9=0)
        dk = []
        for t, fn, _tn, l2 in car.frames:
            if t == dkt:
                dk.append(l2)
                continue
            if t == gt.GMR1_TCH9:
                n["tch9"] += 1
                continue
            _require(t in by_type, (car.arfcn, "unexpected type", t, fn))
            _require(story or t in (gt.GMR1_BCCH, gt.GMR1_CCCH),
                     (car.arfcn, "TCH frame on a control-only carrier", t))
            want = tr[by_type[t]].get(fn)
            if want is None and t in (f3t, f9t):
                n["unseeded_crc_pass"] += 1
                continue
            _require(want == l2, (car.arfcn, t, fn, l2.hex(), want))
            got[by_type[t]] += 1
        _require(got["si1"] >= 3 and got["ccch"] >= 3, (car.arfcn, got))
        for k in ("facch3", "facch9"):
            _require(got[k] == len(tr[k]), (car.arfcn, k, got[k], tr[k]))
            n[k] += got[k]
        n["si1"] += got["si1"]
        n["ccch"] += got["ccch"]
        if not story:
            _require(not (car.speech or car.csd or dk),
                     (car.arfcn, "traffic on a control-only carrier"))
            continue
        n["traffic_carriers"] += 1
        if story == "e2e":
            _require(car.speech[:6] == tr["speech"],
                     (car.arfcn, "speech", len(car.speech)))
            _require(len(dk) == 2, (car.arfcn, "DKABs", len(dk)))
            for d in dk:
                _require([int(b < 0) for b in np.frombuffer(d, np.int8)]
                         == DKAB_BITS, (car.arfcn, "DKAB bits", d.hex()))
            n["speech"] += 6
            n["dkab"] += 2
        last = -1
        for train in tr["csd"]:
            idx = [car.csd.index(p) for p in train[:3] if p in car.csd]
            _require(len(idx) == 3 and idx == sorted(idx) and idx[0] > last,
                     (car.arfcn, "CSD order", idx, last, len(car.csd)))
            last = idx[-1]
            n["csd"] += 3
        _require(not car.cd.tch3.active, (car.arfcn, "TCH3 still active"))
    _require(n["unseeded_crc_pass"] <= 3, n)
    strays = [c for c in rx.carriers if c.arfcn not in seeded]
    return dict(n, carriers=len(rx.carriers), seeded=len(seeded),
                strays=len(strays),
                stray_frames=sum(len(c.frames) for c in strays))


def _sync(dev) -> None:
    import torch
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def _counts() -> dict:
    """The three kernels' launch counts."""
    from gmr1_tpu_torch.channelizer.pfb import branch_filter
    from gmr1_tpu_torch.ops.a5 import keystream
    from gmr1_tpu_torch.ops.viterbi import decode_trellis
    return dict(viterbi=decode_trellis.launches, pfb=branch_filter.launches,
                a5=keystream.launches)


def _zero_counts() -> None:
    from gmr1_tpu_torch.channelizer.pfb import branch_filter
    from gmr1_tpu_torch.ops.a5 import keystream
    from gmr1_tpu_torch.ops.viterbi import decode_trellis
    decode_trellis.launches = branch_filter.launches = keystream.launches = 0


# --------------------------------------------------------------------------
# [carrier]: the per-carrier entry point
# --------------------------------------------------------------------------

CARRIER_FRAMES = 40           # 1.6 s: the e2e story and TCH3 teardown
CARRIER_LEAD = 8600           # START_DISCARD + margin (samples)


def carrier_capture(seed: int = 0xCA2):
    """One carrier at sps 4: noise lead, then build_stream's e2e story;
    returns (complex64 capture, truth)."""
    rng = np.random.default_rng(seed)
    bb, truth = build_stream(rng, CARRIER_FRAMES, "e2e")
    cap = np.zeros(CARRIER_LEAD + len(bb) + 2000, np.complex64)
    cap[CARRIER_LEAD:CARRIER_LEAD + len(bb)] = bb
    cap += ((rng.standard_normal(len(cap)) + 1j * rng.standard_normal(
        len(cap))) * 0.01).astype(np.complex64)
    return cap, truth


def pcap_frames(path: str) -> list[tuple[int, int, int, int, bytes]]:
    """(arfcn, type, fn, tn, l2) of every GSMTap packet a GsmtapSink wrote
    to its pcap (LINKTYPE_RAW IPv4/UDP records)."""
    import struct
    with open(path, "rb") as f:
        raw = f.read()
    out, o = [], 24
    while o < len(raw):
        n = struct.unpack_from("<IIII", raw, o)[2]
        pkt = raw[o + 16:o + 16 + n]
        _v, _l, _t, tn, arfcn, _s, _q, fn, sub, *_ = struct.unpack(
            "!BBBBHbbIBBBB", pkt[28:44])
        out.append((arfcn, sub, fn, tn, pkt[44:]))
        o += 16 + n
    return out


def _read(path: str) -> bytes:
    """A payload file the CLI wrote (none when there was no payload)."""
    if not os.path.exists(path):
        return b""
    with open(path, "rb") as f:
        return f.read()


def verify_carrier(frames, csd: bytes, speech: bytes, truth) -> dict:
    """Hold the per-carrier CLI's output against the e2e truth: every
    BCCH/CCCH/FACCH3/FACCH9 frame bit-exact at its fn and every seeded
    one decoded (SI1 and CCCH: all but possibly the first cycle, which
    precedes the lock), exactly the two DKABs with the seeded signs,
    every speech frame equal to the truth, one TCH9 frame per CSD payload
    and payloads 0-2 contiguous in the CSD output."""
    from gmr1_tpu_torch.rx import gsmtap as gt
    f3t = gt.GMR1_TCH3 | gt.GMR1_FACCH
    f9t = gt.GMR1_TCH9 | gt.GMR1_FACCH
    dkt = gt.GMR1_TCH3 | gt.GMR1_DKAB
    by_type = {gt.GMR1_BCCH: "si1", gt.GMR1_CCCH: "ccch", f3t: "facch3",
               f9t: "facch9"}
    got = dict(si1=0, ccch=0, facch3=0, facch9=0, dkab=0, tch9=0)
    for _arfcn, t, fn, _tn, l2 in frames:
        if t == dkt:
            _require([int(b < 0) for b in np.frombuffer(l2, np.int8)]
                     == DKAB_BITS, ("DKAB bits", fn, l2.hex()))
            got["dkab"] += 1
            continue
        if t == gt.GMR1_TCH9:
            got["tch9"] += 1
            continue
        _require(t in by_type, ("unexpected type", t, fn))
        want = truth[by_type[t]].get(fn)
        _require(want == l2, (by_type[t], fn, l2.hex(), want))
        got[by_type[t]] += 1
    _require(got["si1"] >= len(truth["si1"]) - 1
             and got["ccch"] >= len(truth["ccch"]) - 1, got)
    for k in ("facch3", "facch9"):
        _require(got[k] == len(truth[k]), (k, got[k], truth[k]))
    _require(got["dkab"] == 2, got)
    _require(speech == b"".join(truth["speech"]),
             ("speech", len(speech), len(truth["speech"])))
    pays = [csd[i:i + 60] for i in range(0, len(csd), 60)]
    _require(len(pays) == got["tch9"] and truth["csd"][0][0] in pays,
             ("CSD", len(pays), got["tch9"]))
    i = pays.index(truth["csd"][0][0])
    _require(pays[i:i + 3] == truth["csd"][0][:3], ("CSD order", i))
    return dict(got, speech=len(truth["speech"]), csd=len(pays))


def phase_carrier(tmp: str, card: str) -> tuple[dict, str]:
    """[carrier]: the per-carrier CLI on the card; returns its kernel
    launches and the path of its --speech-out file."""
    import torch

    from gmr1_tpu_torch.rx.__main__ import main as rx_main
    cap, truth = carrier_capture()
    path = os.path.join(tmp, "carrier.cfile")
    cap.tofile(path)
    out = {k: os.path.join(tmp, f"carrier.{k}")
           for k in ("pcap", "csd", "speech")}
    argv = [str(SPS), path, path, KC.tobytes().hex(), path, "--device",
            "cuda", "--no-udp", "--pcap", out["pcap"], "--csd-out",
            out["csd"], "--speech-out", out["speech"]]
    walls = []
    for run in ("cold", "warm"):     # the second run in the same process
        for f in out.values():
            if os.path.exists(f):
                os.remove(f)
        _zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc = rx_main(argv)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        launches = _counts()
        print(f"[carrier] {run} CLI wall {walls[-1]:.2f} s = "
              f"{len(cap) / walls[-1] / 1e6:.4f} Msamples/s ({card}); "
              "kernel launches: " + ", ".join(
                  f"{k} {v}" for k, v in launches.items()))
        _require(rc == 0, ("per-carrier CLI exit code", rc))
        n = verify_carrier(pcap_frames(out["pcap"]), _read(out["csd"]),
                           _read(out["speech"]), truth)
    print(f"[carrier] {len(cap)} samples ({len(cap) / (23400.0 * SPS):.2f} s"
          f" at sps {SPS}); frames: SI1 {n['si1']}, CCCH {n['ccch']}, "
          f"FACCH3 {n['facch3']}, DKAB {n['dkab']}, FACCH9 {n['facch9']}, "
          f"TCH9 {n['tch9']}, all bit-exact in both runs; speech "
          f"{n['speech']} frames exact, CSD {n['csd']} payloads (0-2 in "
          "order)")
    for name in ("viterbi", "a5"):
        _require(launches[name] > 0,
                 f"the per-carrier receiver never launched the {name} kernel")
    return launches, out["speech"]


# --------------------------------------------------------------------------
# [paths]: off-grid rate, multi-beam acquisition, wide carriers, --stream
# --------------------------------------------------------------------------

PATHS_FS = 30.72e6            # USRP B2xx rate, off the 31.25 kHz grid
PATHS_BLOCKS = 5              # content blocks, then one noise block
WIDE_SPECS = ((CENTER_ARFCN + 150, 3), (CENTER_ARFCN - 250, 5))


def _comb_period(fs: float, phasors: dict) -> np.ndarray:
    """One period of sum_o phasors[o] * exp(2j*pi*o*31250*t) at rate fs.
    With integral-Hz fs every grid offset repeats after
    P = fs/gcd(fs, 31250) samples (24576 at 30.72 MS/s), offset o on DFT
    bin o*31250/gcd mod P: one P-point IFFT, exact."""
    g = int(np.gcd(int(fs), 31250))
    period = int(fs) // g
    spec = np.zeros(period, np.complex128)
    for o, ph in phasors.items():
        spec[(o * (31250 // g)) % period] += ph
    return (np.fft.ifft(spec) * period).astype(np.complex64)


def _upsample(bb: np.ndarray, k: int) -> np.ndarray:
    """Band-limited k-fold upsampling (zero-padded FFT) of a baseband
    whose content ends before its last 2000 samples."""
    n = bb.shape[0]
    spec = np.fft.fft(bb)
    up = np.zeros(n * k, np.complex128)
    up[:n // 2] = spec[:n // 2]
    up[n * k - (n - n // 2):] = spec[n // 2:]
    return (np.fft.ifft(up) * k).astype(np.complex64)


def synthesize_paths(fs: float, content_blocks: int,
                     wide_specs=WIDE_SPECS, seed: int = 0x9A7):
    """Wideband capture at an off-grid rate: every grid channel inside
    the pre-resampler's passband live and control-only as NS comb
    streams (stream 0 with a second
    beam), a width-3 and a width-5 wide carrier (FCCH, SI1 and CCCH at
    their own symbol rate) on columns left empty for them, then one
    block of noise.  The content comes first so the 650 ms multi-beam
    scan sees two SI cycles of both beams.  Each baseband is upsampled
    8x (band-limited) before the linear interpolation to fs, which puts
    the interpolation images 33 dB or more down instead of 14 dB three
    channels away, and the noise sets a narrow carrier's SNR to 20 dB:
    no image decodes as a carrier of its own on the unseeded columns.
    Returns (planar (N, 2) float32, center, {arfcn: stream}, [truth per
    stream], [(Channel, truth) per wide carrier])."""
    from gmr1_tpu_torch.channelizer import pfb
    from gmr1_tpu_torch.channelizer.arfcn import Channel

    center = 1525e6 + 31250 * CENTER_ARFCN
    chz = pfb.Channelizer(fs, center, sps=SPS, need_nx=True)
    _require(chz.pre_resamp is not None and chz.rotation == 0.0,
             ("paths capture must be off the grid", fs))
    # live carriers stay inside the pre-resampler's passband (0.45 of
    # the input rate): one in its transition band, next to Nyquist, has
    # an image only ~10 dB down on the next outer column, which the
    # receiver rightly decodes as a carrier of its own
    span = min(chz.n_chans // 2 - 12, int(0.45 * fs / 31250))
    wides = [Channel(a, width=w) for a, w in wide_specs]
    empty = {a for ch in wides for a in range(ch.arfcns[0] - 1,
                                              ch.arfcns[-1] + 2)}
    arfcns = [CENTER_ARFCN + o for o in range(-span, span)
              if CENTER_ARFCN + o not in empty]
    rng = np.random.default_rng(seed)
    n_frames = content_blocks * F
    streams, truths = zip(*[build_stream(rng, n_frames, None, beam2=s == 0)
                            for s in range(NS)])
    wide_bb = [build_stream(rng, n_frames * ch.width) for ch in wides]
    combs = [_comb_period(fs, {a - CENTER_ARFCN: np.exp(
        2j * np.pi * rng.random()) for a in arfcns if a % NS == s})
        for s in range(NS)]
    combs += [_comb_period(fs, {ch.arfcn - CENTER_ARFCN: 1.0})
              for ch in wides]
    period = combs[0].shape[0]
    n_block = int(round(F * 0.04 * fs))     # raw samples of 8 frames
    total = (content_blocks + 1) * n_block
    out = np.empty((total, 2), np.float32)
    up = 8
    pad = np.zeros(2000, np.complex64)
    bbs = [_upsample(np.concatenate([bb, pad]), up)
           for bb in list(streams) + [bbw for bbw, _tr in wide_bb]]
    rates = [23400.0 * SPS * up] * NS \
        + [ch.symbol_rate * SPS * up for ch in wides]
    # complex noise variance for a 20 dB SNR in a 23.4 kHz carrier
    sigma = np.sqrt(fs / 23400.0 / 100.0 / 2.0)
    for b in range(content_blocks + 1):
        n0 = b * n_block
        n = min(n_block, total - n0)
        t = np.arange(n0, n0 + n, dtype=np.float64)
        ph = np.arange(n0, n0 + n, dtype=np.int64) % period
        wb = np.zeros(n, np.complex64)
        for bb, rate, comb in zip(bbs, rates, combs):
            grid = np.arange(bb.shape[0], dtype=np.float64)
            pos = t * rate / fs
            x = np.interp(pos, grid, bb.real, right=0.0) \
                + 1j * np.interp(pos, grid, bb.imag, right=0.0)
            wb += x.astype(np.complex64) * comb[ph]
        blk = out[n0:n0 + n]
        blk[:, 0] = wb.real
        blk[:, 1] = wb.imag
        blk += rng.standard_normal((n, 2)) * sigma
    return (out, center, {a: a % NS for a in arfcns}, truths,
            [(ch, tr) for ch, (_bb, tr) in zip(wides, wide_bb)])


def verify_paths(frames, seeded: dict, truths, wides) -> dict:
    """Hold the wideband CLI's frames against the truth: every frame of a
    seeded ARFCN or wide carrier bit-exact at its fn (BCCH and CCCH
    only); each narrow carrier >= 3 SI1s; on stream 0 both beams decode
    >= 3 SI1s of their own (fn%8 == 2 and fn%8 == 5); each wide carrier
    >= 2 SI1s; no frame of any other ARFCN (strays emit nothing)."""
    from gmr1_tpu_torch.rx import gsmtap as gt
    by_type = {gt.GMR1_BCCH: "si1", gt.GMR1_CCCH: "ccch"}
    wide_truth = {ch.arfcn: tr for ch, tr in wides}
    si1, bad = {}, []
    for arfcn, t, fn, _tn, l2 in frames:
        tr = wide_truth.get(arfcn)
        if tr is None and arfcn in seeded:
            tr = truths[seeded[arfcn]]
        if tr is None or t not in by_type \
                or tr[by_type[t]].get(fn) != l2:
            bad.append((arfcn, t, fn, "seeded" if tr else "unseeded"))
        elif t == gt.GMR1_BCCH:
            si1.setdefault(arfcn, set()).add(fn)
    _require(not bad, (f"{len(bad)} frames off the truth", bad[:10]))
    n = dict(narrow=0, beam_b=0, wide=0, frames=len(frames))
    for arfcn, stream in seeded.items():
        fns = si1.get(arfcn, set())
        a = {fn for fn in fns if fn % 8 == 2}
        _require(len(a) >= 3, (arfcn, "SI1s", sorted(fns)))
        n["narrow"] += 1
        if stream == 0:
            _require(len(fns - a) >= 3, (arfcn, "beam B SI1s", sorted(fns)))
            n["beam_b"] += 1
    for arfcn in wide_truth:
        _require(len(si1.get(arfcn, ())) >= 2, (arfcn, "wide SI1s"))
        n["wide"] += 1
    return n


def phase_paths(tmp: str, card: str) -> dict:
    """[paths]: the wideband CLI over the off-grid, multi-beam, wide
    capture on the card; returns its kernel launches."""
    import torch

    from gmr1_tpu_torch.rx.__main__ import main as rx_main
    t0 = time.perf_counter()
    wb, center, seeded, truths, wides = synthesize_paths(PATHS_FS,
                                                         PATHS_BLOCKS)
    path = os.path.join(tmp, "paths.cfile")
    wb.tofile(path)
    n_samp = wb.shape[0]
    del wb
    print(f"[paths] synthesized {n_samp / 1e6:.1f} Msamples "
          f"({n_samp / PATHS_FS:.2f} s at {PATHS_FS / 1e6:.2f} MS/s, "
          f"{len(seeded)} live carriers, wide "
          f"{', '.join(str(ch) for ch, _ in wides)}) in "
          f"{time.perf_counter() - t0:.1f} s")
    pcap = os.path.join(tmp, "paths.pcap")
    argv = ["--wideband", path, "--fs", str(PATHS_FS), "--center",
            str(center), "--beams", "2", "--stream", "--device", "cuda",
            "--no-udp", "--pcap", pcap]
    for ch, _ in wides:
        argv += ["--wide", str(ch)]
    _zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rc = rx_main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _counts()
    print(f"[paths] CLI wall {wall:.2f} s = {n_samp / wall / 1e6:.2f} "
          f"Msamples/s vs real time {PATHS_FS / 1e6:.2f} ({card}); kernel "
          "launches: " + ", ".join(f"{k} {v}" for k, v in launches.items()))
    _require(rc == 0, ("wideband CLI exit code", rc))
    n = verify_paths(pcap_frames(pcap), seeded, truths, wides)
    print(f"[paths] {n['frames']} frames, all bit-exact; {n['narrow']} "
          f"narrow carriers with >= 3 SI1s, {n['beam_b']} with both beams, "
          f"{n['wide']} wide carriers; no frame off the seeded ARFCNs")
    # every carrier is control-only: the block phases run no traffic
    # half, so kernel A5 never launches
    for name, v in launches.items():
        _require((v == 0) if name == "a5" else (v > 0),
                 (f"the wideband paths launched the {name} kernel", v))
    return launches


# --------------------------------------------------------------------------
# [l1]: the last L1 coders (xch_dc12 on kernel V's K=9 form, rach) and
# TCH9 2k4/4k8, one burst a grid carrier, on the card against the CPU
# --------------------------------------------------------------------------

def _noisy(bits: np.ndarray, rng, sigma: float) -> np.ndarray:
    """Integer soft bits (positive = bit 0) of hard bits plus noise."""
    s = np.where(bits > 0, -100.0, 100.0) + rng.normal(0, sigma, bits.shape)
    return np.clip(np.round(s), -127, 127).astype(np.float32)


def phase_l1(rng, dev, n_car: int) -> dict:
    """[l1]: n_car DC12 and n_car RACH bursts (random L2, random SB
    masks, every 7th RACH decoded with a wrong mask) encoded on the card,
    noised on the host and decoded on the card; then F=5 chained TCH9
    2k4 and 4k8 bursts a carrier through the inter-burst interleaver.
    Bursts, bits, CRC flags, metrics and rings must equal the port's CPU
    decode; payloads must come back.  Returns the kernel launches of the
    card's run."""
    import torch

    from gmr1_tpu_torch.l1 import rach, tch9, xch_dc12
    from gmr1_tpu_torch.ops import interleave as IL
    from gmr1_tpu_torch.ops import scramble as SC
    from gmr1_tpu_torch.ops import viterbi as VT

    def same(what, card, cpu):
        for k, (g, w) in enumerate(zip(card, cpu)):
            _require(torch.equal(g.cpu(), w), (what, "output", k))

    l2 = rng.integers(0, 256, (n_car, 24), dtype=np.uint8)
    pk = rng.integers(0, 256, (n_car, 18), dtype=np.uint8)
    pk[:, 17] &= 0xE0                                   # 139 message bits
    sb = rng.integers(1, 256, n_car).astype(np.uint8)
    masks = sb.copy()
    masks[::7] ^= 0x5A                                  # wrong SB masks
    modes = (tch9.MODE_2K4, tch9.MODE_4K8)
    pays = {m.name: rng.integers(0, 256, (5, n_car, m.l2_bytes),
                                 dtype=np.uint8) for m in modes}

    def tch9_bursts(mode, device):
        il = IL.InterleaverState(
            buf=torch.zeros((n_car, 3, 648), dtype=torch.uint8,
                            device=device),
            n=torch.zeros(n_car, dtype=torch.int64, device=device))
        out = []
        for f in range(5):
            il, e = tch9.encode(torch.as_tensor(pays[mode.name][f],
                                                device=device), mode,
                                np.zeros((n_car, 10), np.uint8),
                                np.zeros((n_car, 4), np.uint8), il)
            out.append(e)
        return torch.stack(out)

    def dec_ring(device):
        return IL.InterleaverState(
            buf=torch.zeros((n_car, 3, 648), dtype=torch.float32,
                            device=device),
            n=torch.zeros(n_car, dtype=torch.int64, device=device))

    # encode on the card, against the CPU
    e_dc = xch_dc12.encode(torch.as_tensor(l2, device=dev))
    e_ra = rach.encode(torch.as_tensor(pk, device=dev),
                       torch.as_tensor(sb, device=dev))
    e_t9 = {m.name: tch9_bursts(m, dev) for m in modes}
    _require(torch.equal(e_dc.cpu(), xch_dc12.encode(torch.as_tensor(l2))),
             "xch_dc12 encode")
    _require(torch.equal(e_ra.cpu(), rach.encode(torch.as_tensor(pk),
                                                 torch.as_tensor(sb))),
             "rach encode")
    for m in modes:
        _require(torch.equal(e_t9[m.name].cpu(), tch9_bursts(m, "cpu")),
                 ("tch9 encode", m.name))
    s_dc = _noisy(e_dc.cpu().numpy(), rng, 60.0)
    s_ra = _noisy(e_ra.cpu().numpy(), rng, 60.0)
    s_t9 = {k: _noisy(v.cpu().numpy(), rng, 60.0) for k, v in e_t9.items()}

    def run(device):
        out = dict(dc12=xch_dc12.decode(torch.as_tensor(s_dc, device=device)),
                   rach=rach.decode(torch.as_tensor(s_ra, device=device),
                                    torch.as_tensor(masks, device=device)))
        for m in modes:
            il, *rest = tch9.decode_frames(
                torch.as_tensor(s_t9[m.name], device=device), m,
                dec_ring(device))
            out[m.name] = (il.buf, il.n, *rest)
        return out

    _zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = run(dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _counts()
    cpu = run("cpu")
    for k in card:
        same(k, card[k], cpu[k])
    l2_d, bad_d, _ = cpu["dc12"]
    ok_dc = ~bad_d.bool()
    _require(torch.equal(l2_d[ok_dc], torch.as_tensor(l2)[ok_dc])
             and int(ok_dc.sum()) > 0.9 * n_car, ("DC12 payloads",
                                                  int(ok_dc.sum())))
    pk_r, bad_r, _ = cpu["rach"]
    wrong = torch.as_tensor(masks != sb)
    ok_r = (bad_r == 0).all(dim=-1) & ~wrong
    _require(torch.equal(pk_r[ok_r], torch.as_tensor(pk)[ok_r])
             and int(ok_r.sum()) > 0.8 * n_car
             and bool(bad_r[wrong, 0].all()), ("RACH", int(ok_r.sum())))
    t9_ok = {}
    for m in modes:
        got = cpu[m.name][2]                 # l2 (F, C, bytes): frame f-2
        hit = (got[2:] == torch.as_tensor(pays[m.name][:3])).all(dim=-1)
        t9_ok[m.name] = int(hit.sum())
        _require(t9_ok[m.name] > 0.9 * 3 * n_car, (m.name, t9_ok[m.name]))
    print(f"[l1] {n_car} DC12 + {n_car} RACH bursts + 5 x {n_car} TCH9 "
          f"2k4 and 4k8 bursts decoded on the card in {wall * 1e3:.1f} ms "
          f"({VT.decode_trellis.launches} kernel V launches); bursts, bits, "
          f"CRC flags, metrics and rings equal the CPU's; DC12 CRC pass "
          f"{int(ok_dc.sum())}, RACH pass {int(ok_r.sum())} (wrong SB mask "
          f"on {int(wrong.sum())}, all refused), TCH9 payloads back 2 "
          f"bursts later: " + ", ".join(f"{k} {v}/{3 * n_car}"
                                        for k, v in t9_ok.items()))
    _require(launches["viterbi"] > 0, "[l1] never launched kernel V")
    # kernel V at the K=9 tail-biting shape of this decode
    code = xch_dc12.CODE
    ep = SC.scramble_sbit(torch.as_tensor(s_dc, device=dev))
    sym = VT.depuncture(IL.deinterleave_intra(ep, xch_dc12.IL_N),
                        xch_dc12._keep_idx(),
                        code.out_len(xch_dc12.CONV_LEN)).reshape(
        n_car, xch_dc12.CONV_LEN, code.n)
    sign = torch.as_tensor(VT._acs_tables(code)[2].reshape(-1, code.n),
                           device=dev)
    ms = _cuda_ms(lambda: VT.decode_trellis(sym, sign, False), 20)
    dev_ms = _graph_ms(lambda: VT.decode_trellis(sym, sign, False))
    plain_ms = _cuda_ms(lambda: VT.decode_trellis_plain(sym, sign, False), 1)
    print(f"[l1] kernel V at the DC12 shape {code.name} B={n_car} "
          f"T={xch_dc12.CONV_LEN} n={code.n} S={code.num_states}:")
    _trellis_line("[l1]  ", code, n_car, xch_dc12.CONV_LEN, ms, dev_ms,
                  plain_ms)
    return launches


# --------------------------------------------------------------------------
# [codec]: the AMBE vocoder
# --------------------------------------------------------------------------

CODEC_CHANNELS, CODEC_FRAMES = 4096, 50      # bench_codec.py's shape, seed 11


def _speech_frames(rng, n: int, pitch: int = 96) -> np.ndarray:
    """tests/test_codec.py's speech vectors: constant pitch (L=39),
    pitch-interpolation rule 0, the rest random."""
    fr = rng.integers(0, 256, size=(n, 10), dtype=np.uint8)
    fr[:, 0] = (pitch << 1) | (fr[:, 0] & 1)
    fr[:, 6] &= ~0xC0 & 0xFF
    return fr


def _tone_frame(rng, code: int, sel: int = 3, ampl: int = 200) -> np.ndarray:
    """tests/test_codec.py's tone frame."""
    fr = rng.integers(0, 256, size=10, dtype=np.uint8)
    fr[0] = 0xFC | sel
    fr[1] = ampl
    fr[2:8] = code
    return fr


def phase_codec(tmp: str, card: str, speech_path: str, dev,
                c_cnt: int = CODEC_CHANNELS, t_cnt: int = CODEC_FRAMES
                ) -> None:
    """[codec]: decode_frames at bench_codec.py's shape on the card
    (frames/s, real-time voice channels); 8 of those channels and
    tests/test_codec.py's constant-pitch, silence-mix, tone and batched
    vectors on the card against the port on the CPU (within 1 LSB on >=
    99.9 % of samples); `python -m gmr1_tpu_torch.codec` turning the
    [carrier] phase's --speech-out file into a WAV on the card."""
    import torch

    from gmr1_tpu_torch import codec
    from gmr1_tpu_torch.codec.__main__ import main as codec_main
    from gmr1_tpu_torch.codec.__main__ import wav_header
    frames = np.random.default_rng(11).integers(0, 256, (c_cnt, t_cnt, 10),
                                                dtype=np.uint8)
    fr = torch.as_tensor(frames, device=dev)
    st = codec.init((c_cnt,), device=dev)
    codec.decode_frames(st, fr[:, :2])               # first-call set-up
    torch.cuda.synchronize()
    walls = []
    for _ in range(2):
        t0 = time.perf_counter()
        _, pcm = codec.decode_frames(st, fr)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    _require(pcm.shape == (c_cnt, t_cnt, 160) and pcm.dtype == torch.int16
             and bool(pcm.ne(0).any()), ("codec output", tuple(pcm.shape)))
    fps = [c_cnt * t_cnt / w for w in walls]
    print(f"[codec] decode_frames {c_cnt} channels x {t_cnt} frames on the "
          f"card: {', '.join(f'{w * 1e3:.1f}' for w in walls)} ms = "
          f"{', '.join(f'{f:.0f}' for f in fps)} frames/s = "
          f"{', '.join(f'{f / 50:.0f}' for f in fps)} real-time voice "
          f"channels ({card})")
    n_dev = 0
    if dev.type == "cuda":                    # the CPU rehearsal skips it
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            codec.decode_frames(st, fr[:, :2])
            torch.cuda.synchronize()
        n_dev = sum(e.count for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA)
    print(f"[codec] eager device operations a frame (profiler, kernels and "
          f"copies): {n_dev / 2:.0f}" if n_dev else
          "[codec] eager launches a frame: not measured (the profiler "
          "recorded no device events)")

    rng = np.random.default_rng(0x6D31)
    silence = _speech_frames(rng, 12)
    silence[3, 0], silence[7, 0] = 0xF8, 0xFA
    vectors = [("bench channels 0-7", frames[:8], (8,)),
               ("speech, pitch 96", _speech_frames(rng, 25), ()),
               ("silence mix", silence, ()),
               ("batched, pitch 96/110",
                np.stack([_speech_frames(rng, 8),
                          _speech_frames(rng, 8, pitch=110)]), (2,))]
    vectors += [(f"tone 0x{c:02X}",
                 np.stack([_tone_frame(rng, c, sel) for sel in (3, 2, 1)]),
                 ()) for c in (0x20, 0x85, 0x91, 0xA1, 0xFF)]
    n_all = n_close = 0
    for name, f, batch in vectors:
        _, g = codec.decode_frames(codec.init(batch, device=dev),
                                   torch.as_tensor(f, device=dev))
        _, c = codec.decode_frames(codec.init(batch, device="cpu"),
                                   torch.as_tensor(f))
        d = (g.cpu().to(torch.int64) - c.to(torch.int64)).abs()
        n_all += d.numel()
        n_close += int((d <= 1).sum())
        print(f"[codec] {name}: card vs CPU max |diff| {int(d.max())} LSB, "
              f"{float((d > 1).float().mean()):.5f} of samples > 1 LSB")
        if name.startswith("bench"):              # batch size 4096 vs 8
            d = (pcm[:8].cpu().to(torch.int64) - c.to(torch.int64)).abs()
            n_all += d.numel()
            n_close += int((d <= 1).sum())
            print(f"[codec]   the same channels inside the {c_cnt}-channel "
                  f"batch vs CPU: max |diff| {int(d.max())} LSB")
    print(f"[codec] card vs CPU: {n_close / n_all:.5f} of {n_all} samples "
          "within 1 LSB (limit 0.999)")
    _require(n_close >= 0.999 * n_all, ("codec card vs CPU", n_close, n_all))

    with open(speech_path, "rb") as fh:
        raw = fh.read()
    n_fr = len(raw) // 10
    out = os.path.join(tmp, "speech.wav")
    rc = codec_main([speech_path, out, "--device", str(dev)])
    with open(out, "rb") as fh:
        wav = fh.read()
    _require(rc == 0 and n_fr > 0 and wav[:44] == wav_header(160 * n_fr)
             and len(wav) == 44 + 320 * n_fr, ("codec CLI", rc, n_fr,
                                                len(wav)))
    _, ref = codec.decode_frames(codec.init((), device="cpu"), torch.as_tensor(
        np.frombuffer(raw[:10 * n_fr], np.uint8).reshape(n_fr, 10).copy()))
    d = np.abs(np.frombuffer(wav[44:], "<i2").astype(np.int64)
               - ref.numpy().reshape(-1).astype(np.int64))
    _require(np.mean(d <= 1) >= 0.999, ("codec CLI PCM", int(d.max())))
    print(f"[codec] python -m gmr1_tpu_torch.codec {os.path.basename(speech_path)}"
          f" speech.wav --device {dev}: {n_fr} frames -> {160 * n_fr} "
          f"samples, WAV header correct, max |diff| vs CPU {int(d.max())} "
          "LSB")


def _cuda_ms(fn, iters: int) -> float:
    """Eager time: CUDA events around `iters` calls back to back (the
    host's launch cost shows where it exceeds the device time)."""
    import torch
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def _graph_ms(fn, iters: int = 20, reps: int = 5) -> float:
    """Device time: `iters` calls captured in one CUDA graph, replayed
    `reps` times (no host launch cost between the kernels)."""
    import torch
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(iters):
            fn()
    g.replay()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        g.replay()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters / reps


# H100 SXM peaks (NVIDIA's datasheet): HBM3 rate, f32 outside the
# tensor cores, and the boost clock used for serial-chain estimates
HBM_BPS = 3.35e12
F32_FLOPS = 67e12
BF16_FLOPS = 989e12           # dense, in the tensor cores
BOOST_HZ = 1.98e9


def _bound(nbytes: float, nops: float,
           flops: float = F32_FLOPS) -> tuple[float, str]:
    """(least ms, what sets it): the larger of the bytes over the memory
    rate and the operations over the peak rate of their type (f32 by
    default)."""
    tb, to = nbytes / HBM_BPS * 1e3, nops / flops * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def _roofline(ms: float, nbytes: float, nops: float,
              flops: float = F32_FLOPS) -> tuple[float, str, str]:
    """(bound ms, what sets it, printable bound and roofline share)."""
    bound, by = _bound(nbytes, nops, flops)
    return bound, by, (f"bound {bound:.5f} ms ({by}: {nbytes / 1e6:.2f} MB,"
                       f" {nops / 1e9:.3f} Gop), roofline share "
                       f"{bound / ms:.3f}")


def _trellis_case(code, t_steps: int, b: int, rng, dev, zero=False):
    import torch

    from gmr1_tpu_torch.ops import conv as CV
    from gmr1_tpu_torch.ops import viterbi as VT
    _, _, sign = VT._acs_tables(code)
    in_len = t_steps - (code.k - 1 if code.term == CV.TERM_FLUSH else 0)
    bits = rng.integers(0, 2, (b, in_len), dtype=np.uint8)
    enc = CV.encode(code, torch.from_numpy(bits)).numpy()
    soft = np.where(enc > 0, -127.0, 127.0) + rng.normal(0, 40.0, enc.shape)
    soft = np.clip(np.round(soft), -127, 127).astype(np.float32)
    if zero:                  # every metric ties
        soft[:] = 0.0
    return (torch.as_tensor(soft.reshape(b, t_steps, code.n), device=dev),
            torch.as_tensor(sign.reshape(-1, code.n), device=dev),
            code.term == CV.TERM_FLUSH)


def _trellis_line(tag: str, code, b: int, t_steps: int, ms: float,
                  dev_ms: float, plain_ms: float) -> tuple[float, str]:
    """Print kernel V's eager and device time at one shape beside its
    bound and serial-chain estimate; returns (bound ms, what sets it)."""
    s_cnt, n = code.num_states, code.n
    # bytes: sym in, bits and metric out; operations: two adds and a
    # compare a state a step, and the 2^n distinct branch metrics
    nbytes = b * t_steps * (4 * n + 1) + 4 * b + 8 * s_cnt * n
    nops = b * t_steps * (3 * s_cnt + 2 * n * 2 ** n)
    # one step forward (add, max) and one back (shift, or): 16 clocks
    chain = t_steps * 16 / BOOST_HZ * 1e3
    bound, by, line = _roofline(dev_ms, nbytes, nops)
    print(f"{tag} kernel {ms:.4f} ms eager, {dev_ms:.4f} ms device "
          f"(CUDA graph), plain {plain_ms:.3f} ms (no yardstick); "
          f"{line} (device time); serial chain >= {chain:.5f} ms "
          f"(T x 16 clocks at {BOOST_HZ / 1e9:.2f} GHz); the "
          f"{'chain' if chain > bound else by} bound applies: share "
          f"{max(chain, bound) / dev_ms:.3f}")
    return bound, by


def _k9_codes() -> dict:
    """The 256- and 128-state trellises [V] and [ab] run: DC12's
    K9_13 tail-biting code, K9_13 flush, a synthetic K=8 tail-biting code
    (S=128; no GMR-1 code has 128 states) and a K=9 table whose butterflies
    are not antipodal (two generators miss an end tap)."""
    from gmr1_tpu_torch.ops import conv as CV
    return dict(
        k9_tb=CV.ConvCode("k9_13_tb", 9, CV.K9_13.polys,
                          term=CV.TERM_TAIL_BITING),
        k9_flush=CV.K9_13,
        k8_tb=CV.ConvCode("k8_13_tb", 8, (0b10101011, 0b11001101,
                                          0b10110111),
                          term=CV.TERM_TAIL_BITING),
        k9_nx=CV.ConvCode("k9_nx_tb", 9, (0b100101110, 0b110011011,
                                          0b010100111),
                          term=CV.TERM_TAIL_BITING))


def phase_viterbi(rng, dev, n_car: int):
    """Kernel V vs plain on the card, at B=2048, at the receiver's
    batches for n_car carriers, at B=1, on all-zero (tied) bursts, odd
    batches and T off multiples of 32; returns (max |err|, ms, plain ms,
    bound ms, what sets it) at the CCCH batch."""
    import torch

    from gmr1_tpu_torch.ops import conv as CV
    from gmr1_tpu_torch.ops import viterbi as VT
    k5_tb = CV.ConvCode("k5_12_tb", 5, CV.K5_12.polys,
                        term=CV.TERM_TAIL_BITING)
    cases = [(CV.K5_12, 212, 2048, ""), (CV.K5_14, 100, 2048, ""),
             (CV.TCH3_K7, 104, 2048, ""),
             (CV.ConvCode("k9_13_tb", 9, CV.K9_13.polys,
                          term=CV.TERM_TAIL_BITING), 208, 2048, ""),
             (CV.K5_12, 212, 6 * n_car, "CCCH"),
             # the traffic path, C carriers x F frames
             (CV.TCH3_K7, 48, 2 * n_car * F, "TCH3 speech"),
             (CV.K5_12, 320, n_car * F, "FACCH9"),
             (CV.K5_12, 484, n_car * F, "TCH9 9k6"),
             (CV.K5_14, 96, n_car, "FACCH3 jobs x 2 ciphers"),
             # TCH9 2k4 (n = 5) and 4k8, 5 chained bursts a carrier ([l1])
             (CV.K5_15, 148, 5 * n_car, "TCH9 2k4"),
             (CV.K5_13, 244, 5 * n_car, "TCH9 4k8"),
             # the per-carrier receiver: one burst a decode
             (CV.K5_12, 212, 1, "per-carrier BCCH/CCCH"),
             (CV.K5_14, 96, 1, "per-carrier FACCH3"),
             (CV.K5_12, 320, 1, "per-carrier FACCH9"),
             (CV.K5_12, 484, 1, "per-carrier TCH9 9k6"),
             (CV.TCH3_K7, 48, 2, "per-carrier speech, 2 frames"),
             # every tail-biting final metric tied: the first-max rule
             (k5_tb, 212, 2048, "all-zero sym"),
             (CV.TCH3_K7, 48, 2048, "all-zero sym"),
             # batches off a multiple of the bursts a warp (4 at K=5)
             (CV.K5_12, 212, 3, "odd B"), (CV.K5_12, 212, 33, "odd B"),
             (CV.TCH3_K7, 48, 1, "odd B"), (CV.TCH3_K7, 48, 3, "odd B"),
             (CV.TCH3_K7, 48, 33, "odd B"),
             # T off a multiple of the 32-step symbol chunks
             (CV.K5_14, 37, 33, "T % 32 != 0"),
             (k5_tb, 45, 3, "T % 32 != 0"),
             (CV.TCH3_K7, 70, 5, "T % 32 != 0")]
    k9 = _k9_codes()
    cases += [  # the 256- and 128-state form
        (k9["k9_tb"], 208, n_car, "DC12"),
        (k9["k9_tb"], 208, 1, "DC12, one burst"),
        (k9["k9_tb"], 208, 2048, "all-zero sym"),
        (k9["k9_tb"], 208, 3, "odd B"), (k9["k9_tb"], 208, 33, "odd B"),
        (k9["k9_tb"], 45, 33, "T % 32 != 0"),
        (k9["k9_flush"], 208, n_car, "flush"),
        (k9["k9_nx"], 208, 33, "not antipodal"),
        (k9["k8_tb"], 208, 33, "synthetic K=8"),
        (k9["k8_tb"], 45, 3, "synthetic K=8, T % 32 != 0")]
    err, out = 0.0, None
    for code, t_steps, b, what in cases:
        sym, sign, flush = _trellis_case(code, t_steps, b, rng, dev,
                                         zero="all-zero" in what)
        kb, km = VT.decode_trellis(sym, sign, flush)
        pb, pm = VT.decode_trellis_plain(sym, sign, flush)
        torch.cuda.synchronize()
        nbad = int((kb != pb).sum())
        merr = float((km - pm).abs().max())
        print(f"[V] {code.name} B={b} T={t_steps} n={code.n} "
              f"S={code.num_states}{' (' + what + ')' if what else ''}: "
              f"bit mismatches {nbad}, metric max|err| {merr}")
        _require(nbad == 0 and merr == 0.0, (code.name, b, t_steps, what))
        err = max(err, merr)
        ms = _cuda_ms(lambda: VT.decode_trellis(sym, sign, flush), 20)
        dev_ms = _graph_ms(lambda: VT.decode_trellis(sym, sign, flush))
        plain_ms = _cuda_ms(lambda: VT.decode_trellis_plain(sym, sign, flush),
                            3)
        bound, by = _trellis_line("[V]  ", code, b, t_steps, ms, dev_ms,
                                  plain_ms)
        if what == "CCCH":
            out = (ms, plain_ms, bound, by)
    return (err, *out)


def _a5_line(what: str, b: int, nbits: int, with_ul: bool, eager: float,
             dev_ms: float) -> tuple[float, str]:
    """Print one A5 timing line: eager and device time beside the byte
    bound (frame numbers in, a byte a bit out) and the serial-chain
    estimate (250 mixing + nbits, or 2 * nbits, dependent clocks after
    the 64 key clocks, each about 16 cycles); returns the byte bound and
    what sets it."""
    clocks = 314 + nbits * (2 if with_ul else 1)
    nbytes = b * (8 + nbits * (2 if with_ul else 1))
    bound, by, line = _roofline(dev_ms, nbytes, 0)
    chain = clocks * 16 / BOOST_HZ * 1e3
    applies = "chain" if chain > bound else by
    print(f"[A5]   {what} B={b} nbits={nbits} ({'dl + ul' if with_ul else 'dl'}"
          f"): kernel {eager:.4f} ms eager, {dev_ms:.5f} ms device (CUDA "
          f"graph); {line} (device time); serial chain >= {chain:.5f} ms "
          f"({clocks} clocks x 16 at {BOOST_HZ / 1e9:.2f} GHz); the "
          f"{applies} bound applies: share {max(chain, bound) / dev_ms:.3f}")
    return bound, by


def phase_a5(rng, dev, batch: int):
    """Kernel A5 vs its plain version at the receiver's NT9 batch, at
    batches off a warp (33) and off a CTA (batch + 1), with a random key
    and a key of eight distinct bytes, and vs keystream_np for a handful
    of frame numbers (bits 16-18 set among them); timed eager and by
    CUDA-graph replay at the receiver's shape (dl only), with the uplink
    and at batch 1 (the per-carrier receiver's 96, 208 and 658 bits).
    Returns (mismatched bits, dl-only eager ms, plain ms, bound ms, what
    sets it)."""
    import torch

    from gmr1_tpu_torch.ops import a5
    nbad = 0
    keys = (rng.integers(0, 256, 8, dtype=np.uint8),
            (np.arange(8) * 37 + 5).astype(np.uint8))    # bytes distinct
    for key in keys:
        for b in (batch, 33, batch + 1):
            fns = rng.integers(0, 1 << 19, b)
            fns[:4] = [0, 0x70000, 0x7FFFF, 0x5A5A5]    # bits 16-18 set
            fns = torch.as_tensor(fns, device=dev)
            kd, ku = a5.keystream(key, fns, 658)
            pd, pu = a5.keystream_plain(key, fns, 658)
            torch.cuda.synchronize()
            bad = int((kd != pd).sum()) + int((ku != pu).sum())
            host = fns.cpu().numpy()
            kd_h, ku_h = kd.cpu().numpy(), ku.cpu().numpy()
            for i in sorted({0, 1, 2, 3, b // 2, b - 1}):
                rd, ru = a5.keystream_np(key, int(host[i]), 658)
                bad += int((kd_h[i] != rd).sum()) + int((ku_h[i] != ru).sum())
            print(f"[A5] key {key.tobytes().hex()} B={b} nbits=658 (dl + "
                  f"ul): bit mismatches vs plain and vs keystream_np at "
                  f"{len({0, 1, 2, 3, b // 2, b - 1})} fns: {bad}")
            nbad += bad
    _require(nbad == 0, "A5 keystream")
    key = keys[0]
    fns = torch.as_tensor(rng.integers(0, 1 << 19, batch), device=dev)
    ms = _cuda_ms(lambda: a5.keystream(key, fns, 658, with_ul=False), 20)
    plain_ms = _cuda_ms(lambda: a5.keystream_plain(key, fns, 658,
                                                   with_ul=False), 1)
    print(f"[A5]   plain (dl) at B={batch}: {plain_ms:.3f} ms (no "
          "yardstick: no PyTorch call computes A5/1)")
    bound, by = _a5_line("receiver NT9 batch", batch, 658, False, ms,
                         _graph_ms(lambda: a5.keystream(key, fns, 658,
                                                        with_ul=False)))
    _a5_line("with the uplink", batch, 658, True,
             _cuda_ms(lambda: a5.keystream(key, fns, 658), 20),
             _graph_ms(lambda: a5.keystream(key, fns, 658)))
    # the per-carrier receiver: one frame number a call, dl only
    for nbits in (96, 208, 658):
        fn1 = torch.as_tensor([0x5A5A5], device=dev)
        kd, _ = a5.keystream(key, fn1, nbits, with_ul=False)
        pd, _ = a5.keystream_plain(key, fn1, nbits, with_ul=False)
        rd, _ = a5.keystream_np(key, 0x5A5A5, nbits)
        bad1 = int((kd != pd).sum()) + int((kd[0].cpu().numpy() != rd).sum())
        print(f"[A5] B=1 nbits={nbits} (dl): bit mismatches vs plain and "
              f"keystream_np {bad1}")
        _require(bad1 == 0, ("A5 keystream at batch 1", nbits))
        _a5_line("per-carrier", 1, nbits, False,
                 _cuda_ms(lambda: a5.keystream(key, fn1, nbits,
                                               with_ul=False), 20),
                 _graph_ms(lambda: a5.keystream(key, fn1, nbits,
                                                with_ul=False)))
    return float(nbad), ms, plain_ms, bound, by


def phase_pfb(rng, dev, fs: float = FS, need_nx: bool = False,
              r_cnt: int = 2500 * F):
    """Kernel P vs plain at the geometry of rate fs (the receiver's own
    prototype filter; need_nx: the perfect-reconstruction prototype that
    wide carriers switch on) and r_cnt rows (a block's, or a mesh
    shard's), seeded input; returns (max |err| of the bank and of a2,
    branch-filter ms, plain ms, bound ms, what sets it, F.conv1d ms)."""
    import torch

    from gmr1_tpu_torch.channelizer import pfb
    ana = pfb.Channelizer(fs, 1525e6 + 31250 * CENTER_ARFCN,
                          need_nx=need_nx).analyzer
    m, p, hop = ana.m, ana.p, ana.hop
    if fs == FS:
        _require((m, p) == (1088, 10), (m, p))
    x = torch.as_tensor(rng.normal(size=(r_cnt * hop + p * m, 2))
                        .astype(np.float32), device=dev)
    wa, dft, dft16, qpar = ana._tables(x.device)
    ana.dft_bf16 = False
    got = ana.block(x)                            # kernel path, f32 DFT
    c2 = pfb.branch_filter_plain(x, wa, r_cnt, hop) @ dft
    rpar = (torch.arange(r_cnt, device=dev) & 1).to(torch.float32)
    c2 = c2 * (1.0 - 2.0 * rpar[:, None] * qpar[None, :])
    ref = torch.stack([c2[:, :m], c2[:, m:]], dim=-1)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    ok = bool(torch.all((got - ref).abs() <= 1e-4 + 2e-4 * ref.abs()))
    print(f"[P] M={m} P={p} R={r_cnt}: bank max|err| {err} "
          f"(peak {float(ref.abs().max()):.1f}), within rtol 2e-4/atol 1e-4: "
          f"{ok}")
    _require(ok, "PFB bank outside rtol 2e-4 / atol 1e-4")
    ref = pfb.branch_filter_plain(x, wa, r_cnt, hop)
    a2 = pfb.branch_filter(x, wa, r_cnt, hop)
    a2_err = float((a2 - ref).abs().max())
    print(f"[P]   branch filter output a2 ({r_cnt}, {4 * hop}) max|err| vs "
          f"plain {a2_err}")
    _require(bool(torch.all((a2 - ref).abs() <= 1e-4 + 2e-4 * ref.abs())),
             "PFB branch filter outside rtol 2e-4 / atol 1e-4")
    ms = _cuda_ms(lambda: pfb.branch_filter(x, wa, r_cnt, hop), 20)
    dev_ms = _graph_ms(lambda: pfb.branch_filter(x, wa, r_cnt, hop))
    plain_ms = _cuda_ms(lambda: pfb.branch_filter_plain(x, wa, r_cnt, hop), 5)
    block_ms = _cuda_ms(lambda: ana.block(x), 5)
    # the one-call yardstick, never on the port's path: a grouped conv1d
    # over inputs already in its layout, zt[c, b, j] = z_c[j, b] and
    # w[2b + a, 0, u] = wa[a(2P+1) + u, b]; full f32 (no TF32)
    taps = 2 * p + 1
    zt = x[:(r_cnt + 2 * p) * hop].view(r_cnt + 2 * p, hop, 2) \
        .permute(2, 1, 0).contiguous()
    w = wa.view(2, taps, hop).permute(2, 0, 1).reshape(2 * hop, 1, taps) \
        .contiguous()
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        conv = torch.nn.functional.conv1d(zt, w, groups=hop)
        conv_ms = _cuda_ms(
            lambda: torch.nn.functional.conv1d(zt, w, groups=hop), 20)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    conv = conv.view(2, hop, 2, r_cnt).permute(3, 0, 2, 1) \
        .reshape(r_cnt, 4 * hop)
    cerr = float((conv - ref).abs().max())
    _require(bool(torch.all((conv - ref).abs() <= 1e-4 + 2e-4 * ref.abs())),
             ("conv1d yardstick outside rtol 2e-4 / atol 1e-4", cerr))
    # bytes: the block and the taps in, a2 out; operations: the 4P
    # non-zero multiply-adds a (row, lane)
    nbytes = 4 * ((r_cnt + 2 * p) * hop * 2 + wa.numel() + r_cnt * 4 * hop)
    bound, by, line = _roofline(ms, nbytes, r_cnt * hop * 4 * p * 2)
    print(f"[P]   branch filter kernel {ms:.4f} ms eager, {dev_ms:.4f} ms "
          f"device (CUDA graph, share {bound / dev_ms:.3f}), plain "
          f"{plain_ms:.3f} ms (no yardstick), F.conv1d(groups=hop) "
          f"{conv_ms:.4f} ms (max|err| vs plain {cerr}); {line} (eager); "
          f"whole analysis block (kernel + f32 DFT) {block_ms:.3f} ms")
    _dft_check(ana, x, a2, got, dft, dft16, qpar)
    return max(err, a2_err), ms, plain_ms, bound, by, conv_ms


def _dft_check(ana, x, a2, bank32, dft, dft16, qpar) -> None:
    """[P] the bf16 channel DFT, the analysis' default on the card: the
    bf16 product (torch.mm with a float32 output) against its plain
    version (operands rounded to bf16, float32 product) within 1e-5 of the
    bank's peak, the whole bf16 bank against the same, and against the
    float32 bank bank32 at <= -40 dB of its RMS; the f32 and bf16 products
    timed eager and by CUDA-graph replay beside their bounds (a2 and the
    table read once, the bank written once; 2 R 4hop 2M operations at the
    f32 and the bf16 tensor-core peak)."""
    import torch

    from gmr1_tpu_torch.channelizer import pfb
    m, r_cnt = ana.m, a2.shape[0]
    c16 = pfb.channel_dft(a2, dft16, True)
    plain = pfb.channel_dft_plain(a2, dft)
    ana.dft_bf16 = True
    bank16 = ana.block(x)
    rpar = (torch.arange(r_cnt, device=x.device) & 1).to(torch.float32)
    ref = plain * (1.0 - 2.0 * rpar[:, None] * qpar[None, :])
    ref = torch.stack([ref[:, :m], ref[:, m:]], dim=-1)
    torch.cuda.synchronize()
    _require(c16.dtype == torch.float32, c16.dtype)
    peak = float(plain.abs().max())
    err = float((c16 - plain).abs().max())
    berr = float((bank16 - ref).abs().max())
    db = 10.0 * np.log10(float(((bank16 - bank32) ** 2).sum())
                         / float((bank32 ** 2).sum()))
    print(f"[P]   bf16 channel DFT ({r_cnt}, {a2.shape[1]}) @ "
          f"({dft.shape[0]}, {2 * m}): max|err| vs plain {err} "
          f"({err / peak:.3g} of the peak {peak:.1f}); whole bf16 bank vs "
          f"plain {berr / peak:.3g} of the peak; bf16 vs the f32 bank "
          f"{db:.2f} dB of its RMS")
    _require(err <= 1e-5 * peak and berr <= 1e-5 * peak,
             ("bf16 DFT vs plain beyond 1e-5 of the peak", err, berr, peak))
    _require(db <= -40.0, ("bf16 vs f32 bank above -40 dB", db))
    nops = 2.0 * r_cnt * a2.shape[1] * 2 * m
    out_b = 4 * r_cnt * 2 * m
    for what, fn, tab_b, flops in (
            ("f32 ", lambda: a2 @ dft, 4, F32_FLOPS),
            ("bf16", lambda: pfb.channel_dft(a2, dft16, True), 2,
             BF16_FLOPS)):
        eager = _cuda_ms(fn, 20)
        graph = _graph_ms(fn)
        _b, _by, line = _roofline(graph, 4 * a2.numel() + tab_b * dft.numel()
                                  + out_b, nops, flops)
        print(f"[P]   {what} DFT product {eager:.4f} ms eager, {graph:.4f} "
              f"ms device (CUDA graph; bf16 includes the cast of a2); {line}"
              " (device)")


def phase_ab(old_root: str, rng, dev, n_car: int) -> None:
    """[ab]: kernels V, P and A5 built from OLD_ROOT's sources and from
    this checkout's, each checked against the plain version and timed by
    CUDA-graph replay in turns old, new, new, old at the main path's
    shapes (device times; same card, same call)."""
    import ctypes

    import torch

    from gmr1_tpu_torch import kernels
    from gmr1_tpu_torch.channelizer import pfb
    from gmr1_tpu_torch.ops import a5
    from gmr1_tpu_torch.ops import conv as CV
    from gmr1_tpu_torch.ops import viterbi as VT
    out = kernels.BUILD_DIR / "ab"
    out.mkdir(parents=True, exist_ok=True)
    fns, procs = {}, {}
    for side, root in (("old", old_root), ("new", os.path.dirname(
            os.path.abspath(__file__)))):
        for name in ("viterbi", "pfb", "a5"):
            src = os.path.join(root, "gmr1_tpu_torch", "kernels", f"{name}.cu")
            lib = out / f"{side}_{name}.so"
            procs[side, name] = (lib, subprocess.Popen(
                [kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(lib), src],
                stderr=subprocess.PIPE, text=True))
    for (side, name), (lib, proc) in procs.items():
        _, err = proc.communicate()
        _require(proc.returncode == 0, (side, name, err[-2000:]))
        sym, argtypes = kernels._ENTRY[name]
        fns[side, name] = getattr(ctypes.CDLL(str(lib)), sym)
        fns[side, name].argtypes = argtypes
        fns[side, name].restype = ctypes.c_int

    def turns(name, call, check):
        got = {}
        for side in ("old", "new", "new", "old"):
            fn = fns[side, name]
            _require(call(fn) == 0 and check(), (side, name))
            got.setdefault(side, []).append(_graph_ms(lambda: call(fn)))
        return " ".join(f"{k} {' '.join(f'{v:.4f}' for v in vs)} ms"
                        for k, vs in got.items())

    for code, t_steps, b, what in (
            (CV.K5_12, 212, 6 * n_car, "CCCH"),
            (CV.TCH3_K7, 48, 2 * n_car * F, "TCH3 speech"),
            (CV.K5_12, 320, n_car * F, "FACCH9"),
            (CV.K5_12, 484, n_car * F, "TCH9 9k6"),
            (CV.K5_14, 96, n_car, "FACCH3"),
            (CV.K5_12, 212, 1, "per-carrier BCCH/CCCH"),
            (CV.K5_14, 96, 1, "per-carrier FACCH3"),
            (CV.K5_12, 320, 1, "per-carrier FACCH9"),
            (CV.K5_12, 484, 1, "per-carrier TCH9"),
            (CV.TCH3_K7, 48, 2, "per-carrier speech"),
            (_k9_codes()["k9_tb"], 208, n_car, "DC12"),
            (_k9_codes()["k9_tb"], 208, 2048, "K9")):
        sym, sign, flush = _trellis_case(code, t_steps, b, rng, dev)
        pb, pm = VT.decode_trellis_plain(sym, sign, flush)
        bits = torch.empty((b, t_steps), dtype=torch.uint8, device=dev)
        met = torch.empty((b,), dtype=torch.float32, device=dev)
        line = turns("viterbi", lambda fn: fn(
            sym.data_ptr(), sign.data_ptr(), bits.data_ptr(), met.data_ptr(),
            b, t_steps, code.n, code.num_states, int(flush),
            kernels.stream_ptr()),
            lambda: bool(torch.equal(bits, pb) and torch.equal(met, pm)))
        print(f"[ab] V {code.name} B={b} T={t_steps} ({what}): {line}")
    for fs, need_nx in ((FS, False), (PATHS_FS, True)):
        ana = pfb.Channelizer(fs, 1525e6 + 31250 * CENTER_ARFCN,
                              need_nx=need_nx).analyzer
        m, p, hop, r_cnt = ana.m, ana.p, ana.hop, 2500 * F
        x = torch.as_tensor(rng.normal(size=(r_cnt * hop + p * m, 2))
                            .astype(np.float32), device=dev)
        wa = ana._tables(dev)[0]
        ref = pfb.branch_filter_plain(x, wa, r_cnt, hop)
        a2 = torch.empty_like(ref)
        line = turns("pfb", lambda fn: fn(
            x.data_ptr(), wa.data_ptr(), a2.data_ptr(), r_cnt, hop, 2 * p,
            kernels.stream_ptr()), lambda: bool(torch.all(
                (a2 - ref).abs() <= 1e-4 + 2e-4 * ref.abs())))
        print(f"[ab] P M={m} P={p} R={r_cnt}: {line}")
    key = rng.integers(0, 256, 8, dtype=np.uint8)
    key_word = int(np.frombuffer(key.tobytes(), "<u8")[0])
    for b, nbits, with_ul in ((n_car * F, 658, False), (n_car * F, 658, True),
                              (1, 658, False), (1, 208, False),
                              (1, 96, False)):
        frames = torch.as_tensor(rng.integers(0, 1 << 19, b), device=dev)
        rd, ru = a5.keystream_plain(key, frames, nbits, with_ul=with_ul)
        dl = torch.empty_like(rd)
        ul = torch.empty_like(rd) if with_ul else None
        line = turns("a5", lambda fn: fn(
            key_word, frames.data_ptr(), dl.data_ptr(),
            ul.data_ptr() if with_ul else None, b, nbits,
            kernels.stream_ptr()), lambda: bool(
                torch.equal(dl, rd) and (not with_ul or torch.equal(ul, ru))))
        print(f"[ab] A5 B={b} nbits={nbits} "
              f"({'dl + ul' if with_ul else 'dl'}): {line}")


@contextlib.contextmanager
def _phase_calls():
    """Record every block phase (`_phase_block`) the wideband receiver
    runs inside: a list of (carrier rows, device, rows of its traffic
    half, kernel V launches, kernel A5 launches), one entry a call."""
    from gmr1_tpu_torch.rx import wideband
    orig, calls = wideband._phase_block, []

    def phase(streams, m, *args):
        c0 = _counts()
        out = orig(streams, m, *args)
        c1 = _counts()
        tr = m["tr"]
        calls.append((int(m["rows"].shape[0]), str(m["rows"].device),
                      0 if tr is None else int(tr["rows"].shape[0]),
                      c1["viterbi"] - c0["viterbi"], c1["a5"] - c0["a5"]))
        return out
    wideband._phase_block = phase
    try:
        yield calls
    finally:
        wideband._phase_block = orig


def _check_phase_launches(calls, what: str, phase_v=None) -> int:
    """The kernel launches of each block phase in `calls` (`_phase_calls`):
    without a traffic slot, kernel V twice (BCCH, CCCH) and A5 never;
    with one, V as every such phase (`phase_v` where given) and A5 once.
    Returns the V launches of a phase with a traffic half (None if no
    phase had one)."""
    full = {v for _n, _d, t, v, _a in calls if t}
    if phase_v is not None:
        full.add(phase_v)
    _require(len(full) <= 1, (what, "block phases with a traffic half "
                              "launch kernel V differently", sorted(full)))
    v_full = min(full, default=None)
    for n, dev, t, v, a in calls:
        want = (v_full, 1) if t else (2, 0)
        _require((v, a) == want, (what, "block phase launches (V, A5)",
                                  (n, dev, t, v, a), "want", want))
    return v_full


def _trace_census(fn, path: str) -> tuple[dict, float, float, float]:
    """Run fn under torch.profiler (CUDA activity) and read its trace: its
    host-to-device copies {kind: (count, bytes, largest)}, kind "Pageable"
    or "Pinned"; the summed durations (s) of its kernels and of its
    copies; and its wall (s)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    prof.export_chrome_trace(path)
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    h2d: dict = {}
    kern = copy = 0.0
    for e in events:
        name, cat = e.get("name", ""), e.get("cat", "")
        if cat == "kernel":
            kern += float(e.get("dur", 0.0)) * 1e-6
        elif name.startswith("Memcpy"):
            copy += float(e.get("dur", 0.0)) * 1e-6
        if name.startswith("Memcpy HtoD"):
            kind = "Pageable" if "Pageable" in name else "Pinned"
            n, b, big = h2d.get(kind, (0, 0, 0))
            nb = int(e.get("args", {}).get("bytes", 0))
            h2d[kind] = (n + 1, b + nb, max(big, nb))
    return h2d, kern, copy, wall


def _rx_line(tag: str, rx, n_samp: int, wall: float, card: str) -> str:
    """Msamples/s, the sections and device_block_time of a run."""
    return (f"[{tag}] wall {wall:.2f} s = {n_samp / wall / 1e6:.2f} "
            f"Msamples/s vs real time {FS / 1e6:.0f} ({card}); sections "
            + ", ".join(f"{k} {v:.3f} s" for k, v in rx.prof.items())
            + f"; device_block_time {rx.device_block_time() * 1e3:.2f} ms "
            f"a block against {rx.n_block / FS * 1e3:.0f} ms of real time")


def _reader_line(rx) -> str:
    """A run's block-loop iterations (wall / ingest_wait, ms) and the
    block reader's worker time a job (ms)."""
    return ("per iteration ms (wall / ingest_wait): " + ", ".join(
        f"{w * 1e3:.1f}/{p.get('ingest_wait', 0.0) * 1e3:.1f}"
        for w, p in zip(rx.block_walls, rx.block_profs))
        + f"; the worker's time a job ms ({len(rx.reader_s)} jobs, "
        f"{sum(rx.reader_s):.3f} s): "
        + ", ".join(f"{t * 1e3:.1f}" for t in rx.reader_s))


def phase_slice(tmp: str, card: str) -> tuple[dict, dict]:
    """[slice]: the 34 MHz, 1064-carrier capture with traffic through
    WidebandReceiver(device="cuda").run() with its defaults (the block
    reader, the bf16 channel DFT), then a second run with the f32 DFT
    (every CRC-protected frame equal), the first receiver's
    device_block_time with the DFT in turns, and a profiled third run
    (busy share; no pageable block upload); returns the first run's
    kernel launches and
    the capture, its truth and the receiver (with its frames) for the
    phases that reuse them."""
    import torch

    from gmr1_tpu_torch.rx.wideband import WidebandReceiver
    t0 = time.perf_counter()
    wb, center, seeded, truths = synthesize(FS, CONTENT_BLOCKS)
    print(f"[slice] synthesized {wb.shape[0] / 1e6:.1f} Msamples "
          f"({wb.shape[0] / FS:.2f} s at {FS / 1e6:.0f} MHz, "
          f"{len(seeded)} live carriers) in {time.perf_counter() - t0:.1f} s")
    rx = WidebandReceiver(wb, FS, center, sps=SPS, device="cuda")
    _zero_counts()
    torch.cuda.synchronize()
    with _phase_calls() as calls:
        t0 = time.perf_counter()
        n_frames = rx.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = _counts()
    counts = verify_slice(rx, seeded, truths)
    t_acq = rx.prof["acquire"]
    print(f"[slice] carriers found {counts['carriers']} "
          f"(seeded {counts['seeded']}, false-FCCH strays "
          f"{counts['strays']} with {counts['stray_frames']} frames); "
          f"frames decoded {n_frames}: SI1 {counts['si1']}, CCCH "
          f"{counts['ccch']}, FACCH3 {counts['facch3']}, FACCH9 "
          f"{counts['facch9']}, all bit-exact; "
          f"{counts['traffic_carriers']} traffic carriers: speech "
          f"{counts['speech']}, DKAB {counts['dkab']}, CSD payloads "
          f"{counts['csd']} in order, TCH9 frames {counts['tch9']}; "
          f"CRC passes at unseeded fns {counts['unseeded_crc_pass']}")
    print("[slice] kernel launches in run(): " + ", ".join(
        f"{k} {v}" for k, v in launches.items()))
    for name, n in launches.items():
        _require(n > 0, f"the receiver never launched the {name} kernel")
    # the block reader ran, on pinned staging buffers and a copy stream
    _require("ingest_wait" in rx.prof and rx.reader_s
             and rx._copy_stream is not None
             and all(b.is_pinned() for b in rx._stage),
             "the block reader's worker, staging buffers or copy stream")
    phase_v = _check_phase_launches(calls, "[slice]")
    t_sizes = [t for _n, _d, t, _v, _a in calls]
    _require(phase_v is not None, ("[slice]: no block phase ran a traffic "
                                   "half", t_sizes))
    print(f"[slice] acquire {t_acq:.2f} s, block loop {wall - t_acq:.2f} s, "
          f"{len(rx.block_walls)} blocks, {len(calls)} block phases; "
          f"traffic slots a phase (of {calls[0][0]}): {t_sizes}; kernel V "
          f"{phase_v} launches and A5 1 in a phase with traffic slots, V 2 "
          "and A5 0 in one without; " + _reader_line(rx))
    print(_rx_line("slice", rx, wb.shape[0], wall, card)
          + " (bf16 channel DFT, the default)")
    crc = _crc_types()
    first = [f for f in rx.frames if f[1] in crc]

    rx32 = WidebandReceiver(wb, FS, center, sps=SPS, device="cuda")
    rx32.chz.analyzer.dft_bf16 = False
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rx32.run()
    torch.cuda.synchronize()
    wall32 = time.perf_counter() - t0
    c32 = verify_slice(rx32, seeded, truths)
    got = [f for f in rx32.frames if f[1] in crc]
    _require(got == first, ("f32 DFT: CRC-protected frames differ from the "
                            "bf16 run's", len(got), len(first)))
    print(_rx_line("slice", rx32, wb.shape[0], wall32, card)
          + f" (f32 channel DFT: verify_slice passed, {c32['si1']} SI1, "
          f"{c32['facch3']} FACCH3, {c32['facch9']} FACCH9; its {len(got)} "
          "CRC-protected frames equal the bf16 run's, in order)")
    del rx32

    # the DFT's share of device_block_time: the same receiver in turns
    turns = []
    for flag in (True, False, False, True):
        rx.chz.analyzer.dft_bf16 = flag
        turns.append(f"{'bf16' if flag else 'f32'} "
                     f"{rx.device_block_time() * 1e3:.2f}")
    rx.chz.analyzer.dft_bf16 = True
    print("[slice] device_block_time of the first receiver, channel DFT in "
          "turns: " + ", ".join(turns) + f" ms a block ({card})")

    rxp = WidebandReceiver(wb, FS, center, sps=SPS, device="cuda")
    h2d, kern, copy, pwall = _trace_census(
        rxp.run, os.path.join(tmp, "slice_trace.json"))
    verify_slice(rxp, seeded, truths)
    print("[slice] a profiled run (torch.profiler trace): wall "
          f"{pwall:.2f} s, kernels {kern:.3f} s (busy share "
          f"{kern / pwall:.3f}), copies {copy:.3f} s; host-to-device "
          "copies: " + ", ".join(
              f"{k} {n} copies, {b / 1e6:.2f} MB, largest {big / 1e6:.3f} MB"
              for k, (n, b, big) in sorted(h2d.items())))
    _require(h2d.get("Pinned", (0, 0, 0))[2] >= 4 * rxp.n_block * 2,
             ("no pinned block upload in the trace", h2d))
    _require(h2d.get("Pageable", (0, 0, 0))[2] < 2 * rxp.n_block * 2,
             ("a pageable upload of a block", h2d))
    del rxp
    return launches, dict(wb=wb, fs=FS, center=center, seeded=seeded,
                          truths=truths, rx=rx, launches=launches,
                          msps=wb.shape[0] / wall, phases=len(calls),
                          phase_v=phase_v)


# --------------------------------------------------------------------------
# [mesh]: the multi-device form, several shards on the card
# --------------------------------------------------------------------------

def _crc_types() -> tuple:
    """GSMTap sub-types of the CRC-protected frames: BCCH, CCCH, FACCH3,
    FACCH9."""
    from gmr1_tpu_torch.rx import gsmtap as gt
    return (gt.GMR1_BCCH, gt.GMR1_CCCH, gt.GMR1_TCH3 | gt.GMR1_FACCH,
            gt.GMR1_TCH9 | gt.GMR1_FACCH)


def _meshes(dev) -> list:
    """Every card of the machine when it has more than one, else 2 and 4
    shards on the one device."""
    import torch

    from gmr1_tpu_torch.parallel import Mesh
    n = torch.cuda.device_count() if dev.type == "cuda" else 1
    if n > 1:
        return [Mesh([f"cuda:{i}" for i in range(n)])]
    return [Mesh([dev] * d) for d in (2, 4)]


def _rows_check(what: str, got, ref, bf16: bool) -> None:
    """Hold resharded rows against the single-device analysis: f32
    transport to rtol 2e-4 / atol 1e-4, bf16 within one bf16 ulp
    (|a - b| <= 2^-7 |b| + 1e-6)."""
    import torch
    d = (got - ref).abs()
    ok = (d <= 2.0 ** -7 * ref.abs() + 1e-6) if bf16 \
        else (d <= 1e-4 + 2e-4 * ref.abs())
    same = bool(torch.equal(got, ref.bfloat16().float() if bf16 else ref))
    print(f"[mesh] {what} ({'bf16' if bf16 else 'f32'} transport): max|err| "
          f"{float(d.max())} vs the single-device analysis (peak "
          f"{float(ref.abs().max()):.1f}); equal to it"
          f"{' rounded to bf16' if bf16 else ''}: {same}")
    _require(bool(ok.all()), (what, bf16, int((~ok).sum())))


def phase_mesh(card: str, sl: dict, dev) -> dict:
    """[mesh]: analyze_reshard on 2 and 4 shards (single-process mesh, and
    the process-group form at world size 1) against the single-device
    analysis on a block of the [slice] capture; WidebandReceiver(mesh=)
    over the whole capture (verify_slice, CRC-protected frames equal to
    [slice]'s); int16 ingest on one device; device_block_time.  Returns
    the mesh receivers' kernel launches."""
    import socket

    import torch
    import torch.distributed as dist

    from gmr1_tpu_torch.parallel import (ShardedRows, analyze_reshard,
                                         overlapped_shards)
    from gmr1_tpu_torch.rx.wideband import WidebandReceiver
    wb, fs, center = sl["wb"], sl["fs"], sl["center"]
    rx1 = sl["rx"]
    ana = rx1.chz.analyzer
    halo, n_block = ana.p * ana.m, rx1.n_block
    x = np.ascontiguousarray(wb[n_block:2 * n_block])
    xh = torch.cat([torch.zeros((halo, 2)), torch.from_numpy(x)]).to(dev)
    ref = ana.block(xh).permute(1, 0, 2)                 # (M, R_b, 2)
    meshes = _meshes(dev)
    for mesh in meshes:
        sh, _ = overlapped_shards(x, np.zeros((halo, 2), np.float32), halo,
                                  mesh.size)
        shards = [torch.from_numpy(sh[i]).to(d)
                  for i, d in enumerate(mesh.devices)]
        for bf16 in (False, True):
            got = ShardedRows(analyze_reshard(ana, mesh, shards, bf16))
            _rows_check(f"analyze_reshard on {mesh}, M={ana.m} "
                        f"R={x.shape[0] // ana.hop}",
                        got.gather(dev), ref, bf16)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0)
    try:
        for bf16 in (False, True):
            _rows_check(f"analyze_reshard over a {backend} process group of "
                        "1 rank", analyze_reshard(ana, dist.group.WORLD, xh,
                                                  bf16), ref, bf16)
    finally:
        dist.destroy_process_group()
    del xh, ref

    crc = _crc_types()
    single = sorted(f for f in rx1.frames if f[1] in crc)
    by_path = dict(viterbi=0, pfb=0, a5=0)
    for mesh in meshes:
        rx = WidebandReceiver(wb, fs, center, sps=SPS, mesh=mesh, device=dev)
        _zero_counts()
        _sync(dev)
        with _phase_calls() as calls:
            t0 = time.perf_counter()
            n_frames = rx.run()
            _sync(dev)
            wall = time.perf_counter() - t0
        launches = _counts()
        counts = verify_slice(rx, sl["seeded"], sl["truths"])
        got = [f for f in rx.frames if f[1] in crc]
        _require(sorted(got) == single,
                 (str(mesh), "CRC-protected frames differ from [slice]'s",
                  len(got), len(single)))
        want_p = mesh.size * sl["launches"]["pfb"]
        _require(launches["pfb"] == want_p,
                 (str(mesh), "kernel P launches", launches["pfb"], want_p))
        # the block phase split over the carriers: one phase a carrier
        # group a block, on the group's device, each launching V and A5
        # as [slice]'s phases do, by whether it has traffic slots
        n_car, d = len(rx.carriers), mesh.size
        groups = rx._groups()
        _require(n_car % d == 0 and len(groups) == d and len(rx._il) == d,
                 (str(mesh), "block phase not split", n_car, len(groups)))
        want = [(n_car // d, str(dv)) for dv in mesh.devices] * sl["phases"]
        _require([c[:2] for c in calls] == want,
                 (str(mesh), "block phases", calls[:8], len(calls),
                  len(want)))
        _check_phase_launches(calls, str(mesh), sl["phase_v"])
        for name, v in launches.items():
            _require(v > 0, f"the mesh receiver never launched the {name} "
                     "kernel")
            by_path[name] += v
        print(f"[mesh] WidebandReceiver(mesh={mesh}).run(): wall {wall:.2f} s"
              f" = {wb.shape[0] / wall / 1e6:.2f} Msamples/s vs real time "
              f"{fs / 1e6:.0f} ({card}); {n_frames} frames, verify_slice "
              f"passed ({counts['si1']} SI1, {counts['ccch']} CCCH, "
              f"{counts['facch3']} FACCH3, {counts['facch9']} FACCH9); "
              f"{len(got)} CRC-protected frames equal [slice]'s (same order: "
              f"{got == [f for f in rx1.frames if f[1] in crc]}); reshard "
              f"{rx.ici_bytes_per_block / 1e6:.2f} MB a device a block; "
              "kernel launches: " + ", ".join(f"{k} {v}" for k, v in
                                              launches.items())
              + f" (P = {mesh.size} x [slice]'s {sl['launches']['pfb']}); "
              f"block phase split over {d} groups of {n_car // d} carriers: "
              f"{len(calls)} phases = {d} x [slice]'s {sl['phases']}, "
              "traffic slots a phase "
              f"{[c[2] for c in calls]}, each with some launching kernel "
              f"V {sl['phase_v']} times and A5 once, each without V twice; "
              "sections " + ", ".join(f"{k} {v:.2f} s"
                                      for k, v in rx.prof.items()))
        print(f"[mesh] device_block_time on {mesh} (split phase): "
              f"{rx.device_block_time() * 1e3:.2f} ms a block")
        del rx

    rx = WidebandReceiver(wb, fs, center, sps=SPS, h2d_dtype="int16",
                          device=dev)
    _sync(dev)
    t0 = time.perf_counter()
    n_frames = rx.run()
    _sync(dev)
    wall = time.perf_counter() - t0
    counts = verify_slice(rx, sl["seeded"], sl["truths"])
    got = sorted(f for f in rx.frames if f[1] in crc)
    _require("ingest_wait" in rx.prof and rx.reader_s
             and rx._stage[0].dtype == torch.int16
             and rx._stage[0].is_pinned(),
             "int16 ingest did not go through the block reader")
    print("[mesh] int16: " + _reader_line(rx))
    msps = wb.shape[0] / wall / 1e6
    print(f"[mesh] h2d_dtype=int16 on one device, through the block reader: "
          f"wall {wall:.2f} s = {msps:.2f} Msamples/s, "
          f"{msps / (sl['msps'] / 1e6):.3f} of [slice]'s float32 "
          f"{sl['msps'] / 1e6:.2f} in this call ({card}); {n_frames} "
          f"frames, verify_slice passed ({counts['si1']} SI1, "
          f"{counts['facch3']} FACCH3, {counts['facch9']} FACCH9); "
          f"CRC-protected frames equal [slice]'s: {got == single}; sections "
          + ", ".join(f"{k} {v:.3f} s" for k, v in rx.prof.items()))
    return by_path


# the transponders' static slot map (tests/test_parallel.py:162)
TP_F, TP_STEPS = 8, 2         # frames a step, steps
TP_TN3, TP_TN9, TP_DKP = 6, 12, 9


def transponder_stream(rng, n_frames: int):
    """One payload stream on the transponders' slot map: SI1 BCCH on frame
    2 of each TP_F-frame step, NT3 speech on TN TP_TN3 in frames 0-5 and
    DKABs there in frames 6-7, a chained TCH9 9k6 train on TN TP_TN9 in
    every frame.  Returns (4-sps baseband, truth)."""
    import torch

    from gmr1_tpu_torch.l1 import bcch, tch3, tch9
    from gmr1_tpu_torch.sdr import bursts as BU
    from gmr1_tpu_torch.sdr import modem
    bb = np.zeros(n_frames * FRAME4 + 2000, np.complex64)
    truth = dict(bcch=[], speech=[], csd=[])
    il = tch9.interleaver_init(dtype=torch.uint8)
    zeros4, zeros10 = np.zeros(4, np.uint8), np.zeros(10, np.uint8)
    for k in range(n_frames):
        f = k % TP_F
        if f == 2:
            l2 = rng.integers(0, 256, 24, dtype=np.uint8)
            truth["bcch"].append(l2)
            _place(bb, k * FRAME4, modem.mod(BU.BCCH, bcch.encode(l2)))
        slot3 = k * FRAME4 + TP_TN3 * 39 * SPS
        if f < 6:
            f0 = rng.integers(0, 256, 10, dtype=np.uint8)
            f1 = rng.integers(0, 256, 10, dtype=np.uint8)
            truth["speech"].append((f0, f1))
            _place(bb, slot3, modem.mod(BU.NT3_SPEECH,
                                        tch3.encode(f0, f1, zeros4)))
        else:
            sig = _dkab_signal(TP_DKP, DKAB_BITS)
            bb[slot3:slot3 + len(sig)] += sig
        pay = rng.integers(0, 256, 60, dtype=np.uint8)
        truth["csd"].append(pay)
        il, eb = tch9.encode(pay, tch9.MODE_9K6, zeros10, zeros4, il)
        _place(bb, k * FRAME4 + TP_TN9 * 39 * SPS,
               modem.mod(BU.NT9, eb, sync_id=1))
    return bb, truth


def transponder_capture(fs: float, seed: int = 0x7A5):
    """Every usable grid channel live on the transponders' slot map: NS
    transponder_stream()s on their carriers' combs (ARFCN % NS), TP_STEPS
    steps of TP_F frames, no lead block.  Returns (planar (N, 2) float32,
    center, [live ARFCN], [truth per stream])."""
    from gmr1_tpu_torch.channelizer import pfb
    center = 1525e6 + 31250 * CENTER_ARFCN
    chz = pfb.Channelizer(fs, center, sps=SPS)
    m = chz.n_chans
    span = m // 2 - 12
    arfcns = [CENTER_ARFCN + o for o in range(-span, span)]
    rng = np.random.default_rng(seed)
    streams, truths = zip(*[transponder_stream(rng, TP_STEPS * TP_F)
                            for _ in range(NS)])
    wb = _comb_mix(rng, streams, arfcns, fs, m,
                   2500 * TP_F * chz.analyzer.hop, TP_STEPS, lead_noise=False)
    return wb, center, arfcns, truths


def phase_transponders(card: str, dev, fs: float = FS) -> dict:
    """[mesh] ShardedTransponder (one step) and StreamingTransponder (two
    steps, the carry across) on Mesh([dev] * 2) over every live carrier of
    a transponder_capture, held against the port's CPU run of the same
    input (Mesh(["cpu"] * 2)) bit for bit and against the truth; every
    column without a carrier fails its CRC.  The transponders run the f32
    channel DFT (parallel/transponder.py _f32_analyzer); _bf16_witness
    then shows why.  Returns the card run's kernel launches."""
    import torch

    from gmr1_tpu_torch.channelizer.arfcn import Channel
    from gmr1_tpu_torch.channelizer.pfb import Channelizer
    from gmr1_tpu_torch.l1 import bcch
    from gmr1_tpu_torch.parallel import (Mesh, ShardedTransponder,
                                         StreamingTransponder)
    from gmr1_tpu_torch.sdr import bursts as BU
    from gmr1_tpu_torch.sdr import modem
    t0 = time.perf_counter()
    wb, center, arfcns, truths = transponder_capture(fs)
    chz = Channelizer(fs, center, sps=SPS)
    m = chz.n_chans
    n_step = 2500 * TP_F * chz.analyzer.hop
    print(f"[mesh] transponder capture: {wb.shape[0] / 1e6:.2f} Msamples, "
          f"M={m}, {len(arfcns)} live carriers, {TP_STEPS} steps of {TP_F} "
          f"frames, synthesized in {time.perf_counter() - t0:.1f} s")
    # the pipeline delay: an unsharded probe on one carrier (its SI1 at
    # frame 2), as tests/test_parallel.py finds it
    stream = chz.extract(chz.process(torch.from_numpy(wb[:n_step]).to(dev)),
                         Channel(CENTER_ARFCN))[:5 * FRAME4]
    blen = BU.BCCH.len_syms * SPS
    probe = modem.demod(BU.BCCH, stream, sps=SPS, win=stream.shape[0] - blen)
    _require(not int(bcch.decode(probe.ebits)[1]), "transponder probe SI1")
    p0 = int(round(float(probe.toa))) - 2 * FRAME4
    cols = np.array([chz.freq2index(Channel(a).frequency) for a in arfcns])
    kw = dict(frames=TP_F, burst_pos=p0, tn_tch=TP_TN3, tn_tch9=TP_TN9,
              dkab_p=TP_DKP)

    def sharded(devs):
        return ShardedTransponder(Channelizer(fs, center, sps=SPS),
                                  Mesh(devs), n_step // 2, burst=BU.BCCH,
                                  sps=SPS, burst_pos=p0 + 2 * FRAME4 - 32,
                                  win=64)

    def sharded_step(sh):
        l2, fail, _metric, n_bad = sh.step(sh.shard_input(wb[:n_step]))
        return l2.cpu().numpy(), fail.cpu().numpy(), int(n_bad)

    def run(devs):
        mesh = Mesh(devs)
        st = StreamingTransponder(Channelizer(fs, center, sps=SPS), mesh,
                                  **kw)
        _require(mesh.size * st.n_local == n_step, (st.n_local, n_step))
        carry, outs = st.carry_init(), []
        for s in range(TP_STEPS):
            o, carry = st.step(st.shard_input(wb[s * n_step:(s + 1) * n_step]),
                               carry)
            outs.append({k: v.cpu().numpy() for k, v in o.items()})
        return outs, sharded_step(sharded(devs))

    _zero_counts()
    _sync(dev)
    t0 = time.perf_counter()
    card_out = run([dev] * 2)
    _sync(dev)
    wall = time.perf_counter() - t0
    launches = _counts()
    t0 = time.perf_counter()
    cpu_out = run(["cpu"] * 2)
    cpu_wall = time.perf_counter() - t0
    # the card run against the CPU, bit for bit (every live carrier; the
    # CRC flags of every column)
    for s, (c, p) in enumerate(zip(card_out[0], cpu_out[0])):
        f9 = 2 if s == 0 else 0               # TCH9 payload i at burst i+2
        pairs = dict(crcb=(c["crcb"], p["crcb"]),
                     l2b=(c["l2b"][cols], p["l2b"][cols]),
                     sf0=(c["sf0"][:6, cols], p["sf0"][:6, cols]),
                     sf1=(c["sf1"][:6, cols], p["sf1"][:6, cols]),
                     dk_found=(c["dk_found"][:, cols], p["dk_found"][:, cols]),
                     dk_bits=(c["dk_bits"][6:, cols] < 0,
                              p["dk_bits"][6:, cols] < 0),
                     l2_t9=(c["l2_t9"][f9:, cols], p["l2_t9"][f9:, cols]))
        for k, (a, b) in pairs.items():
            _require(np.array_equal(a, b), ("StreamingTransponder card vs "
                                            "CPU", s, k))
    for k, a, b in zip(("l2", "crc", "n_bad"), card_out[1], cpu_out[1]):
        _require(np.array_equal(a[cols] if k == "l2" else a,
                                b[cols] if k == "l2" else b),
                 ("ShardedTransponder card vs CPU", k))
    # and the truth of every live carrier
    tr = [truths[a % NS] for a in arfcns]
    for s, o in enumerate(card_out[0]):
        _require(not o["crcb"][cols].any()
                 and np.array_equal(o["l2b"][cols],
                                    np.stack([t["bcch"][s] for t in tr])),
                 ("StreamingTransponder BCCH", s))
        for f in range(6):
            sp = [t["speech"][s * 6 + f] for t in tr]
            _require(np.array_equal(o["sf0"][f, cols], np.stack([x[0] for x in sp]))
                     and np.array_equal(o["sf1"][f, cols],
                                        np.stack([x[1] for x in sp])),
                     ("StreamingTransponder speech", s, f))
        _require(o["dk_found"][6:, cols].all()
                 and not o["dk_found"][:6, cols].any()
                 and np.array_equal((o["dk_bits"][6:, cols] < 0).astype(int),
                                    np.broadcast_to(DKAB_BITS, (2, len(cols), 8))),
                 ("StreamingTransponder DKAB", s))
        for f in range(TP_F):
            i = s * TP_F + f - 2
            if i >= 0:
                _require(np.array_equal(o["l2_t9"][f, cols],
                                        np.stack([t["csd"][i] for t in tr])),
                         ("StreamingTransponder TCH9 across steps", s, f))
    l2, fail, n_bad = card_out[1]
    _require(not fail[cols].any() and np.array_equal(
        l2[cols], np.stack([t["bcch"][0] for t in tr]))
        and n_bad == m - len(cols), ("ShardedTransponder", n_bad))
    print(f"[mesh] StreamingTransponder ({TP_STEPS} steps) + "
          f"ShardedTransponder (1 step) on 2 shards of the card: {wall:.2f} s"
          f" ({card}), the CPU's run of the same {cpu_wall:.2f} s; l2, CRC "
          f"flags, speech, DKAB found and bits and TCH9 l2 across the step "
          f"boundary equal the CPU's bit for bit and the truth on all "
          f"{len(cols)} live carriers; n_bad {n_bad} (every column without "
          "a carrier fails its CRC); kernel launches: "
          + ", ".join(f"{k} {v}" for k, v in launches.items()))
    _require(launches["pfb"] > 0 and launches["viterbi"] > 0,
             ("transponder launches", launches))
    _bf16_witness(wb[:n_step], dev, sharded, sharded_step, cols, arfcns,
                  truths, m)
    return launches


def _rounded_analyzer(ana, a2_bf16: bool, table_bf16: bool):
    """A copy of the analyzer `ana` whose channel DFT rounds the branch
    filter's output (a2) and/or the DFT table to bf16 and multiplies in
    float32 on any device; both rounded is the bf16 product's plain
    version (channel_dft_plain)."""
    import torch

    from gmr1_tpu_torch.channelizer import pfb

    class Rounded(pfb.PFBAnalyzer):
        def block_packed(self, xp):
            r_cnt = (xp.shape[0] - self.p * self.m) // self.hop
            wa, dft, _dft16, qpar = self._tables(xp.device)
            a2 = pfb.branch_filter(xp, wa, r_cnt, self.hop)
            if a2_bf16:
                a2 = a2.bfloat16().float()
            if table_bf16:
                dft = dft.bfloat16().float()
            rpar = (torch.arange(r_cnt, device=xp.device) & 1).float()
            return (a2 @ dft) * (1.0 - 2.0 * rpar[:, None] * qpar[None, :])
    return Rounded.from_numpy(ana.h_poly, ana.chunk_frames, dft_bf16=False)


def _bf16_witness(x, dev, sharded, sharded_step, cols, arfcns, truths,
                  m: int) -> None:
    """Why the transponders run the f32 channel DFT: the ShardedTransponder
    step of phase_transponders with a bf16 DFT, the card's product
    (analyzer.dft_bf16 = True) and on the CPU its plain version, the table
    alone rounded and a2 alone rounded.  For each: the columns with no
    carrier that pass their CRC, the truth (comb stream, step) their L2
    equals, the combs of the nearest live columns, and each such column's
    power in dB of the mean live column's, from the same analysis over the
    step unsharded (beside the f32 analysis's).  Every live carrier must
    still decode its truth; what passes elsewhere is printed."""
    import torch
    live = {int(c): a for c, a in zip(cols, arfcns)}
    xh = torch.from_numpy(x)

    def col_db(ana, xd):
        c2 = ana.block_packed(torch.cat([xd.new_zeros((ana.p * ana.m, 2)),
                                         xd]))
        pw = (c2[:, :m] ** 2 + c2[:, m:] ** 2).mean(0).double().cpu()
        return (10.0 * torch.log10(pw / pw[cols].mean())).numpy()

    sh = sharded([dev] * 2)
    f32_db = col_db(sh.analyzer, xh.to(dev))
    sh.analyzer.dft_bf16 = True
    runs = [("card bf16 product", sh, xh.to(dev))]
    for name, ra, rt in (("CPU plain bf16", True, True),
                         ("CPU table alone rounded", False, True),
                         ("CPU a2 alone rounded", True, False)):
        shc = sharded(["cpu"] * 2)
        shc.analyzer = _rounded_analyzer(shc.analyzer, ra, rt)
        runs.append((name, shc, xh))
    for name, shw, xd in runs:
        l2, fail, n_bad = sharded_step(shw)
        _require(not fail[cols].any() and np.array_equal(
            l2[cols], np.stack([truths[a % NS]["bcch"][0] for a in arfcns])),
            ("bf16 witness: a live carrier lost its SI1", name))
        db = col_db(shw.analyzer, xd)
        found = []
        for c in (c for c in range(m) if not fail[c] and c not in live):
            same = [f"comb {s} step {i}" for s in range(NS)
                    for i, t in enumerate(truths[s]["bcch"])
                    if np.array_equal(t, l2[c])]
            lo = max((k for k in live if k < c), default=None)
            hi = min((k for k in live if k > c), default=None)
            near = ", ".join(f"{k} (ARFCN {live[k]}, comb {live[k] % NS})"
                             for k in (lo, hi) if k is not None)
            found.append(f"column {c}: L2 {l2[c].tobytes().hex()} = the "
                         f"truth of {' / '.join(same) or 'no stream'}; "
                         f"nearest live columns {near}; {db[c]:.2f} dB "
                         f"(f32 analysis {f32_db[c]:.2f} dB)")
        empty = [c for c in range(m) if c not in live]
        print(f"[mesh] bf16 DFT witness, ShardedTransponder step 0, {name}: "
              f"n_bad {n_bad} of {len(empty)} columns without a carrier "
              f"(f32: {len(empty)}); the loudest such column "
              f"{float(db[empty].max()):.2f} dB (f32 analysis "
              f"{float(f32_db[empty].max()):.2f} dB); "
              + ("; ".join(found) if found
                 else "no column without a carrier passes its CRC"))


# --------------------------------------------------------------------------
# [split]: the channelizer CLI; [tools]: the tools drivers
# --------------------------------------------------------------------------

SPLIT_OFFSETS = (-4, -1, 2, 5)   # one ARFCN a comb stream, near the center
SPLIT_BLOCKS = 2                 # content blocks of the [slice] capture


def phase_split(tmp: str, card: str, sl: dict, dev) -> dict:
    """[split]: `python -m gmr1_tpu_torch.channelizer` in both modes on a
    cut of the [slice] capture (written as a cfile named by the
    reference's recording pattern), four seeded ARFCNs, --block one
    [slice] block: each stream decodes its SI1s to the truth, and the
    card's streams equal the CPU's to rtol 1e-4 (atol 1e-4 of the
    stream's peak).  The CPU runs the f32 channel DFT, so in pfb mode
    that comparison takes the card's f32-DFT streams, made in-process as
    the CLI makes them (one Channelizer with analyzer.dft_bf16 = False,
    each block on its own); the CLI's default run (the bf16 DFT) decodes
    its SI1s and stays within -40 dB of those streams' RMS.
    gmr1_process_recording prints the port's commands for the capture.
    Returns the card runs' kernel launches."""
    import io

    import torch

    from gmr1_tpu_torch.channelizer import ddc  # noqa: F401 (TF32 flag)
    from gmr1_tpu_torch.channelizer.__main__ import main as chz_main
    from gmr1_tpu_torch.channelizer.arfcn import Channel
    from gmr1_tpu_torch.channelizer.pfb import Channelizer
    from gmr1_tpu_torch.l1 import bcch
    from gmr1_tpu_torch.sdr import bursts as BU
    from gmr1_tpu_torch.sdr import modem
    from gmr1_tpu_torch.tools import gmr1_process_recording as gpr
    _require(not (torch.backends.cudnn.allow_tf32
                  or torch.backends.cuda.matmul.allow_tf32),
             "TF32 is on for cuDNN convolutions or matmuls")
    wb, fs, center = sl["wb"], sl["fs"], sl["center"]
    n_block = sl["rx"].n_block
    arfcns = [CENTER_ARFCN + o for o in SPLIT_OFFSETS]
    path = os.path.join(tmp, f"slice-f{center:.0f}-s{fs:.0f}"
                             "-t20261016120000.cfile")
    wb[n_block:(1 + SPLIT_BLOCKS) * n_block].tofile(path)
    argv = [path, "-s", str(fs), "-f", str(center), "--block", str(n_block)]
    for a in arfcns:
        argv += ["-a", str(a)]

    def split(mode, device, role):
        out = os.path.join(tmp, f"split_{mode}_{role}")
        os.makedirs(out)
        _sync(dev)
        t0 = time.perf_counter()
        rc = chz_main(argv + ["--mode", mode, "-o", out, "--device", device])
        _sync(dev)
        _require(rc == 0, ("channelizer CLI", mode, device, rc))
        return time.perf_counter() - t0, {
            a: np.fromfile(os.path.join(out, f"arfcn_{a}.cfile"),
                           np.float32).reshape(-1, 2) for a in arfcns}

    def split_f32():
        # the pfb CLI's loop (gmr1_tpu_torch/channelizer/__main__.py)
        # with the f32 channel DFT
        chz = Channelizer(fs, center, sps=SPS)
        chz.analyzer.dft_bf16 = False
        cut = wb[n_block:(1 + SPLIT_BLOCKS) * n_block]
        out = {a: [] for a in arfcns}
        _sync(dev)
        t0 = time.perf_counter()
        for beg in range(0, cut.shape[0], n_block):
            bank = chz.process(torch.from_numpy(cut[beg:beg + n_block])
                               .to(dev))
            for a in arfcns:
                out[a].append(chz.extract(bank, Channel(a)).cpu().numpy())
        _sync(dev)
        return time.perf_counter() - t0, {a: np.concatenate(v)
                                          for a, v in out.items()}

    _zero_counts()
    card_runs = {mode: split(mode, str(dev), "card")
                 for mode in ("pfb", "direct")}
    f32_wall, f32_streams = split_f32()
    launches = _counts()
    _require(launches["pfb"] > 0, "the pfb split never launched kernel P")
    blen = BU.BCCH.len_syms * SPS
    for mode, (wall, streams) in card_runs.items():
        cpu_wall, cpu = split(mode, "cpu", "cpu")
        exact = f32_streams if mode == "pfb" else streams
        n_si1, err, worst_db = 0, 0.0, -np.inf
        for a in arfcns:
            got, want = streams[a], cpu[a]
            _require(got.shape == want.shape == exact[a].shape
                     and got.shape[0] > 0, (mode, a, got.shape, want.shape))
            d = np.abs(exact[a] - want)
            err = max(err, float(d.max()))
            _require(bool(np.all(d <= 1e-4 * np.abs(want)
                                 + 1e-4 * np.abs(want).max())),
                     (mode, a, "card vs CPU", float(d.max())))
            if mode == "pfb":
                db = 10.0 * np.log10(float(((got - exact[a]) ** 2).sum())
                                     / float((exact[a] ** 2).sum()))
                worst_db = max(worst_db, db)
                _require(db <= -40.0, (a, "bf16 vs f32 DFT stream", db))
            nb = got.shape[0] // SPLIT_BLOCKS
            for b in range(SPLIT_BLOCKS):       # SI1 at frame 2 of a block
                beg = b * nb + 2 * FRAME4 - 200
                seg = torch.from_numpy(got[beg:beg + blen + 400]).to(dev)
                r = modem.demod(BU.BCCH, seg, sps=SPS, win=400)
                l2, bad, _ = bcch.decode(r.ebits)
                want_l2 = sl["truths"][a % NS]["si1"][F0 + 8 * b + 2]
                _require(not int(bad) and bytes(l2.cpu().numpy()) == want_l2,
                         (mode, a, b, "SI1"))
                n_si1 += 1
        print(f"[split] --mode {mode}: {len(arfcns)} carriers x "
              f"{SPLIT_BLOCKS} blocks of {n_block} samples, CLI wall "
              f"{wall:.2f} s on the card ({card}), {cpu_wall:.2f} s on the "
              f"CPU; card vs CPU max|err| {err:.3g}"
              + (f" (the card's f32-DFT streams, in-process, {f32_wall:.2f} "
                 f"s; the CLI's default bf16 run's streams within "
                 f"{worst_db:.2f} dB of their RMS)"
                 if mode == "pfb" else "")
              + f"; {n_si1} SI1s decoded to the truth")
    print("[split] kernel launches (card runs): " + ", ".join(
        f"{k} {v}" for k, v in launches.items()))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = gpr.main([path])
    lines = buf.getvalue().splitlines()
    _band, vis = gpr.visible_arfcns(gpr.parse_filename(path))
    _require(rc == 0 and len(lines) == 1 + len(vis)
             and set(arfcns) <= set(vis)
             and f" -m gmr1_tpu_torch.channelizer {path} " in lines[0]
             and lines[0].count(" -a ") == len(vis)
             and all(line.endswith(f" -m gmr1_tpu_torch.rx 4 arfcn_{a}.cfile")
                     for a, line in zip(vis, lines[1:]))
             and "gmr1_tpu." not in buf.getvalue(),
             ("gmr1_process_recording", rc, len(lines), len(vis)))
    print(f"[split] gmr1_process_recording {os.path.basename(path)}: the "
          f"split command and {len(vis)} demod commands, all of the port's "
          "modules")
    return launches


def _pbm(path: str) -> np.ndarray:
    with open(path) as fh:
        _require(fh.readline().strip() == "P1", (path, "P1"))
        w, h = map(int, fh.readline().split())
        m = np.array([line.split() for line in fh], np.uint8)
    _require(m.shape == (h, w), (path, m.shape, (h, w)))
    return m


def phase_tools(tmp: str, dev, rng) -> dict:
    """[tools]: gmr1_rach_gen and gmr1_gen_mat with their default device
    (the card): the RACH cfile holds 351 unit-magnitude symbols, and
    G @ u ^ g equals the FACCH3 encoder on the card for random u.
    Returns the kernel launches (the tools decode nothing)."""
    import torch

    from gmr1_tpu_torch.l1 import facch3
    from gmr1_tpu_torch.ops import bits as B
    from gmr1_tpu_torch.tools import gmr1_gen_mat, gmr1_rach_gen
    argv = ["--device", str(dev)]
    _zero_counts()
    out = os.path.join(tmp, "rach.cfile")
    payload = bytes(rng.integers(0, 256, 18, dtype=np.uint8)).hex()
    rc = gmr1_rach_gen.main([out, "0x05", payload] + argv)
    data = np.fromfile(out, np.complex64)
    _require(rc == 0 and len(data) == 351
             and np.allclose(np.abs(data[3:-3]), 1.0, atol=1e-5),
             ("gmr1_rach_gen", rc, len(data)))
    wd = os.path.join(tmp, "gen_mat")
    os.makedirs(wd)
    cwd = os.getcwd()
    os.chdir(wd)
    try:
        rc = gmr1_gen_mat.main(argv)
    finally:
        os.chdir(cwd)
    G, g = _pbm(os.path.join(wd, "mat_G.pbm")), _pbm(os.path.join(wd,
                                                              "mat_g.pbm"))
    _require(rc == 0 and G.shape == (384, 76) and g.shape == (384, 1),
             ("gmr1_gen_mat", rc, G.shape, g.shape))
    u = rng.integers(0, 2, (64, 76), dtype=np.uint8)
    e = facch3.encode(B.pack_bits(torch.as_tensor(u, device=dev), 10),
                      torch.zeros((64, 32), dtype=torch.uint8, device=dev))
    enc = gmr1_gen_mat.nonstatus_bits(e.cpu().numpy().astype(np.uint8))
    _require(np.array_equal((u.astype(np.int64) @ G.T.astype(np.int64)
                             + g[:, 0]) % 2, enc), "G @ u ^ g != encoder")
    launches = _counts()
    print(f"[tools] gmr1_rach_gen --device {dev}: 351 unit-magnitude RACH "
          f"symbols; gmr1_gen_mat --device {dev}: G (384 x 76) and g, G @ u "
          "^ g equal to the FACCH3 encoder on the card for 64 random u; "
          "kernel launches: " + ", ".join(f"{k} {v}" for k, v in
                                          launches.items()))
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from gmr1_tpu_torch import kernels
    except ImportError as e:
        print(f"chip_smoke: the gmr1_tpu_torch package is missing ({e})",
              file=sys.stderr)
        return 2

    # ---- 1. environment ----------------------------------------------
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    print(f"[env] {card}; {torch.cuda.get_device_name(0)} x"
          f"{torch.cuda.device_count()}; python {sys.version.split()[0]}, "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"nvcc {shutil.which('nvcc') or kernels._nvcc()}")

    # ---- 2. build ----------------------------------------------------
    t0 = time.perf_counter()
    per = kernels.build_all()
    print(f"[build] {', '.join(f'{k} {v:.1f} s' for k, v in per.items())}"
          f" ({time.perf_counter() - t0:.1f} s) into {kernels.BUILD_DIR}")

    # ---- 3-5. kernels vs their plain versions ------------------------
    rng = np.random.default_rng(0x5EED)
    n_car = 2 * (1088 // 2 - 12)          # the slice's live carriers
    if sys.argv[1:2] == ["--ab"]:
        phase_ab(sys.argv[2], rng, dev, n_car)
        return 0
    v_err, v_ms, v_plain, v_bound, v_by = phase_viterbi(rng, dev, n_car)
    p_err, p_ms, p_plain, p_bound, p_by, p_conv = phase_pfb(rng, dev)
    p_err = max(p_err, phase_pfb(rng, dev, PATHS_FS, need_nx=True)[0])
    for d in (2, 4):                      # a mesh shard's rows
        p_err = max(p_err, phase_pfb(rng, dev, r_cnt=2500 * F // d)[0])
    a_err, a_ms, a_plain, a_bound, a_by = phase_a5(rng, dev, n_car * F)

    # ---- 6-8. the per-carrier CLI, the wideband paths, the slice -----
    by_path = {}
    with tempfile.TemporaryDirectory() as tmp:
        by_path["carrier"], speech = phase_carrier(tmp, card)
        by_path["paths"] = phase_paths(tmp, card)
        by_path["slice"], sl = phase_slice(tmp, card)

        # ---- 9-10. the multi-device form, the channelizer CLI --------
        by_path["mesh"] = phase_mesh(card, sl, dev)
        phase_transponders(card, dev)
        by_path["split"] = phase_split(tmp, card, sl, dev)
        del sl

        # ---- 11-13. the last L1 coders, the vocoder, the tools -------
        by_path["l1"] = phase_l1(rng, dev, n_car)
        phase_codec(tmp, card, speech, dev)
        by_path["tools"] = phase_tools(tmp, dev, rng)

    def per(name):
        return dict(launches=sum(v[name] for v in by_path.values()),
                    launches_by_path={k: v[name] for k, v in by_path.items()})
    kern = [
        dict(name="viterbi", route="cuda",
             source="gmr1_tpu_torch/kernels/viterbi.cu",
             replaces="gmr1_tpu/ops/pallas_viterbi.py:152",
             **per("viterbi"), max_abs_err=v_err, ms=v_ms, plain_ms=v_plain,
             bound_ms=v_bound, bound_by=v_by, library_ms=None),
        dict(name="pfb_branch_filter", route="cuda",
             source="gmr1_tpu_torch/kernels/pfb.cu",
             replaces="gmr1_tpu/ops/pallas_pfb.py:109",
             **per("pfb"), max_abs_err=p_err, ms=p_ms, plain_ms=p_plain,
             bound_ms=p_bound, bound_by=p_by, library_ms=p_conv),
        dict(name="a5", route="cuda", source="gmr1_tpu_torch/kernels/a5.cu",
             replaces="gmr1_tpu/ops/a5.py:148",
             **per("a5"), max_abs_err=a_err, ms=a_ms, plain_ms=a_plain,
             bound_ms=a_bound, bound_by=a_by, library_ms=None),
    ]
    print(card)
    print(json.dumps({"kernels": kern}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
