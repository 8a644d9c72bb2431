"""Smoke test of the PyTorch port (gmr1_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each fatal on failure (the script exits non-zero and prints no
result line):

  1. environment  card name and power limit (nvidia-smi), torch / CUDA
                  versions, nvcc; a CUDA device is required.
  2. build        both hand-written kernels from gmr1_tpu_torch/kernels/
                  into gmr1_tpu_torch/_build/.
  3. kernel V     Viterbi kernel vs its plain PyTorch version on the card:
                  K5_12 flush, K5_14 flush, TCH3_K7 and K9_13 tail-biting
                  at B=2048 seeded integer-sbit bursts, and K5_12 at the
                  receiver's CCCH batch; bits and metric exact.
  4. kernel P     PFB branch-filter kernel vs its plain version at the
                  34 MHz geometry (M=1088, P=10, R=20000): the channel
                  bank within rtol 2e-4 / atol 1e-4.
  5. slice        a synthetic 34 MHz L-band capture with every usable grid
                  channel live (FCCH every 8 frames, SI1 BCCH at k%8==2,
                  one CCCH burst at k%8==3, noise) through
                  WidebandReceiver(device="cuda").run(): every seeded ARFCN
                  acquired, every decoded BCCH/CCCH L2 bit-exact against
                  the synthesis truth, >= 3 SI1 frames per carrier, and
                  both kernels launched by the receiver.

The last three lines are the card's name and power limit, a JSON object
with each kernel's launches, error and times, and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
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


def build_stream(rng, n_frames: int):
    """One payload stream's 4-sps baseband + its truth {fn: l2}."""
    from gmr1_tpu_torch.l1 import bcch, ccch
    from gmr1_tpu_torch.ops import cplx
    from gmr1_tpu_torch.sdr import bursts as BU
    from gmr1_tpu_torch.sdr import fcch, modem

    bb = np.zeros(n_frames * FRAME4, np.complex64)

    def place(k, x1):
        xc = cplx.to_complex(x1)
        nsym = xc.shape[-1]
        t = np.arange(nsym * SPS)[:, None] / SPS - np.arange(nsym)[None, :]
        bb[k * FRAME4:k * FRAME4 + nsym * SPS] += xc @ _rc(t).astype(
            np.float32).T

    chirp = cplx.to_complex(fcch._chirp_np(fcch.FCCH, SPS, "dual")) \
        / np.sqrt(2)
    truth = dict(si1={}, ccch={})
    for k in range(n_frames):
        if k % 8 == 0:
            bb[k * FRAME4:k * FRAME4 + len(chirp)] += chirp
        elif k % 8 == 2:
            l2 = si1_l2(rng, F0 + k)
            truth["si1"][F0 + k] = bytes(l2)
            place(k, modem.mod(BU.BCCH, bcch.encode(l2)))
        elif k % 8 == 3:
            l2 = rng.integers(0, 256, 24, dtype=np.uint8)
            l2[1] = 0x00                        # not an IMM.ASS
            truth["ccch"][F0 + k] = bytes(l2)
            place(k, modem.mod(BU.DC6, ccch.encode(l2)))
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
    streams, truths = zip(*[build_stream(rng, content_blocks * F)
                            for _ in range(NS)])
    combs = []
    for s in range(NS):
        spec = np.zeros(m, np.complex128)
        for a in arfcns:
            if a % NS == s:
                spec[(a - CENTER_ARFCN) % m] = np.exp(2j * np.pi * rng.random())
        combs.append((np.fft.ifft(spec) * m).astype(np.complex64))
    grid = np.arange(streams[0].shape[0], dtype=np.float64)
    ratio = (23400.0 * SPS) / fs
    out = np.empty(((content_blocks + 1) * n_block, 2), np.float32)
    out[:n_block] = rng.standard_normal((n_block, 2)) * 0.01   # noise block
    for b in range(content_blocks):
        pos = (np.arange(n_block, dtype=np.float64) + b * n_block) * ratio
        wb = np.zeros(n_block, np.complex64)
        for s in range(NS):
            x = (np.interp(pos, grid, streams[s].real)
                 + 1j * np.interp(pos, grid, streams[s].imag))
            wb += x.astype(np.complex64) * np.tile(combs[s], n_block // m)
        blk = out[(b + 1) * n_block:(b + 2) * n_block]
        blk[:, 0] = wb.real
        blk[:, 1] = wb.imag
        blk += rng.standard_normal((n_block, 2)) * 0.01
    return out, center, {a: a % NS for a in arfcns}, truths


def verify_slice(rx, seeded: dict, truths) -> dict:
    """Every seeded ARFCN acquired; every decoded BCCH/CCCH L2 of a
    seeded carrier equals the truth at its fn; >= 3 SI1 (and CCCH)
    frames per carrier.  Returns counts."""
    from gmr1_tpu_torch.rx import gsmtap as gt

    found = {c.arfcn for c in rx.carriers}
    missing = sorted(set(seeded) - found)
    _require(not missing, f"seeded ARFCNs not acquired: {missing[:20]}")
    n_si1 = n_ccch = 0
    for car in rx.carriers:
        if car.arfcn not in seeded:
            continue
        tr = truths[seeded[car.arfcn]]
        got = {gt.GMR1_BCCH: 0, gt.GMR1_CCCH: 0}
        for t, fn, _tn, l2 in car.frames:
            want = tr["si1" if t == gt.GMR1_BCCH else "ccch"].get(fn)
            _require(want == l2, (car.arfcn, t, fn, l2.hex(), want))
            got[t] += 1
        _require(got[gt.GMR1_BCCH] >= 3 and got[gt.GMR1_CCCH] >= 3,
                 (car.arfcn, got))
        n_si1 += got[gt.GMR1_BCCH]
        n_ccch += got[gt.GMR1_CCCH]
    strays = [c for c in rx.carriers if c.arfcn not in seeded]
    return dict(carriers=len(rx.carriers), seeded=len(seeded),
                strays=len(strays),
                stray_frames=sum(len(c.frames) for c in strays),
                si1=n_si1, ccch=n_ccch)


def _cuda_ms(fn, iters: int) -> float:
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


def _trellis_case(code, t_steps: int, b: int, rng, dev):
    import torch

    from gmr1_tpu_torch.ops import conv as CV
    from gmr1_tpu_torch.ops import viterbi as VT
    _, _, sign = VT._acs_tables(code)
    in_len = t_steps - (code.k - 1 if code.term == CV.TERM_FLUSH else 0)
    bits = rng.integers(0, 2, (b, in_len), dtype=np.uint8)
    enc = CV.encode(code, torch.from_numpy(bits)).numpy()
    soft = np.where(enc > 0, -127.0, 127.0) + rng.normal(0, 40.0, enc.shape)
    soft = np.clip(np.round(soft), -127, 127).astype(np.float32)
    return (torch.as_tensor(soft.reshape(b, t_steps, code.n), device=dev),
            torch.as_tensor(sign.reshape(-1, code.n), device=dev),
            code.term == CV.TERM_FLUSH)


def phase_viterbi(rng, dev, ccch_batch: int):
    """Kernel V vs plain on the card; returns (max |err|, ms, plain ms)
    at the receiver's CCCH batch."""
    import torch

    from gmr1_tpu_torch.ops import conv as CV
    from gmr1_tpu_torch.ops import viterbi as VT
    cases = [(CV.K5_12, 212, 2048), (CV.K5_14, 100, 2048),
             (CV.TCH3_K7, 104, 2048),
             (CV.ConvCode("k9_13_tb", 9, CV.K9_13.polys,
                          term=CV.TERM_TAIL_BITING), 208, 2048),
             (CV.K5_12, 212, ccch_batch)]
    err, ms, plain_ms = 0.0, None, None
    for code, t_steps, b in cases:
        sym, sign, flush = _trellis_case(code, t_steps, b, rng, dev)
        kb, km = VT.decode_trellis(sym, sign, flush)
        pb, pm = VT.decode_trellis_plain(sym, sign, flush)
        torch.cuda.synchronize()
        nbad = int((kb != pb).sum())
        merr = float((km - pm).abs().max())
        print(f"[V] {code.name} B={b} T={t_steps} S={code.num_states}: "
              f"bit mismatches {nbad}, metric max|err| {merr}")
        _require(nbad == 0 and merr == 0.0, code.name)
        err = max(err, merr)
        ms = _cuda_ms(lambda: VT.decode_trellis(sym, sign, flush), 20)
        plain_ms = _cuda_ms(lambda: VT.decode_trellis_plain(sym, sign, flush),
                            3)
        print(f"[V]   kernel {ms:.4f} ms, plain {plain_ms:.3f} ms")
    return err, ms, plain_ms


def phase_pfb(rng, dev):
    """Kernel P vs plain at the 34 MHz geometry (the receiver's own
    prototype filter, seeded input); returns (max |err| of the bank,
    branch-filter ms, plain ms)."""
    import torch

    from gmr1_tpu_torch.channelizer import pfb
    ana = pfb.Channelizer(FS, 1525e6 + 31250 * CENTER_ARFCN).analyzer
    m, p, hop, r_cnt = ana.m, ana.p, ana.hop, 2500 * F
    _require((m, p) == (1088, 10), (m, p))
    x = torch.as_tensor(rng.normal(size=(r_cnt * hop + p * m, 2))
                        .astype(np.float32), device=dev)
    wa, dft, qpar = ana._tables(x.device)
    got = ana.block(x)                                   # kernel path
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
    ms = _cuda_ms(lambda: pfb.branch_filter(x, wa, r_cnt, hop), 20)
    plain_ms = _cuda_ms(lambda: pfb.branch_filter_plain(x, wa, r_cnt, hop), 5)
    block_ms = _cuda_ms(lambda: ana.block(x), 5)
    print(f"[P]   branch filter kernel {ms:.4f} ms, plain {plain_ms:.3f} ms; "
          f"whole analysis block (kernel + f32 DFT) {block_ms:.3f} ms")
    return err, ms, plain_ms


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from gmr1_tpu_torch import kernels
        from gmr1_tpu_torch.channelizer.pfb import branch_filter
        from gmr1_tpu_torch.ops.viterbi import decode_trellis
        from gmr1_tpu_torch.rx.wideband import WidebandReceiver
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

    # ---- 3-4. kernels vs their plain versions --------------------------
    rng = np.random.default_rng(0x5EED)
    span = 1088 // 2 - 12
    v_err, v_ms, v_plain = phase_viterbi(rng, dev, 6 * 2 * span)
    p_err, p_ms, p_plain = phase_pfb(rng, dev)

    # ---- 5. the slice ------------------------------------------------
    t0 = time.perf_counter()
    wb, center, seeded, truths = synthesize(FS, CONTENT_BLOCKS)
    print(f"[slice] synthesized {wb.shape[0] / 1e6:.1f} Msamples "
          f"({wb.shape[0] / FS:.2f} s at {FS / 1e6:.0f} MHz, "
          f"{len(seeded)} live carriers) in {time.perf_counter() - t0:.1f} s")
    rx = WidebandReceiver(wb, FS, center, sps=SPS, device="cuda")
    decode_trellis.launches = 0
    branch_filter.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n_frames = rx.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(viterbi=decode_trellis.launches,
                    pfb=branch_filter.launches)
    counts = verify_slice(rx, seeded, truths)
    t_acq = rx.prof["acquire"]
    print(f"[slice] carriers found {counts['carriers']} "
          f"(seeded {counts['seeded']}, false-FCCH strays "
          f"{counts['strays']} with {counts['stray_frames']} frames); "
          f"frames decoded {n_frames}: SI1 {counts['si1']}, CCCH "
          f"{counts['ccch']}, all bit-exact")
    print(f"[slice] acquire {t_acq:.2f} s, block loop {wall - t_acq:.2f} s, "
          f"{len(rx.block_walls)} blocks; wideband "
          f"{wb.shape[0] / wall / 1e6:.2f} Msamples/s vs real time "
          f"{FS / 1e6:.0f} ({card}); sections "
          + ", ".join(f"{k} {v:.2f} s" for k, v in rx.prof.items()))
    for name, n in launches.items():
        _require(n > 0, f"the receiver never launched the {name} kernel")

    kern = [
        dict(name="viterbi", route="cuda",
             source="gmr1_tpu_torch/kernels/viterbi.cu",
             replaces="gmr1_tpu/ops/pallas_viterbi.py:152",
             launches=launches["viterbi"], max_abs_err=v_err, ms=v_ms,
             plain_ms=v_plain),
        dict(name="pfb_branch_filter", route="cuda",
             source="gmr1_tpu_torch/kernels/pfb.cu",
             replaces="gmr1_tpu/ops/pallas_pfb.py:109",
             launches=launches["pfb"], max_abs_err=p_err, ms=p_ms,
             plain_ms=p_plain),
    ]
    print(card)
    print(json.dumps({"kernels": kern}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
