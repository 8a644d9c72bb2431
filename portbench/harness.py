"""One run of one cell: recordings, warm-up, the measured window, the
check against the truth and the plain bank reference, and the metrics.

The system under test is gmr1_tpu_torch's `WidebandReceiver.run()`,
driven in-process over recordings replayed from host memory through a
`SampleSource` and a GSMTap sink of the benchmark's own, one recording
at a time, back to back (a closed loop: a user running the receiver over
a directory of captures).  Both log the host clock: the source when it
hands samples over, the sink when a frame comes out.
"""

from __future__ import annotations

import bisect
import contextlib
import importlib.util
import os
import sys
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from gmr1_tpu_torch.channelizer.arfcn import Channel
from gmr1_tpu_torch.rx.cfile import SampleSource
from gmr1_tpu_torch.rx.wideband import WidebandReceiver

from . import bank, check, pre, rrc, scene

BANK_ROWS = 128            # bank rows the reference recomputes a recording
STREAM_CHANS = 64          # carrier streams the reference recomputes ...
STREAM_OUTS = 512          # ... at this many samples each, a recording
PRE_OUTS = 8192            # pre-resampled samples it recomputes (off-grid):
PRE_JOIN = 4096            # this many straddle the start of a block
FORBIDDEN = ("jax", "jaxlib", "flax", "gmr1_tpu")
HERE = os.path.dirname(os.path.abspath(__file__))


class TimedSource(SampleSource):
    """A recording in host memory, handed over strictly forward; logs
    (samples handed over so far, host time) at every read."""

    def __init__(self, x: np.ndarray):
        self._x, self._pos = x, 0
        self.log: list[tuple[int, float]] = []

    def read(self, n: int) -> np.ndarray:
        out = self._x[self._pos:self._pos + n]
        self._pos += out.shape[0]
        self.log.append((self._pos, time.perf_counter()))
        return out


class TimedSink:
    """The GSMTap sink's interface: keeps each frame and its host time."""

    def __init__(self):
        self.sent: list = []

    def send(self, chan_type: int, fn: int, tn: int, l2, arfcn: int = 0):
        self.sent.append((arfcn, chan_type, fn, tn,
                          bytes(bytearray(l2)),
                          time.perf_counter()))


@dataclass
class Run:
    """What one recording's run left for the check and the metrics."""
    plan: scene.Plan
    n: int
    wall: float
    sent: list
    reads: list
    speech: dict
    locked: dict
    prof: dict
    iters: int
    counts: dict = field(default_factory=dict)      # rx.counts
    bank_rows: np.ndarray | None = None
    bank_b: int = 0
    bank_sel: np.ndarray | None = None
    stream_sel: np.ndarray | None = None    # (channels, outputs)
    stream_in: np.ndarray | None = None     # their bank rows, and history
    stream_out: np.ndarray | None = None    # their streams at the outputs
    pre_idx: np.ndarray | None = None       # pre-resampled samples kept
    pre_out: np.ndarray | None = None       # their values
    stretch: dict = field(default_factory=dict)


def _wrap(obj, name: str, before=None, after=None, span: str | None = None):
    """Replace obj.name (on the instance) by a call that runs `before`
    and `after` around it, inside a profiler span when `span` is given."""
    orig = getattr(obj, name)

    def call(*a, **k):
        if before is not None:
            before(*a)
        ctx = torch.profiler.record_function(span) if span else \
            contextlib.nullcontext()
        with ctx:
            out = orig(*a, **k)
        if after is not None:
            after(out, *a)
        return out
    setattr(obj, name, call)


SPANS = {"acquire": "pb.acquire", "_ingest_block": "pb.ingest",
         "_next_put_block": "pb.next_block", "_process_block": "pb.block",
         "_fetch_wait": "pb.fetch", "_walk_tch3_vec": "pb.walk_tch3",
         "_facch_collect": "pb.facch_collect",
         "_decode_facch": "pb.facch_decode", "_walk_facch": "pb.walk_facch",
         "_tch9_emit_main": "pb.tch9_emit", "_tch9_fix": "pb.tch9_fix"}


class Harness:
    """Recordings of one seed and the runs over them (see run.py)."""

    def __init__(self, cfg: dict, mix: dict, seed: int, dev: torch.device,
                 hook=None, plans: list | None = None):
        self.cfg, self.mix, self.seed, self.dev = cfg, mix, seed, dev
        # called with each fresh receiver: the faults of the tests and
        # sweep.py's witnesses; never in a benchmark run
        self.hook = hook
        self.plans = plans or [scene.plan(cfg, mix, seed, i)
                               for i in range(mix["recordings"])]
        self.recs = [scene.synthesize(p, mix["noise_sigma"], dev)
                     for p in self.plans]
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            torch.cuda.empty_cache()

    def receiver(self, x: np.ndarray, sink) -> tuple:
        """A fresh receiver over x, with the configuration's settings:
        `beams` and `wide_channels` ([[arfcn, width], ...]) where it
        states them, as the CLI's --beams and --wide ARFCNxW pass them."""
        src = TimedSource(x)
        p, cfg = self.plans[0], self.cfg
        opts = {}
        if "beams" in cfg:
            opts["beams"] = cfg["beams"]
        if "wide_channels" in cfg:
            opts["wide_channels"] = [Channel(a, width=w)
                                     for a, w in cfg["wide_channels"]]
        rx = WidebandReceiver(
            src, p.fs, p.center, sps=scene.SPS, sink=sink,
            h2d_dtype=cfg.get("h2d_dtype", "float32"), device=self.dev,
            **opts)
        if self.hook is not None:
            self.hook(rx)
        return rx, src

    def warm_up(self) -> None:
        """One run over the first warmup_s of recording 0: builds the
        kernels (nvcc on a checkout's first run) and reaches every path
        the window uses (acquisition, ingest, block phase, walks)."""
        n = int(self.mix["warmup_s"] * self.plans[0].fs)
        rx, _src = self.receiver(self.recs[0][:n], TimedSink())
        rx.run()
        self._sync()

    def _sync(self) -> None:
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def run(self, i: int, stretch: tuple | None = None) -> Run:
        """Recording i % recordings through a fresh receiver.  `stretch`
        (first, last block) profiles those block-loop iterations."""
        p, x = self.plans[i % len(self.plans)], self.recs[i % len(self.plans)]
        sink = TimedSink()
        rx, src = self.receiver(x, sink)
        rec = Run(plan=p, n=x.shape[0], wall=0.0, sent=sink.sent,
                  reads=src.log, speech={}, locked={}, prof={}, iters=0)
        self._bank_hooks(rx, rec, i)
        if stretch is not None:
            self._profile_hooks(rx, rec, stretch)
        t0 = time.perf_counter()
        rx.run()
        self._sync()
        rec.wall = time.perf_counter() - t0
        for c in rx.carriers:
            rec.locked[c.arfcn] = rec.locked.get(c.arfcn, 0) + 1
            if c.speech:
                rec.speech.setdefault(c.arfcn, []).extend(c.speech)
        rec.prof = dict(rx.prof)
        rec.counts = dict(rx.counts)
        rec.iters = len(rx.block_profs)
        # the wrappers (_wrap) hold the receiver in a reference cycle:
        # drop its attributes so that it, and its device tensors, go now
        # and not at a later collection (run.py freezes the heap)
        rx.__dict__.clear()
        return rec

    # --- the bank and the streams, captured for the references -------

    def _bank_hooks(self, rx, rec: Run, i: int) -> None:
        """Keep, from one block drawn from the seed, as the ingest step
        makes them and on the device until the window ends: BANK_ROWS rows
        of its bank; of STREAM_CHANS carriers, their bank rows (with the
        history the step carries) and their streams at STREAM_OUTS of the
        block's new samples; and, off the grid, PRE_OUTS samples of the
        step's input (the pre-resampler's output): PRE_JOIN around the
        block's start, where the tail the pre-resampler carries from the
        block before joins this block's geometry, and the rest from a
        drawn sample of the block on."""
        rng = np.random.default_rng([self.seed, i, 3])
        n_blocks = rec.n // rx.n_block
        rec.bank_b = int(rng.integers(min(2, n_blocks - 1),
                                      max(3, n_blocks - 2)))
        rec.bank_sel = np.sort(rng.choice(rx.R_b, BANK_ROWS, replace=False))
        m = self.cfg["n_chans"]
        s_b = self.cfg["block_frames"] * scene.FRAME4
        ch = np.sort(rng.choice(m, min(STREAM_CHANS, m), replace=False))
        outs = np.sort(rng.choice(s_b, STREAM_OUTS, replace=False))
        rec.stream_sel = (ch, outs)
        half, rest = PRE_JOIN // 2, PRE_OUTS - PRE_JOIN
        pre_at = int(rng.integers(half, rx.n_block - rest))
        off_grid = scene.off_grid(self.cfg)
        b0 = rec.bank_b * rx.n_block
        rec.pre_idx = np.concatenate([b0 + np.arange(-half, half),
                                      b0 + pre_at + np.arange(rest)])
        join = [None]                   # the end of the block before
        sel = torch.as_tensor(rec.bank_sel, device=self.dev)
        ch_t = torch.as_tensor(ch, device=self.dev)
        cur = [None]

        def before_ingest(b):
            cur[0] = b

        def after_ingest(_out, b):
            cur[0] = None

        def after_step(out, x, *state):
            if off_grid and cur[0] == rec.bank_b - 1:
                join[0] = x[-half:].clone()
            if cur[0] != rec.bank_b:
                return
            if off_grid:
                rec.pre_out = torch.cat([join[0], x[:half],
                                         x[pre_at:pre_at + rest]])
            stream, rows = out[0], out[1]
            rec.bank_rows = rows[:, sel].clone()
            rec.stream_in = torch.cat([state[1][ch_t], rows[ch_t]], 1)
            new = torch.as_tensor(stream.shape[1] - s_b + outs,
                                  device=self.dev)
            rec.stream_out = stream[ch_t][:, new].clone()
        _wrap(rx, "_ingest_block", before_ingest, after_ingest)
        _wrap(rx, "_step", after=after_step)

    # --- the profiled stretch (--trace 1) ---------------------------------

    def _profile_hooks(self, rx, rec: Run, stretch: tuple) -> None:
        from gmr1_tpu_torch.channelizer import pfb
        first, last = stretch
        for name, span in SPANS.items():
            _wrap(rx, name, span=span)
        st = rec.stretch
        st["calls"] = 0
        prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])

        def fns():
            return {id(c): (c.arfcn, c.cd.fn) for c in rx.carriers}

        def before(*_a):
            if st["calls"] == first:
                self._sync()
                st["fn0"] = fns()
                prof.start()
                st["t0"] = time.perf_counter()

        def after(_out, *_a):
            st["calls"] += 1
            if st["calls"] == last:
                self._sync()
                st["t1"] = time.perf_counter()
                prof.stop()
                st["fn1"] = fns()
                st["prof"] = prof
        _wrap(rx, "_process_block", before, after)
        orig = pfb.channel_dft

        def dft(*a, **k):
            with torch.profiler.record_function("pb.dft"):
                return orig(*a, **k)
        pfb.channel_dft = dft
        st["restore"] = lambda: setattr(pfb, "channel_dft", orig)


def bank_check(h: Harness, rec: Run, fp8: bool = False) -> float | None:
    """Relative RMS error of the captured bank rows against the plain
    reference (the fp8 control's, with fp8): the bank of the recording,
    or of its plain resampling onto the grid (pre.py) at a rate off it,
    with the perfect-reconstruction prototype where wide carriers are
    configured, the Hamming one otherwise."""
    if rec.bank_rows is None:
        return None
    m = h.cfg["n_chans"]
    proto = bank.prototype_nx(m) if h.cfg.get("wide_channels") \
        else bank.prototype(m)
    n_block = h.cfg["block_frames"] * 2500 * (m // 2)
    x = h.recs[h.plans.index(rec.plan)]
    if scene.off_grid(h.cfg):
        read = pre.reader(x, pre.ratio(h.cfg["fs"], m))
    else:
        def read(lo, hi):
            seg = x[lo:hi].astype(np.float64)
            return seg[:, 0] + 1j * seg[:, 1]
    z, ph = bank.fold(read, rec.bank_b * n_block, rec.bank_sel, m, proto)
    ref = bank.bank(z, ph)
    if fp8:
        return bank.rel_err(bank.bank_fp8(z, ph), ref)
    got = rec.bank_rows.cpu().double().numpy()            # (M, rows, 2)
    got = (got[..., 0] + 1j * got[..., 1]).T
    return bank.rel_err(got, ref)


def stream_check(h: Harness, rec: Run, tf32: bool = False) -> float | None:
    """Relative RMS error of the captured carrier streams against the
    plain resampler (rrc.py) of the bank rows the step resampled (the
    TF32 control's, with tf32)."""
    if rec.stream_out is None:
        return None
    ch, outs = rec.stream_sel
    y = rec.stream_in.cpu().double().numpy()
    y = y[..., 0] + 1j * y[..., 1]                         # (C, H + R_b)
    r_b = h.cfg["block_frames"] * 2500
    k0 = (rec.bank_b + 1) * r_b - y.shape[1]               # row of column 0
    n = rec.bank_b * h.cfg["block_frames"] * scene.FRAME4 + outs
    ref = rrc.streams(y, k0, n, 2 * scene.GRID, scene.SYM_RATE, scene.SPS)
    if tf32:
        got = rrc.streams(y, k0, n, 2 * scene.GRID, scene.SYM_RATE,
                          scene.SPS, tf32=True)
    else:
        got = rec.stream_out.cpu().double().numpy()
        got = got[..., 0] + 1j * got[..., 1]
    return bank.rel_err(got, ref)


def pre_check(h: Harness, rec: Run, tf32: bool = False) -> float | None:
    """Relative RMS error of the captured pre-resampled samples against
    the plain resampler (pre.py) of the recording (the TF32 control's,
    with tf32); None on the grid."""
    if rec.pre_out is None:
        return None
    x = h.recs[h.plans.index(rec.plan)]
    r = pre.ratio(h.cfg["fs"], h.cfg["n_chans"])
    ref = pre.resample(x, rec.pre_idx, r)
    if tf32:
        got = pre.resample(x, rec.pre_idx, r, tf32=True)
    else:
        got = rec.pre_out.cpu().double().numpy()
        got = got[:, 0] + 1j * got[:, 1]
    return bank.rel_err(got, ref)


def latencies(rec: Run) -> np.ndarray:
    """Seconds from the source handing over a frame's last sample to the
    sink receiving the frame, for every frame of the run, each on the
    timing of the carrier, beam or wide carrier that sent it."""
    cum = [c for c, _t in rec.reads]
    ts = [t for _c, t in rec.reads]
    p = rec.plan
    out = np.empty(len(rec.sent))
    for j, (a, t, fn, tn, _l2, t_send) in enumerate(rec.sent):
        end = int(np.ceil(p.frame_end_s(a, t, fn, tn) * p.fs))
        end = min(max(end, 1), rec.n)
        i = min(bisect.bisect_left(cum, end), len(ts) - 1)
        out[j] = t_send - ts[i]
    return out


def judge(h: Harness, rec: Run) -> dict:
    """Frames and speech against the truth (check.judge), and the lock of
    every seeded narrow carrier: as many carriers on each ARFCN as it has
    beams.  (A wide carrier's own receiver acquires it: its frames tell.)"""
    r = check.judge(rec.plan, [s[:5] for s in rec.sent], rec.speech)
    two = rec.plan.two_beams()
    r["unlocked"] = sum(max(0, 1 + (c.arfcn in two)
                            - rec.locked.get(c.arfcn, 0))
                        for c in rec.plan.carriers
                        if c.width == 1 and not c.beam)
    return r


def load_readers(names: list) -> dict:
    """Each per-layer metric's reader, portbench/metrics/<name>.py."""
    out = {}
    for name in names:
        path = os.path.join(HERE, "metrics", f"{name}.py")
        spec = importlib.util.spec_from_file_location(f"pb_metric_{name}",
                                                      path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        out[name] = mod.read
    return out


def forbidden_modules() -> list:
    """Top-level names of loaded modules that the port must not load."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def needed_bursts(rec: Run) -> dict:
    """{kind: count} of the bursts the stretch's traffic needed decoded:
    each seeded narrow ARFCN's bursts (both beams' where it has two) in
    the frames its carriers processed during the stretch (from the
    carriers' frame counters)."""
    st, p = rec.stretch, rec.plan
    span: dict = {}
    for key, (a, fn1) in st.get("fn1", {}).items():
        if key in st.get("fn0", {}):
            fn0 = st["fn0"][key][1]
            lo, hi = span.get(a, (fn0, fn1))
            span[a] = (min(lo, fn0), max(hi, fn1))
    counts: dict = {}
    for kind in ("bcch", "ccch", "speech", "facch3", "facch9", "csd"):
        n = 0
        for x in p.bursts[kind]:
            ci, k = x[0], x[1]
            a = p.carriers[ci].arfcn
            if a not in span or p.carriers[ci].width > 1:
                continue
            lo, hi = span[a]
            if kind == "csd":
                ks = p.fn_base + k + np.arange(len(x[3]))
                n += int(((ks >= lo) & (ks < hi)).sum())
            elif lo <= p.fn_base + k < hi:
                n += 1
        counts[kind] = n
    return counts
