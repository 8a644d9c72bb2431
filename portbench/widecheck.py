#!/usr/bin/env python3
"""Hold the receiver's wide-carrier streams to the plain reference
(wide.py), one recording a seed.

    python3 portbench/widecheck.py --workload usrp3072.control \
        --seeds 7,11 [--out wide.json]

For each seed: recording 0 of the cell through the receiver once; of
every wide carrier, OUTS outputs of its stream from a block drawn from
the seed (the busiest of 32 drawn windows), as WideStreamer made them,
against the float64 synthesis of
the bank rows the receiver fed it (`synth_err`: the synthesizer alone),
against the synthesis of the plain bank of the on-grid samples (`grid_err`:
the channel bank and the synthesizer; off the grid the on-grid samples
are the plain pre-resampler's, pre.py), and the control: the synthesis
of the receiver's rows with bf16 operands (`synth_err_bf16`); and the
rows the receiver fed it against that plain bank's (`rows_err`).  One JSON
line a seed and carrier.  Not a part of `correct`.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

OUTS = 512                 # outputs of a wide stream compared a carrier


def keep_block(b: int):
    """A receiver hook: each wide streamer keeps the subchannel rows it
    is fed in blocks b - 1 and b (the synthesis' history and its block)
    and its output chunk of block b, under ws.kept."""
    def hook(rx):
        for ws in rx._wide:
            ws.kept = {"rows": [], "calls": 0}
            orig = ws.feed

            def feed(bank_rows, ws=ws, orig=orig):
                out = orig(bank_rows)
                k = ws.kept
                if k["calls"] in (b - 1, b):
                    cols = bank_rows[ws.cols].cpu().double().numpy()
                    k["rows"].append(cols[..., 0] + 1j * cols[..., 1])
                if k["calls"] == b:
                    k["chunk"] = out[:, 0] + 1j * out[:, 1]
                k["calls"] += 1
                return out
            ws.feed = feed
    return hook


def compare(h, rx_wide, cfg: dict, b: int, rng) -> list:
    """One dict a wide carrier of the receiver whose streamers
    `rx_wide` kept block b (keep_block)."""
    from portbench import bank, pre, scene, wide
    m = cfg["n_chans"]
    r_b = cfg["block_frames"] * 2500
    x = h.recs[0]
    if scene.off_grid(cfg):
        read_grid = pre.reader(x, pre.ratio(cfg["fs"], m))
    else:
        def read_grid(lo, hi):
            seg = x[lo:hi].astype(np.float64)
            return seg[:, 0] + 1j * seg[:, 1]
    out = []
    for (arfcn, width), ws in zip(cfg["wide_channels"], rx_wide):
        k = ws.kept
        y = np.concatenate(k["rows"], axis=1)            # (W, 2 r_b)
        chunk = k["chunk"]
        n_out = chunk.shape[0]
        # a wide carrier sends 3 frames of 8: of 32 drawn windows, the one
        # with the most energy, so that the bank's bf16 rounding (of the
        # whole row, all carriers) is not read against a silent one
        starts = rng.integers(0, n_out - OUTS, 32)
        at = int(max(starts, key=lambda a: float(np.sum(
            np.abs(chunk[a:a + OUTS]) ** 2))))
        n = b * n_out + at + np.arange(OUTS)
        got = chunk[at:at + OUTS]
        subs, dfs = wide.offsets(arfcn, width)
        k0 = (b - 1) * r_b
        ref = wide.stream(y, k0, n, width, dfs, m)
        first, end = wide.rows_needed(n, width)
        hop, pm = m // 2, len(bank.prototype_nx(m))
        lo = max(first * hop - pm + 1, 0)
        grid = read_grid(lo, (end - 1) * hop + 1)
        cols = [(a - cfg["center_arfcn"]) % m for a in subs]
        yg = wide.rows(lambda a, e: grid[a - lo:e - lo], first, end, cols,
                       m, bank.prototype_nx(m))
        out.append(dict(
            arfcn=arfcn, width=width, block=b,
            rows_err=bank.rel_err(y[:, first - k0:end - k0], yg),
            synth_err=bank.rel_err(got, ref),
            grid_err=bank.rel_err(got, wide.stream(yg, first, n, width,
                                                   dfs, m)),
            synth_err_bf16=bank.rel_err(
                wide.stream(y, k0, n, width, dfs, m, bf16=True), ref)))
    return out


def check(cfg: dict, mix: dict, seed: int, dev) -> list:
    """Recording 0 of the seed through the receiver, its wide carriers
    compared at a block drawn from the seed."""
    from portbench import harness
    rng = np.random.default_rng([seed, 5])
    n_blocks = int(cfg["fs"] * mix["recording_s"]) \
        // (cfg["block_frames"] * 2500 * (cfg["n_chans"] // 2))
    b = int(rng.integers(2, max(3, n_blocks - 1)))
    kept = []

    def hook(rx):
        keep_block(b)(rx)
        kept.append(rx._wide)
    h = harness.Harness(cfg, dict(mix, recordings=1), seed, dev, hook=hook)
    h.run(0)
    return compare(h, kept[-1], cfg, b, rng)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--out")
    args = ap.parse_args()
    import torch

    from portbench import run
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    _cell, cfg, mix = run._cell(bench, args.workload)
    torch.set_num_threads(2)
    dev = torch.device("cuda", 0)
    lines = []
    for seed in (int(s) for s in args.seeds.split(",")):
        for line in check(cfg, mix, seed, dev):
            line["seed"] = seed
            print(json.dumps(line), flush=True)
            lines.append(line)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(lines, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
