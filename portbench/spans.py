#!/usr/bin/env python3
"""Where a block's time and the card's idle time go, read from the
program's own spans and counts (gmr1_tpu_torch.trace), on one card.

    python3 portbench/spans.py --workload lband34.control --seed 7 \
        --out chiprun_out/spans.json

Makes the cell's recordings from the seed and warms up as run.py does,
runs recording 0 once, then recording 1 four times in turns without and
with torch.profiler over run.py's stretch (block-loop iterations 4-9):
off, on, on, off.  Writes one JSON object to --out and prints it:

  * `walls_ms`: the stretch's iteration walls, profiler off and on;
  * `sections_ms`: the stretch's sections a block, off and on;
  * `rx`: trace.read's `rx` of the last profiled run, with `covered`, the
    share of the device's idle time from the first rx.block's start to
    the last one's end that lies inside a range below rx.block, and
    `pb_idle_gaps`, the same run's idle time by benchmark span;
  * `counts`: the burst windows decoded and read (rx.counts) a run;
  * `per_block`: rxtrace.per_block of that run and its counts;
  * `span_us`: the host cost of one span, profiler off and on (10^5).

Without a CUDA card it exits 2.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPANS = 100_000


def _keep(got: dict):
    """A harness hook that copies, when each receiver's run() returns
    and before the harness drops the receiver, its window counts, its
    iteration walls and its sections an iteration into `got`."""
    def hook(rx):
        orig = rx.run

        def run():
            orig()
            got.update(counts=dict(rx.counts), walls=list(rx.block_walls),
                       profs=list(rx.block_profs))
        rx.run = run
    return hook


def _stretch(got: dict, first: int, last: int) -> tuple[list, dict]:
    """(walls, summed sections) of the iterations that ran the process
    block calls first .. last - 1 (the profiled stretch)."""
    profs = got["profs"]
    its = [i for i, p in enumerate(profs) if "block" in p][first:last]
    secs: dict = {}
    for i in its:
        for k, v in profs[i].items():
            secs[k] = secs.get(k, 0.0) + v
    return [got["walls"][i] for i in its], secs


def span_cost(n: int = SPANS) -> dict:
    """Microseconds a span (a prof dict given) costs on the host, with
    no profiler and under torch.profiler's CPU and CUDA activities."""
    import torch

    from gmr1_tpu_torch.trace import span

    def loop():
        prof: dict = {}
        t = time.perf_counter()
        for _ in range(n):
            with span("cost", prof):
                pass
        return (time.perf_counter() - t) / n * 1e6
    off = loop()
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts):
        on = loop()
    return dict(off=off, on=on, spans=n)


def measure(cfg: dict, mix: dict, seed: int, dev, cache: str) -> dict:
    from portbench import harness, run, rxtrace, trace

    got: dict = {}
    h = harness.Harness(cfg, mix, seed, dev, hook=_keep(got))
    h.warm_up()
    h.run(0)
    first, last = run.STRETCH
    out: dict = dict(walls_ms=dict(off=[], on=[]),
                     sections_ms=dict(off=[], on=[]))
    for traced in (False, True, True, False):
        rec = h.run(1, run.STRETCH if traced else None)
        side = "on" if traced else "off"
        walls, secs = _stretch(got, first, last)
        out["walls_ms"][side].append([w * 1e3 for w in walls])
        out["sections_ms"][side].append(
            {k: v / len(walls) * 1e3 for k, v in sorted(secs.items())})
        out["counts"] = got["counts"]
        if not traced:
            continue
        st = rec.stretch
        st["restore"]()
        if "prof" not in st:
            continue
        path = os.path.join(cache, "spans_trace.json")
        os.makedirs(cache, exist_ok=True)
        st["prof"].export_chrome_trace(path)
        tr = trace.read(path)
        rx = tr.get("rx", {})
        os.remove(path)
        out["per_block"] = rxtrace.per_block(rx, got["counts"])
        if rx.get("blocks"):
            rx["covered"] = (rx["idle_s"]["block"]
                             - rx["idle_self_s"]["block"]) \
                / rx["idle_extent_s"]
        rx.pop("ranges", None)
        rx["pb_idle_gaps"] = tr.get("idle_gaps", [])
        rx["busy_s"], rx["host_s"] = tr.get("busy_s"), st["t1"] - st["t0"]
        out["rx"] = rx
    out["span_us"] = span_cost()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from portbench import run
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    _cell, cfg, mix = run._cell(bench, args.workload)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(run.CACHE, sub)
    import torch
    torch.set_num_threads(2)
    if not torch.cuda.is_available():
        print("portbench: a CUDA card is needed", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    out = measure(cfg, mix, args.seed, dev, run.CACHE)
    out["device"] = torch.cuda.get_device_name(dev)
    text = json.dumps(out)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
