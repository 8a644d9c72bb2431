#!/usr/bin/env python3
"""The benchmark of gmr1_tpu_torch's wideband receiver on one card.

    python3 portbench/run.py --workload lband34.traffic --seed 7 \
        --seconds 40 --trace 0

Reads the cell from BENCHMARK.json, its configuration from the file the
configuration names, its traffic mix from portbench/traffic/<traffic>.json
and each per-layer metric's reader from portbench/metrics/<name>.py.  From
the seed it makes the mix's recordings on the card (portbench/scene.py),
runs the receiver once over the start of the first (set-up ends there),
then replays the recordings through a fresh `WidebandReceiver.run()`
each, back to back, until --seconds have passed (the window holds whole
recordings).  With --trace 1 the block-loop iterations 4-9 of the
window's second recording run under torch.profiler, and the line carries
the per-layer metrics instead of the end-to-end ones; each reader gets
the context `context` builds.  Once the window has closed it judges
every recording's frames against the truth, and a sample of the channel
bank and of the carrier streams against the plain references (bank.py,
rrc.py) and, at a rate off the grid, one of the pre-resampled capture
(pre.py), prints the numbers
compared with their limits on standard error and, as the last line of
standard output, one JSON object.  Without a CUDA card it exits 2 and
prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

# one process with few threads: the receiver's host work is Python and
# small numpy; pools of idle threads only add noise on a shared host
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_var, "2")

import numpy as np  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "portbench")
CACHE = os.path.join(ROOT, ".pbcache")
STRETCH = (4, 10)          # profiled block-loop iterations, --trace 1

# checks: limits set from the readings in PERF.md (section 2)
LIMITS = {"wrong": 0, "leaked": 0, "missed": 0, "unlocked": 0,
          "unsent_rec": 10, "bank_err": 0.01, "stream_err": 5e-6,
          "pre_err": 5e-6}
EXACT = ("wrong", "leaked", "missed", "unlocked")


def _cell(bench: dict, name: str) -> tuple[dict, dict, dict]:
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    with open(os.path.join(ROOT, conf["file"])) as f:
        cfg = json.load(f)
    with open(os.path.join(HERE, "traffic", cell["traffic"] + ".json")) as f:
        mix = json.load(f)
    return cell, cfg, mix


def _per_layer(bench: dict, cell: dict) -> list:
    """The per-layer metrics the cell reports: listed for it, or listed
    for no cell and moving an end-to-end metric it reports."""
    e2e = {m["name"] for m in bench["end_to_end"]
           if cell["name"] in m.get("workloads", [cell["name"]])}
    return [m for m in bench["per_layer"]
            if (cell["name"] in m["workloads"] if "workloads" in m
                else m["moves"] in e2e)]


def context(cfg: dict, mix: dict, runs: list) -> dict:
    """What every per-layer reader is handed: the configuration and the
    mix, the window's recordings and block-loop iterations, and their
    `prof` sections and `counts` (the receivers' rx.counts), summed."""
    def total(key):
        dicts = [getattr(r, key) for r in runs]
        return {k: sum(d.get(k, 0) for d in dicts)
                for k in set().union(*dicts)}
    return dict(cfg=cfg, mix=mix, runs=len(runs),
                iters=sum(r.iters for r in runs), prof=total("prof"),
                counts=total("counts"))


def measure(cfg: dict, mix: dict, seed: int, seconds: float, traced: bool,
            dev, metrics: list, hook=None) -> tuple[dict, dict]:
    """One run: (result fields, checks {name: (value, limit)}); `hook`
    (tests only) is handed each fresh receiver."""
    import torch

    from portbench import check, harness, scene, trace

    t = time.perf_counter()
    h = harness.Harness(cfg, mix, seed, dev, hook=hook)
    t1 = time.perf_counter()
    h.warm_up()
    print(f"portbench: imports {t - T_START:.2f} s, recordings "
          f"{t1 - t:.2f} s, warm-up {time.perf_counter() - t1:.2f} s",
          file=sys.stderr)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    runs = []
    # the harness's own objects (plans, truths, earlier runs' results) go
    # to the permanent generation: the collector then scans the
    # receiver's objects only, as it would without the benchmark
    gc.collect()
    gc.freeze()
    t0 = time.perf_counter()
    setup_s = t0 - T_START
    while True:
        i = len(runs)
        runs.append(h.run(i, STRETCH if traced and i == 1 else None))
        gc.freeze()
        if time.perf_counter() - t0 >= seconds and (len(runs) > 1
                                                     or not traced):
            break
    window_s = time.perf_counter() - t0
    gc.unfreeze()
    print(f"portbench: window {window_s:.2f} s, {len(runs)} recordings, "
          f"walls {[round(r.wall, 3) for r in runs]}", file=sys.stderr)
    peak = int(torch.cuda.max_memory_allocated(dev)) \
        if dev.type == "cuda" else 0

    # ---- the check, after the window -----------------------------------
    n = dict(wrong=0, leaked=0, missed=0, unlocked=0, unjudged=0, due=0)
    unsent = []
    lat, errs, serrs, perrs, findings = [], [], [], [], []
    by_arfcn: dict = {}
    for rec in runs:
        r = harness.judge(h, rec)
        for k in n:
            n[k] += r[k]
        unsent.append(r["unsent"])
        findings += r["findings"]
        check.add_by_arfcn(by_arfcn, r["by_arfcn"])
        lat.append(harness.latencies(rec))
        e = harness.bank_check(h, rec)
        if e is not None:
            errs.append(e)
        e = harness.stream_check(h, rec)
        if e is not None:
            serrs.append(e)
        e = harness.pre_check(h, rec)
        if e is not None:
            perrs.append(e)
    for line in check.rare_first(findings, by_arfcn)[:40]:
        print(f"finding: {line}", file=sys.stderr)
    for kind, per in sorted(by_arfcn.items()):
        print(f"findings {kind} by ARFCN: {dict(sorted(per.items()))}",
              file=sys.stderr)
    checks = {k: (n[k], LIMITS[k]) for k in EXACT}
    checks["unsent_rec"] = (max(unsent), LIMITS["unsent_rec"])
    checks["bank_err"] = (max(errs) if errs else float("inf"),
                          LIMITS["bank_err"])
    checks["stream_err"] = (max(serrs) if serrs else float("inf"),
                            LIMITS["stream_err"])
    if scene.off_grid(cfg):
        checks["pre_err"] = (max(perrs) if perrs else float("inf"),
                             LIMITS["pre_err"])
    out = dict(correct=all(v <= lim for v, lim in checks.values()),
               attempted=n["due"],
               failed=n["wrong"] + n["leaked"] + n["missed"],
               unsent=sum(unsent), unjudged=n["unjudged"],
               recordings=len(runs))
    dev_d = dict(platform="gpu" if dev.type == "cuda" else dev.type,
                 kind=torch.cuda.get_device_name(dev) if dev.type == "cuda"
                 else "cpu", count=1, memory_peak_bytes=peak)
    if not traced:
        # a run that emits no frame at all waits the whole window
        lat_all = np.concatenate(lat + [np.zeros(0)])
        if not len(lat_all):
            lat_all = np.array([window_s])
        out["metrics"] = dict(
            msps=dict(value=sum(r.n for r in runs) / window_s / 1e6,
                      unit="Msamples/s"),
            frame_lat_p95_ms=dict(value=float(np.percentile(lat_all, 95))
                                  * 1e3, unit="ms"),
            setup_s=dict(value=setup_s, unit="s"))
    else:
        rec = runs[1]
        st = rec.stretch
        st["restore"]()
        ctx = context(cfg, mix, runs)
        if "prof" in st:
            path = os.path.join(CACHE, "trace.json")
            os.makedirs(CACHE, exist_ok=True)
            st["prof"].export_chrome_trace(path)
            tr = trace.read(path)
            os.remove(path)
            tr["window_s"] = st["t1"] - st["t0"]
            tr["bursts"] = harness.needed_bursts(rec)
            ctx["trace"] = tr
            dev_d.update(busy_s=tr.get("busy_s", 0.0),
                         window_s=tr["window_s"])
            out["breakdown"] = dict(device_ops=tr.get("device_ops", []),
                                    idle_gaps=tr.get("idle_gaps", []))
        readers = harness.load_readers([m["name"] for m in metrics])
        out["metrics"] = {}
        for m in metrics:
            v = readers[m["name"]](ctx)
            if v is not None:
                out["metrics"][m["name"]] = dict(value=float(v),
                                                 unit=m["unit"])
    out["device"] = dev_d
    return out, checks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cell, cfg, mix = _cell(bench, args.workload)
    # every cache at a fixed place inside the checkout
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(CACHE, sub)
    import torch
    torch.set_num_threads(2)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: {cell['chips']} CUDA card(s) needed, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    dev = torch.device("cuda", 0)
    out, checks = measure(cfg, mix, args.seed, args.seconds,
                          bool(args.trace), dev, _per_layer(bench, cell))
    from portbench import harness
    bad = harness.forbidden_modules()
    if bad:
        print(f"portbench: modules loaded that the port must not load: "
              f"{bad}", file=sys.stderr)
        return 3
    out["checks"] = {k: dict(value=v, limit=lim)
                     for k, (v, lim) in checks.items()}
    for k, (v, lim) in checks.items():
        print(f"check {k} {v} limit {lim}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
