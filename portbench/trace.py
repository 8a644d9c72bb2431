"""Read a torch.profiler chrome trace of a stretch of the window.

Device activity is every kernel, copy and memset on the trace's device
timeline.  A kernel belongs to a family by its name (the hand-written
kernels) or by the benchmark span its launch happened in (the channel
DFT's cast and product run inside the `pb.dft` span).  An idle gap is
labelled with the innermost `pb.*` span the host was in at the gap's
middle.  The program's own `rx.*` ranges are read beside them
(rxtrace.py) and handed over under the key `rx`.
"""

from __future__ import annotations

import bisect
import json

FAMILIES = {"P": ("branch_filter_kernel",),
            "V": ("vit_warp_kernel", "vit_bfly_kernel"),
            "A5": ("a5_kernel",)}
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _union(iv: list) -> list:
    out: list = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def read(path: str, t0_us: float | None = None,
         t1_us: float | None = None) -> dict:
    """Busy seconds, each family's device seconds and launches, the top
    device operations and the idle gaps by host span, over [t0, t1] (the
    trace's own extent where None); under `rx`, rxtrace's reading of the
    program's ranges (empty without them)."""
    from portbench import rxtrace      # which imports this module
    with open(path) as f:
        ev = json.load(f)["traceEvents"]
    dev = [e for e in ev if e.get("cat") in DEVICE_CATS and "dur" in e]
    spans = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in ev
                   if e.get("cat") == "user_annotation"
                   and str(e.get("name", "")).startswith("pb.")
                   and "dur" in e)
    launch = {e["args"]["correlation"]: e["ts"] for e in ev
              if e.get("cat") in ("cuda_runtime", "cuda_driver")
              and "correlation" in e.get("args", {})}
    if not dev:
        return {}
    lo = min(e["ts"] for e in dev) if t0_us is None else t0_us
    hi = max(e["ts"] + e["dur"] for e in dev) if t1_us is None else t1_us
    busy_iv = _union([(max(e["ts"], lo), min(e["ts"] + e["dur"], hi))
                      for e in dev if e["ts"] + e["dur"] > lo
                      and e["ts"] < hi])
    busy = sum(b - a for a, b in busy_iv)
    dft_spans = [(a, b) for a, b, n in spans if n == "pb.dft"]
    starts = [a for a, _b in dft_spans]

    def in_dft(e) -> bool:
        ts = launch.get(e.get("args", {}).get("correlation"))
        if ts is None:
            return False
        i = bisect.bisect_right(starts, ts) - 1
        return i >= 0 and ts <= dft_spans[i][1]

    fam = {k: [0.0, 0] for k in (*FAMILIES, "DFT")}
    by_name: dict[str, float] = {}
    for e in dev:
        if e["cat"] != "kernel":
            continue
        name = e["name"]
        d = e["dur"] * 1e-6
        by_name[name[:96]] = by_name.get(name[:96], 0.0) + d
        for k, names in FAMILIES.items():
            if any(n in name for n in names):
                fam[k][0] += d
                fam[k][1] += 1
        if in_dft(e):
            fam["DFT"][0] += d
            fam["DFT"][1] += 1
    gaps: dict[str, float] = {}
    prev = lo
    for a, b in busy_iv + [[hi, hi]]:
        if a > prev:
            mid = 0.5 * (a + prev)
            inner = [n for s0, s1, n in spans if s0 <= mid <= s1]
            label = inner[-1] if inner else "outside pb spans"
            gaps[label] = gaps.get(label, 0.0) + (a - prev) * 1e-6
        prev = max(prev, b)
    top = sorted(by_name.items(), key=lambda x: -x[1])[:10]
    return dict(busy_s=busy * 1e-6, window_s=(hi - lo) * 1e-6,
                families={k: tuple(v) for k, v in fam.items()},
                device_ops=[[n, s] for n, s in top],
                idle_gaps=sorted(([n, s] for n, s in gaps.items()),
                                 key=lambda x: -x[1])[:10],
                rx=rxtrace.from_events(ev))
