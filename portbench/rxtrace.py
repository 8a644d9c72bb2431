"""Read the program's own ranges (`rx.*`, gmr1_tpu_torch.trace) from a
torch.profiler chrome trace, beside the device timeline.

trace.read labels the device's idle time with the benchmark's `pb.*`
spans, and hands over under `rx` what this reader makes of the same
trace: it takes the `rx.*` ranges of the thread that holds `rx.block`
and sums, by range name, the kernels launched inside it, their device
seconds and the device's idle seconds inside it.  spans.py splits a
block's idle time by the program's sections with it, and per-layer
readers find it in their context's trace.
"""

from __future__ import annotations

import bisect
import json

from portbench.trace import DEVICE_CATS, FAMILIES, _union


def _busy_in(busy_iv: list, starts: list, a: float, b: float) -> float:
    """Device-busy microseconds inside [a, b] (busy_iv: sorted, disjoint,
    `starts` their starts)."""
    out = 0.0
    for i in range(max(bisect.bisect_right(starts, a) - 1, 0), len(busy_iv)):
        s, e = busy_iv[i]
        if s >= b:
            break
        out += max(0.0, min(e, b) - max(s, a))
    return out


def read(path: str) -> dict:
    """from_events of a chrome trace file."""
    with open(path) as f:
        return from_events(json.load(f)["traceEvents"])


def from_events(ev: list) -> dict:
    """The `rx.*` ranges of the thread that holds `rx.block` ([name
    without the prefix, start, end], microseconds) and, by range name:
    `launches` and `device_s`, the kernels whose launch lies inside one
    of its ranges and their device seconds; `idle_s`, the device's idle
    seconds inside its ranges; `idle_self_s`, those not inside a child
    range.  `blocks`: the `rx.block` ranges; `idle_extent_s`: the idle
    seconds from the first block's start to the last one's end;
    `families`: each family's [kernels, those launched inside an rx
    range, blocks with one launched inside `rx.dispatch`].  Empty where
    the trace has no `rx.block` or no device activity."""
    dev = [e for e in ev if e.get("cat") in DEVICE_CATS and "dur" in e]
    launch = {e["args"]["correlation"]: e["ts"] for e in ev
              if e.get("cat") in ("cuda_runtime", "cuda_driver")
              and "correlation" in e.get("args", {})}
    rx = [e for e in ev if e.get("cat") == "user_annotation"
          and str(e.get("name", "")).startswith("rx.") and "dur" in e]
    owner = {(e["pid"], e["tid"]) for e in rx if e["name"] == "rx.block"}
    if not owner or not dev:
        return {}
    busy_iv = _union([(e["ts"], e["ts"] + e["dur"]) for e in dev])
    ranges = sorted(((e["ts"], e["ts"] + e["dur"], e["name"][3:])
                     for e in rx if (e["pid"], e["tid"]) in owner),
                    key=lambda r: (r[0], -r[1]))
    starts = [a for a, _b in busy_iv]

    def idle(a, b):
        return (b - a) - _busy_in(busy_iv, starts, a, b)
    # each range's idle, less its direct children's (ranges nest)
    idle_s: dict[str, float] = {}
    self_s: dict[str, float] = {}
    stack: list = []
    own = []
    for k, (a, b, name) in enumerate(ranges):
        while stack and ranges[stack[-1]][1] <= a:
            stack.pop()
        v = idle(a, b)
        own.append(v)
        if stack:
            own[stack[-1]] -= v
        stack.append(k)
        idle_s[name] = idle_s.get(name, 0.0) + v * 1e-6
    for (_a, _b, name), v in zip(ranges, own):
        self_s[name] = self_s.get(name, 0.0) + v * 1e-6
    by_name: dict[str, list] = {}
    for a, b, name in ranges:
        by_name.setdefault(name, []).append((a, b))

    def inside(iv, ts) -> int:
        """Index of the range of sorted, disjoint `iv` holding ts, or -1."""
        i = bisect.bisect_right(iv, (ts, float("inf"))) - 1
        return i if i >= 0 and ts <= iv[i][1] else -1
    every = [tuple(r) for r in _union([(a, b) for a, b, _n in ranges])]
    blocks = by_name["block"]
    launches = {n: 0 for n in by_name}
    device_s = {n: 0.0 for n in by_name}
    fams = {k: [0, 0, set()] for k in FAMILIES}
    for e in dev:
        if e["cat"] != "kernel":
            continue
        ts = launch.get(e.get("args", {}).get("correlation"))
        if ts is None:
            continue
        for n, iv in by_name.items():
            if inside(iv, ts) >= 0:
                launches[n] += 1
                device_s[n] += e["dur"] * 1e-6
        for k, names in FAMILIES.items():
            if any(x in e["name"] for x in names):
                f = fams[k]
                f[0] += 1
                f[1] += inside(every, ts) >= 0
                if inside(by_name.get("dispatch", []), ts) >= 0:
                    f[2].add(inside(blocks, ts))
    return dict(ranges=[[n, a, b] for a, b, n in ranges],
                blocks=len(blocks), launches=launches, device_s=device_s,
                idle_s=idle_s, idle_self_s=self_s,
                idle_extent_s=idle(blocks[0][0], blocks[-1][1]) * 1e-6,
                families={k: [f[0], f[1], len(f[2])]
                          for k, f in fams.items()})


def per_block(rx: dict, counts: dict) -> dict:
    """From one profiled stretch's `rx` (read above) and a run's window
    counts (WidebandReceiver.counts): the block phase's kernels launched
    inside `rx.dispatch` a block, the device's idle ms inside the walks'
    ranges a block, the RRC window GEMM's device ms a block, and the
    share of the decoded burst windows that a walk read, %.  A figure
    whose source is missing is left out."""
    out: dict = {}
    n = rx.get("blocks")
    if n:
        if "dispatch" in rx["launches"]:
            out["dispatch_launches_blk"] = rx["launches"]["dispatch"] / n
        walks = ("walk", "walk_tch3", "facch", "tch9")
        if any(k in rx["idle_s"] for k in walks):
            out["idle_walk_ms_blk"] = sum(
                rx["idle_s"].get(k, 0.0) for k in walks) / n * 1e3
        if "resample" in rx["device_s"]:
            out["resample_dev_ms_blk"] = rx["device_s"]["resample"] / n * 1e3
    dec = sum(v for k, v in counts.items() if k.startswith("dec."))
    if dec:
        out["phase_useful_share"] = 100.0 * sum(
            v for k, v in counts.items() if k.startswith("read.")) / dec
    return out
