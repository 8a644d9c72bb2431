#!/usr/bin/env python3
"""The check of one cell over many seeds in one process, with the control.

    python3 portbench/sweep.py --workload lband34.traffic \
        --seeds 808816518,7,11 [--fault NAME]

The workload is a cell of BENCHMARK.json, or CONFIG.TRAFFIC of the files
under portbench/configs and portbench/traffic.

For each seed: the cell's recordings, each through the receiver once,
judged as a benchmark run judges them, the channel bank's error against
the plain reference beside its control's (the same reference with fp8
DFT operands), and the carrier streams' error against the plain
resampler beside its control's (TF32 operands), and at a rate off the
grid the pre-resampled capture's error against the plain pre-resampler
beside its control's (TF32 operands).  Imports and the
kernels' build are paid once.  One JSON line a seed, with every wrong or
missed frame before it.
`--fault NAME` plants one of portbench/faults.py under every run (the
upper readings of the numbers compared); `--f32-dft` runs the receiver
with its float32 channel DFT (a witness beside the default bf16 one).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from portbench import faults  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    every_fault = {**faults.FAULTS, **faults.OFF_GRID_FAULTS}
    ap.add_argument("--fault", choices=sorted(every_fault))
    ap.add_argument("--f32-dft", action="store_true")
    args = ap.parse_args()
    import torch

    from portbench import check, harness, run, scene
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    if any(w["name"] == args.workload for w in bench["workloads"]):
        _cell, cfg, mix = run._cell(bench, args.workload)
    else:                      # CONFIG.TRAFFIC from their files
        conf, traffic = args.workload.split(".")
        with open(os.path.join(ROOT, "portbench", "configs",
                               conf + ".json")) as f:
            cfg = json.load(f)
        with open(os.path.join(ROOT, "portbench", "traffic",
                               traffic + ".json")) as f:
            mix = json.load(f)
    dev = torch.device("cuda", 0)
    fault = every_fault.get(args.fault)

    def hook(rx):
        if args.f32_dft:
            rx.chz.analyzer.dft_bf16 = False
        if fault is not None:
            fault(rx)
    warm = False
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        plans = [scene.plan(cfg, mix, seed, i)
                 for i in range(mix["recordings"])]
        h = harness.Harness(cfg, mix, seed, dev, plans=plans,
                            hook=hook)
        if not warm:
            h.warm_up()
            warm = True
        tot = dict(wrong=0, leaked=0, missed=0, unlocked=0, unjudged=0,
                   due=0)
        unsent, by_arfcn = [], {}
        errs, ctrl, walls, serr, sctrl, perr, pctrl = ([] for _ in range(7))
        for i in range(len(plans)):
            rec = h.run(i)
            walls.append(rec.wall)
            r = harness.judge(h, rec)
            for k in tot:
                tot[k] += r[k]
            unsent.append(r["unsent"])
            check.add_by_arfcn(by_arfcn, r["by_arfcn"])
            for line in check.rare_first(r["findings"],
                                         r["by_arfcn"])[:25]:
                print(f"seed {seed} rec {i}: {line}")
            errs.append(harness.bank_check(h, rec))
            ctrl.append(harness.bank_check(h, rec, fp8=True))
            serr.append(harness.stream_check(h, rec))
            sctrl.append(harness.stream_check(h, rec, tf32=True))
            perr.append(harness.pre_check(h, rec))
            pctrl.append(harness.pre_check(h, rec, tf32=True))
        pre = {} if perr[0] is None else dict(pre_err=max(perr),
                                              pre_err_tf32=min(pctrl))
        print(json.dumps(dict(seed=seed, fault=args.fault,
                              f32_dft=args.f32_dft,
                              **tot, unsent=sum(unsent),
                              unsent_rec=max(unsent),
                              bank_err=max(errs), bank_err_fp8=min(ctrl),
                              stream_err=max(serr),
                              stream_err_tf32=min(sctrl), **pre,
                              by_arfcn=by_arfcn, walls=walls,
                              seconds=time.perf_counter() - t0)),
              flush=True)
        del h
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
