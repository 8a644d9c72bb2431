"""The usrp3072 configuration, its three per-layer readers and the plain
reference of the wide carriers' stream, on the CPU.

  * the configuration states lband34's keys and the deployment's, its
    live range is the port's usable band, and its cell is one chip;
  * pre_ms_blk, pre_roofline and wide_ms_blk read None in lband34's
    contexts (its sections; a trace without rx.pre) and read an off-grid
    one: a traced run on tiny_offgrid for the two program spans, a
    chrome trace with rx.pre ranges for the roofline;
  * the roofline counts the resampler's work, without the program: its
    outputs a block, and as many taps an output as a row of the
    program's period matrix holds;
  * wide.py, which imports nothing of the program, against WideStreamer
    on tiny_offgrid: the synthesis from the rows the receiver fed it and
    from the plain bank of the on-grid samples, each far under its bf16
    control.
"""

import ast
import json
import os

import pytest
import torch

from gmr1_tpu_torch.channelizer.pfb import Channelizer
from portbench import harness, run, trace, widecheck

HERE = os.path.dirname(os.path.abspath(__file__))
PB = os.path.dirname(HERE)
ROOT = os.path.dirname(PB)
CPU = torch.device("cpu")
NEW = ("pre_ms_blk", "pre_roofline", "wide_ms_blk")
OFF_MIX = dict(recording_s=3.2, recordings=1, noise_sigma=0.01,
               lead_s=[0.04, 0.08], calls=False, speech_s=[0.4, 0.8],
               warmup_s=1.6)
torch.set_num_threads(2)


def _json(*path):
    with open(os.path.join(*path)) as f:
        return json.load(f)


def test_config_states_the_deployment():
    cfg = _json(PB, "configs", "usrp3072.json")
    lb = _json(PB, "configs", "lband34.json")
    assert set(lb) <= set(cfg)
    assert {k: cfg[k] for k in ("fs", "center_arfcn", "arfcns", "n_chans",
                                "taps_per_branch", "sps", "block_frames",
                                "beams", "beam2_every", "wide_channels")} \
        == dict(fs=30720000.0, center_arfcn=544, arfcns=[91, 997],
                n_chans=984, taps_per_branch=19, sps=4, block_frames=8,
                beams=2, beam2_every=4,
                wide_channels=[[694, 3], [294, 5]])
    assert {"band_rule", "source", "assumed", "guarantees"} <= set(cfg)
    assert {"band", "beam2_every", "noise", "carrier_power"} <= \
        set(cfg["assumed"])
    chz = Channelizer(cfg["fs"], cfg["band_base_hz"] + 31250.0
                      * cfg["center_arfcn"], need_nx=True)
    assert (chz.n_chans, chz.analyzer.p) == (cfg["n_chans"],
                                             cfg["taps_per_branch"])
    c, b = cfg["center_arfcn"], chz.band
    assert cfg["arfcns"] == [c - b, c + b]
    for a, w in cfg["wide_channels"]:       # inside, guards included
        assert c - b < a - w // 2 - 1 and a + w // 2 + 1 < c + b
    bench = _json(ROOT, "BENCHMARK.json")
    cell = next(w for w in bench["workloads"]
                if w["name"] == "usrp3072.control")
    assert (cell["config"], cell["traffic"], cell["chips"]) == \
        ("usrp3072", "control", 1)
    assert [m["name"] for m in run._per_layer(bench, cell)] == list(NEW)


def _ctx(prof, tr=None, cfg=None, counts=None):
    return dict(cfg=cfg or _json(PB, "configs", "usrp3072.json"), mix={},
                runs=2, iters=4, prof=prof, counts=counts or {}, trace=tr)


def _trace(tmp_path, pre_ranges):
    """A chrome trace of one block: rx.ingest holding rx.pre ranges, each
    with a kernel of 500 us launched inside it."""
    ev = [dict(ph="X", cat="user_annotation", name="rx.block", pid=1,
               tid=1, ts=0, dur=10000),
          dict(ph="X", cat="user_annotation", name="rx.ingest", pid=1,
               tid=1, ts=100, dur=9000)]
    for c, t in enumerate(pre_ranges):
        ev.append(dict(ph="X", cat="user_annotation", name="rx.pre", pid=1,
                       tid=1, ts=t, dur=50))
        ev.append(dict(ph="X", cat="cuda_runtime", name="cudaLaunchKernel",
                       pid=1, tid=1, ts=t + 10, dur=2,
                       args=dict(correlation=c)))
        ev.append(dict(ph="X", cat="kernel", name="sm80_xmma_gemm", pid=0,
                       tid=7, ts=t + 20, dur=500, args=dict(correlation=c)))
    path = tmp_path / "trace.json"
    path.write_text(json.dumps(dict(traceEvents=ev)))
    return trace.read(str(path))


@pytest.mark.parametrize("name", NEW)
def test_readers_none_on_the_grid(tmp_path, name):
    read = harness.load_readers([name])[name]
    lband = dict(phase=0.012, meta=0.002, dispatch=0.008, ingest=0.003,
                 walk=0.03, acquire=0.12)
    cfg = _json(PB, "configs", "lband34.json")
    assert read(_ctx(lband, _trace(tmp_path, []), cfg)) is None
    assert read(_ctx(lband, None, cfg)) is None


@pytest.mark.parametrize("name,want,zero", [
    ("pre_ms_blk", 20.0, dict(counts={"pre.blocks": 0})),
    ("wide_ms_blk", 50.0, dict(iters=0))])
def test_span_readers_read(name, want, zero):
    """pre over the blocks the pre-resampler made (5, the acquisition's
    among them), wide over the block-loop iterations (4)."""
    read = harness.load_readers([name])[name]
    prof = dict(pre=0.1, wide=0.2, ingest=0.15)
    ctx = _ctx(prof, counts={"pre.blocks": 5})
    assert read(ctx) == pytest.approx(want)
    assert read(dict(ctx, **zero)) is None


def _work():
    ns: dict = {}
    with open(os.path.join(PB, "metrics", "pre_roofline.py")) as f:
        exec(compile(f.read(), "pre_roofline.py", "exec"), ns)
    return ns["resample"]


def test_roofline_reads_its_ranges(tmp_path):
    """Two blocks' bound over the 1 ms their two rx.pre ranges
    launched."""
    from portbench import work
    read = harness.load_readers(["pre_roofline"])["pre_roofline"]
    want = 100.0 * work.bound_s(*_work()(30720000.0, 984, 8)) / 500e-6
    assert read(_ctx({}, _trace(tmp_path, [1000, 5000]))) == \
        pytest.approx(want)
    assert read(_ctx({}, _trace(tmp_path, []))) is None


@pytest.mark.parametrize("fs,m", [(30.72e6, 984), (1.92e6, 62)])
def test_roofline_counts_the_resampler(fs, m):
    """The reader counts n_out outputs a block, 2 x 2 (tpb + 1)
    operations each (pre.resample's weights an output; no row of the
    program's period matrix, mostly zero, holds more), and the block's
    raw samples, taps and outputs once each."""
    from portbench import pre
    p_out, k_in, w, _b = Channelizer(fs, 1525e6 + 31250 * 544) \
        .pre_resamp.periodic_geometry()
    tpb = -(-len(pre.taps(pre.ratio(fs, m))) // 32)
    assert (w != 0).sum(axis=1).max() <= tpb + 1 < w.shape[1] / 20
    n_out = 8 * 2500 * (m // 2)
    n_in = -(-n_out * k_in // p_out) + tpb
    assert _work()(fs, m, 8) == (8.0 * (n_in + n_out) + 4.0 * 32 * tpb,
                                 4.0 * n_out * (tpb + 1))


def _metrics():
    bench = _json(ROOT, "BENCHMARK.json")
    return [m for m in bench["per_layer"] if m["name"] in NEW]


def test_traced_run_reads_the_program_spans(monkeypatch):
    """A traced run off the grid on the CPU: the two program spans read
    (the CPU trace has no device activity, so the roofline does not).
    The tiny recording has fewer block-loop iterations than the cell's
    stretch, so the profiled stretch is moved to ones it has: the
    profiler then stops inside the run, as on the card."""
    cfg = _json(HERE, "tiny_offgrid.json")
    monkeypatch.setattr(run, "STRETCH", (1, 3))
    out, checks = run.measure(cfg, dict(OFF_MIX, recordings=2), 21, 0.5,
                              True, CPU, _metrics())
    assert not torch.autograd._profiler_enabled()
    assert out["device"]["window_s"] > 0
    got = out["metrics"]
    assert set(got) == {"pre_ms_blk", "wide_ms_blk"}
    assert got["pre_ms_blk"]["value"] > 0 and got["wide_ms_blk"]["value"] > 0
    assert checks["pre_err"][0] < checks["pre_err"][1]


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    return {n.module.split(".")[0] for n in ast.walk(tree)
            if isinstance(n, ast.ImportFrom) and n.module and not n.level} \
        | {a.name.split(".")[0] for n in ast.walk(tree)
           if isinstance(n, ast.Import) for a in n.names}


@pytest.mark.parametrize("path", ["wide.py", "metrics/pre_roofline.py"])
def test_references_stand_alone(path):
    assert "gmr1_tpu_torch" not in _imports(os.path.join(PB, path))


@pytest.fixture(scope="module")
def wide_lines():
    cfg = _json(HERE, "tiny_offgrid.json")
    return [line for seed in (808816518, 21)
            for line in widecheck.check(cfg, dict(OFF_MIX), seed, CPU)]


def test_wide_reference_holds_the_streamer(wide_lines):
    """WideStreamer within 2e-4 of the float64 synthesis (its float32
    rotation phase, up to 2 pi x 625 rad at width 3, costs 6-8e-5), from
    its own rows and from the on-grid samples; the bf16 control 1e-3 or
    more off."""
    assert len(wide_lines) == 2
    for line in wide_lines:
        assert (line["arfcn"], line["width"]) == (552, 3)
        assert line["synth_err"] < 2e-4 and line["grid_err"] < 2e-4
        assert line["synth_err_bf16"] > 1e-3
