"""The harness on the CPU at a tiny grid: the generator's truth against
the program's own decode, the plain bank reference against the program's
analysis, the last line's keys, and a measured run refusing to start
without a card."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from gmr1_tpu_torch.channelizer import filters
from gmr1_tpu_torch.channelizer.pfb import Channelizer
from portbench import bank, check, harness, rrc, run, scene

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

torch.set_num_threads(2)
CPU = torch.device("cpu")


@pytest.mark.parametrize("seed", [808816518, 4000000001])
def test_truth_against_decode(tiny, seed):
    cfg, mix = tiny
    h = harness.Harness(cfg, mix, seed, CPU)
    rec = h.run(0)
    r = harness.judge(h, rec)
    assert (r["wrong"], r["missed"], r["unlocked"]) == (0, 0, 0), \
        r["findings"][:10]
    assert r["due"] > 250
    assert harness.bank_check(h, rec) < 1e-5       # the CPU bank is f32
    assert harness.stream_check(h, rec) < 1e-6
    # the controls read far above their limits
    assert harness.bank_check(h, rec, fp8=True) > 3 * run.LIMITS["bank_err"]
    assert harness.stream_check(h, rec, tf32=True) > 3 * run.LIMITS[
        "stream_err"]


def test_judge_counts_faults(tiny):
    cfg, mix = tiny
    p = scene.plan(cfg, mix, 3, 0)
    def soft(t, pay):          # DKABs come out as soft bits, 1 negative
        if t != scene.DKAB:
            return pay
        b = np.frombuffer(pay, np.uint8)
        return np.where(b, -100, 100).astype(np.int8).tobytes()
    sent = [(a, t, fn, 0, soft(t, pay))
            for (a, t, fn), (pay, due) in p.frames.items() if due]
    ok = check.judge(p, sent, p.speech)
    assert (ok["wrong"], ok["missed"]) == (0, 0)
    # five BCCH frames a frame late: five missed, five sent at an fn
    # where nothing of theirs was sent; one on a stray ARFCN
    late = [s for s in sent if s[1] == scene.BCCH][:5]
    bad = [(a, t, fn + 1, tn, pay) for a, t, fn, tn, pay in late]
    r = check.judge(p, [s for s in sent if s not in late] + bad, p.speech)
    assert (r["wrong"], r["unsent"], r["missed"]) == (0, 5, 5)
    a, t, fn, tn, pay = late[0]
    stray = max(c.arfcn for c in p.carriers) + 3
    r = check.judge(p, sent + [(stray, t, fn, tn, pay)], p.speech)
    assert (r["leaked"], r["unsent"], r["missed"]) == (1, 0, 0)
    r = check.judge(p, sent + [(a + 1, t, fn, tn, pay)], p.speech)
    assert (r["wrong"], r["missed"]) == (1, 0)
    r = check.judge(p, sent, {a: v[1:] for a, v in p.speech.items()})
    assert r["wrong"] > 0 and r["missed"] > 0


def test_bank_reference():
    chz = Channelizer(2e6, 1525e6 + 31250 * 544, sps=4)
    ana = chz.analyzer
    m, hop, p = ana.m, ana.hop, ana.p
    h = bank.prototype(m)
    assert len(h) == p * m
    rng = np.random.default_rng(1)
    x = rng.standard_normal(20000) + 1j * rng.standard_normal(20000)
    s0, r_cnt = 40 * m, 100
    blk = np.concatenate([x[s0 - p * m:s0], x[s0:s0 + r_cnt * hop]])
    y = ana.block(torch.as_tensor(np.stack([blk.real, blk.imag], -1),
                                  dtype=torch.float32)).double().numpy()
    rows = np.array([0, 3, 50, 99])
    z, ph = bank.fold(lambda lo, hi: x[lo:hi], s0, rows, m, h)
    ref = bank.bank(z, ph)
    assert bank.rel_err(y[rows, :, 0] + 1j * y[rows, :, 1], ref) < 1e-6
    # the control: fp8 operands read far above the limit
    assert bank.rel_err(bank.bank_fp8(z, ph), ref) > 3 * run.LIMITS[
        "bank_err"]


def test_result_keys(tiny):
    cfg, mix = tiny
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    out, checks = run.measure(cfg, mix, 11, 0.5, False, CPU, [])
    assert out["correct"] is True
    assert {"correct", "attempted", "failed", "metrics", "device"} \
        <= set(out)
    assert set(out["metrics"]) == {m["name"] for m in bench["end_to_end"]}
    assert set(checks) == {"wrong", "leaked", "missed", "unlocked",
                           "unsent_rec", "bank_err", "stream_err"}
    assert set(out["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}


def test_refuses_without_card():
    if torch.cuda.is_available():
        pytest.skip("a card is here")
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "lband34.control", "--seed", "1", "--seconds", "1"],
                       cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout == ""


@pytest.mark.card
def test_cell_on_card(card):
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "lband34.control", "--seed", "5", "--seconds", "2"],
                       cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-2000:]
    assert json.loads(p.stdout.strip().splitlines()[-1])["correct"]


def test_rrc_reference():
    """The plain resampler against the program's own on a random bank
    column: the same taps and the same outputs (float32)."""
    chz = Channelizer(2e6, 1525e6 + 31250 * 544, sps=4)
    rs = chz._rrc_resampler(1)
    h = rrc.taps(2 * scene.GRID, scene.SYM_RATE)
    assert np.abs(h - filters.root_raised_cosine(
        32.0, 32.0 * 2 * scene.GRID, scene.SYM_RATE, 0.35,
        int(11.0 * 32 * 2 * scene.GRID / scene.SYM_RATE))).max() < 1e-6
    rng = np.random.default_rng(2)
    y = rng.standard_normal((3, 4000)) + 1j * rng.standard_normal((3, 4000))
    got = rs(torch.as_tensor(np.stack([y.real, y.imag], -1),
                             dtype=torch.float32)).double().numpy()
    n = np.arange(60, got.shape[1], 7)
    ref = rrc.streams(y, 0, n, 2 * scene.GRID, scene.SYM_RATE, scene.SPS)
    assert bank.rel_err(got[:, n, 0] + 1j * got[:, n, 1], ref) < 1e-6
    ctl = rrc.streams(y, 0, n, 2 * scene.GRID, scene.SYM_RATE, scene.SPS,
                      tf32=True)
    assert bank.rel_err(ctl, ref) > 3 * run.LIMITS["stream_err"]
