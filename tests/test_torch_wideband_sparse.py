"""The block phase's traffic half on a sub-batch: gmr1_tpu_torch's
WidebandReceiver runs TCH3, NT9, A5 and the CSD chain only on the carrier
slots that hold a TCH3 or TCH9 channel at the block boundary (`t` of the
block meta), and the control half on every slot.  On the CPU, against
gmr1_tpu's WidebandReceiver (which runs every slot) on 500 kHz captures
of three seeded carriers:

  * `control`: BCCH and CCCH only.  The same frames; no TCH3 or NT9
    window decoded and no traffic half run;
  * `e2e`: tests/test_wideband.py's story on one carrier, two idle
    ones.  The same frames, speech and CSD; on every block `t` is the
    slots with a traffic channel at its start, and the rings outside it
    come out of the phase bitwise as they went in;
  * `early`: the IMM.ASS, the FACCH3 ASS.CMD.1 and the first CSD bursts
    in the block before the carrier's slot first joins `t`, so the CSD
    chain's correction (`_chain_fix`) runs on the rings that phase left
    as they were;
  * `two_calls`: a call on each of two carriers, one a group of a split
    mesh (Mesh(["cpu"] * 2)): each group's traffic rows follow the
    previous groups' in the fetched results, and the FACCH3 soft bits
    are read from each group's own sub-batch.  The same CRC-protected
    frames and speech, and the calls' CSD: the mesh moves the bank rows
    in bf16, so the noise an idle TCH9 slot decodes to CSD (no CRC) may
    differ from gmr1_tpu's single device, as it did before the
    sub-batch.

Beside them, `_phase_block` itself on random streams and rings: a
sub-batch (and each carrier group's, as a split mesh fetches them) gives
the rows of the full batch, and rings outside it stay as they were;
and `device_block_time` with and without a traffic half.
"""

import numpy as np
import pytest
import torch

from gmr1_tpu.l1 import ccch
from gmr1_tpu.l1 import tch3 as jtch3
from gmr1_tpu.rx import gsmtap as gt
from gmr1_tpu.rx.wideband import WidebandReceiver as JRx
from gmr1_tpu.sdr import bursts as BU
from gmr1_tpu.sdr import modem
from gmr1_tpu_torch.l1 import tch9
from gmr1_tpu_torch.ops.interleave import InterleaverState
from gmr1_tpu_torch.parallel import Mesh
from gmr1_tpu_torch.rx import wideband as twb
from gmr1_tpu_torch.rx.wideband import WidebandReceiver as TRx

from tests.test_receiver import Capture, imm_ass_l2
from tests.test_torch_wideband_traffic import (ass_cmd_1_l2, e2e_capture,
                                               place_csd, place_facch3)
from tests.test_wideband import (A_AUX, A_BCCH, A_FULL, CENTER, FS,
                                 fill_bcch, mix_wideband)

torch.set_num_threads(2)

SPS = 4
CPU = torch.device("cpu")
CRC_TYPES = (gt.GMR1_BCCH, gt.GMR1_CCCH, gt.GMR1_TCH3 | gt.GMR1_FACCH,
             gt.GMR1_TCH9 | gt.GMR1_FACCH)
TRAFFIC_KEYS = ("et", "dk_bits", "dk_found", "bt", "f_sid", "s_f0", "s_f1",
                "sid9", "l2f9", "badf9", "l2a")


def control_capture():
    rng = np.random.default_rng(0xC0DE)
    caps = {a: Capture(rng, n_frames=28, noise=0.005)
            for a in (A_BCCH, A_FULL, A_AUX)}
    for a in caps:
        fill_bcch(caps[a], rng)
    return mix_wideband({a: c.buf for a, c in caps.items()}, rng)


def early_capture():
    """IMM.ASS (TN 10) at frame 1, the ASS.CMD.1 to TN 13 over frames
    2-5 (burst b at the frame whose fn % 4 is b, as the receivers group
    them), five CSD bursts from frame 6: TCH9 starts inside the
    carrier's first block.  Returns (capture, CSD payloads)."""
    rng = np.random.default_rng(0xFA57)
    caps = {a: Capture(rng, n_frames=28, noise=0.005)
            for a in (A_BCCH, A_FULL, A_AUX)}
    for a in caps:
        fill_bcch(caps[a], rng)
    cap = caps[A_FULL]
    tn, tn9 = 10, 13
    cap.place_syms(1, 0, np.asarray(modem.mod(
        BU.DC6, ccch.encode(imm_ass_l2(rng, tn, 9)))))
    place_facch3(cap, tn, ass_cmd_1_l2(rng, tn9), (4, 5, 2, 3))
    csd = place_csd(cap, rng, tn9, range(6, 11))
    return mix_wideband({a: c.buf for a, c in caps.items()}, rng), csd


def two_calls_capture():
    """The e2e story's IMM.ASS, speech, FACCH3 ASS.CMD.1 and CSD train on
    A_FULL and on A_AUX, each its own payloads.  Returns (capture, {arfcn:
    (speech frames, CSD payloads)})."""
    rng = np.random.default_rng(0x7C0)
    caps = {a: Capture(rng, n_frames=28, noise=0.005)
            for a in (A_BCCH, A_FULL, A_AUX)}
    for a in caps:
        fill_bcch(caps[a], rng)
    truth = {}
    for a in (A_FULL, A_AUX):
        cap = caps[a]
        cap.place_syms(3, 0, np.asarray(modem.mod(
            BU.DC6, ccch.encode(imm_ass_l2(rng, 10, 9)))))
        speech = []
        for k in (4, 5, 6):
            f0, f1 = (rng.integers(0, 256, 10, dtype=np.uint8)
                      for _ in range(2))
            speech += [bytes(f0), bytes(f1)]
            cap.place_syms(k, 10, np.asarray(modem.mod(
                BU.NT3_SPEECH, jtch3.encode(f0, f1, np.zeros(4, np.uint8)))))
        place_facch3(cap, 10, ass_cmd_1_l2(rng, 13), (8, 9, 10, 11))
        truth[a] = (speech, place_csd(cap, rng, 13, range(12, 17)))
    return mix_wideband({a: c.buf for a, c in caps.items()}, rng), truth


def _run(wb, **kw):
    """Both receivers on wb (gmr1_tpu's on one device); the port's every
    block recorded: its meta, the slots with a traffic channel at its
    start (read off the carriers before the meta is built), and each
    phase's traffic rows and rings in and out; and the TCH9 corrections,
    with the block they ran in."""
    mesh = kw.pop("mesh", None)
    jrx = JRx(wb, FS, CENTER, sps=SPS, **kw)
    jrx.run()
    rx = TRx(wb, FS, CENTER, sps=SPS, device="cpu", mesh=mesh, **kw)
    rec = dict(metas=[], want_t=[], phases=[], fixes=[])
    build = rx._build_meta

    def build_meta(active_ids, f_cnt):
        rec["want_t"].append([
            i for i, c in enumerate(rx.carriers) if id(c) in active_ids
            and (c.cd.tch3.active or c.cd.tch9.active)])
        m = build(active_ids, f_cnt)
        rec["metas"].append(m)
        return m
    rx._build_meta = build_meta
    fix = rx._tch9_fix

    def tch9_fix(fix9, resets, slot, il_prev, f_cnt):
        rec["fixes"].append((len(rec["metas"]) - 1,
                             [slot[id(c)] for c in fix9]))
        return fix(fix9, resets, slot, il_prev, f_cnt)
    rx._tch9_fix = tch9_fix
    phase = twb._phase_block

    def phase_block(streams, m, il, *args):
        pre = (il.buf.clone(), il.n.clone())
        small, big = phase(streams, m, il, *args)
        il2 = big["il2"]
        rec["phases"].append(dict(
            tr=m["tr"], pre=pre, post=(il2.buf.clone(), il2.n.clone()),
            same=il2 is il, keys=set(small)))
        return small, big
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(twb, "_phase_block", phase_block)
        rx.run()
    return dict(jrx=jrx, rx=rx, **rec)


@pytest.fixture(scope="module")
def control():
    return _run(control_capture())


@pytest.fixture(scope="module")
def e2e():
    wb, truth = e2e_capture()
    return dict(_run(wb), truth=truth)


@pytest.fixture(scope="module")
def early():
    wb, csd = early_capture()
    return dict(_run(wb), csd=csd)


@pytest.fixture(scope="module")
def two_calls():
    wb, truth = two_calls_capture()
    return dict(_run(wb, arfcns=[A_FULL, A_AUX], mesh=Mesh(["cpu"] * 2)),
                truth=truth)


def _outputs(rx):
    return rx.frames, [(c.arfcn, c.speech, c.csd) for c in rx.carriers]


@pytest.mark.parametrize("name", ["control", "e2e", "early"])
def test_same_frames_speech_csd(request, name):
    run = request.getfixturevalue(name)
    assert _outputs(run["rx"]) == _outputs(run["jrx"])
    assert len(run["rx"].frames) >= 9


def test_control_only_runs_no_traffic_half(control):
    c = control["rx"].counts
    assert c["dec.tch3"] == c["dec.nt9"] == c["phase.traffic_slots"] == 0
    assert c["phase.slots"] == sum(len(m["rows"]) for m in control["metas"])
    assert control["phases"]
    for ph in control["phases"]:
        assert ph["tr"] is None and ph["same"]
        assert not ph["keys"] & set(TRAFFIC_KEYS)


@pytest.mark.parametrize("name", ["e2e", "early"])
def test_t_is_the_slots_with_traffic(request, name):
    run = request.getfixturevalue(name)
    rx = run["rx"]
    full = [i for i, c in enumerate(rx.carriers) if c.arfcn == A_FULL]
    got = [m["t"].tolist() for m in run["metas"]]
    assert got == run["want_t"]
    assert got[0] == [] and full in got
    assert all(t in ([], full) for t in got)
    assert rx.counts["phase.traffic_slots"] == sum(map(len, got))
    for m in run["metas"]:
        want = np.full(len(m["rows"]), -1)
        want[m["t"]] = np.arange(len(m["t"]))
        assert m["trow"].tolist() == want.tolist()
    # one phase a block: its traffic rows are those of `t`
    assert len(run["phases"]) == len(got)
    for ph, t, m in zip(run["phases"], got, run["metas"]):
        if not t:
            assert ph["tr"] is None
        else:
            assert ph["tr"]["rows"].tolist() == m["rows"][t].tolist()
            assert set(TRAFFIC_KEYS) <= ph["keys"]


@pytest.mark.parametrize("name", ["control", "e2e", "early"])
def test_rings_outside_t_unchanged(request, name):
    run = request.getfixturevalue(name)
    assert len(run["phases"]) == len(run["metas"])
    for ph, m in zip(run["phases"], run["metas"]):
        out = np.setdiff1d(np.arange(len(m["rows"])), m["t"])
        (b0, n0), (b1, n1) = ph["pre"], ph["post"]
        assert torch.equal(b1[out], b0[out]) and torch.equal(n1[out], n0[out])
        assert ph["same"] == (m["t"].size == 0)


def test_e2e_traffic_decoded(e2e):
    rx, truth = e2e["rx"], e2e["truth"]
    car = next(c for c in rx.carriers if c.arfcn == A_FULL)
    assert car.speech == truth["speech"]
    # depth-3 interleave: the first three payloads decode, in order
    assert [p for p in car.csd if p in truth["csd"]] == truth["csd"][:3]
    assert rx.counts["read.tch3"] > 0 and rx.counts["read.nt9"] > 0


def test_split_mesh_two_calls(two_calls):
    """Both carriers' calls decode, each in its group: a phase a group a
    block, its traffic half on its own slot once the call is up."""
    rx, jrx = two_calls["rx"], two_calls["jrx"]
    assert len(rx._groups()) == 2

    def crc(r):
        return [f for f in r.frames if f[1] in CRC_TYPES]
    assert crc(rx) == crc(jrx)
    assert {gt.GMR1_TCH3 | gt.GMR1_FACCH} <= {f[1] for f in crc(rx)}
    for a, (speech, csd) in two_calls["truth"].items():
        car = next(c for c in rx.carriers if c.arfcn == a)
        assert car.speech == next(c for c in jrx.carriers
                                  if c.arfcn == a).speech
        assert car.speech[:6] == speech
        assert [p for p in car.csd if p in csd] == csd[:3]
    ts = [m["t"].tolist() for m in two_calls["metas"]]
    assert ts[0] == [] and [0, 1] in ts
    sizes = [0 if ph["tr"] is None else len(ph["tr"]["rows"])
             for ph in two_calls["phases"]]
    assert sizes == [n for t in ts for n in (int(0 in t), int(1 in t))]


def test_chain_fix_on_a_slot_outside_t(early):
    """The ASS.CMD.1 lands in a block whose phase ran no traffic half:
    the correction chain starts the slot's ring there, and the CSD
    continues through the next blocks' sub-batches."""
    rx = early["rx"]
    full = [i for i, c in enumerate(rx.carriers) if c.arfcn == A_FULL]
    fixed = [(b, slots) for b, slots in early["fixes"] if slots == full]
    assert fixed
    b = fixed[0][0]
    assert early["metas"][b]["t"].size == 0 and early["phases"][b]["same"]
    car = rx.carriers[full[0]]
    assert [p for p in car.csd if p in early["csd"]] == early["csd"][:3]


# --- _phase_block on random streams and rings --------------------------

N_SLOTS, F_CNT = 6, 8


def _random_block(rng, t):
    """A host block meta of N_SLOTS slots with traffic slots t (TCH9 up
    on some of them, never outside), random streams and rings."""
    ns = 12 * 936 * SPS
    n = N_SLOTS
    a9 = np.isin(np.arange(n), t) & (rng.random(n) < 0.7)
    fn0 = rng.integers(0, 1 << 20, n)
    flags = a9.astype(np.int64) | (rng.integers(0, 2, n) << 1) \
        | (rng.integers(0, 1 << F_CNT, n) << 16)
    m = dict(
        rows=rng.permutation(8)[:n].astype(np.int64),
        freq=rng.normal(0, 1e-3, n).astype(np.float32), fn0=fn0,
        p=rng.integers(0, 20, n), flags=flags,
        idx_b=rng.integers(0, ns, (n, 1)), idx_c=rng.integers(0, ns, (n, 6)),
        idx_t=rng.integers(0, ns, (n, F_CNT)),
        idx_9=rng.integers(0, ns, (n, F_CNT)),
        t=np.asarray(t, np.int64))
    streams = torch.from_numpy(rng.normal(0, 1, (8, ns, 2)).astype(
        np.float32))
    il = InterleaverState(
        buf=torch.from_numpy(rng.normal(0, 4, (
            n, tch9.INTER_DEPTH, tch9.INTER_WIDTH)).astype(np.float32)),
        n=torch.from_numpy(rng.integers(0, 9, n)))
    return m, streams, il


def _sub_il(il, lo, hi):
    return InterleaverState(buf=il.buf[lo:hi], n=il.n[lo:hi])


@pytest.fixture(scope="module")
def bare_rx():
    return TRx(np.zeros((16, 2), np.float32), FS, CENTER, sps=SPS,
               device="cpu")


@pytest.mark.parametrize("t,groups", [
    ([1, 3, 4], [(0, 6)]),
    ([1, 3, 4], [(0, 3), (3, 6)]),      # both groups a sub-batch
    ([0, 1, 2], [(0, 3), (3, 6)]),      # one group whole, one without
    ([5], [(0, 3), (3, 6)]),            # the first group without
])
def test_sub_batch_gives_the_full_batch_rows(bare_rx, t, groups):
    rng = np.random.default_rng(sum(t) * 7 + len(groups))
    m, streams, il = _random_block(rng, t)
    kc = np.arange(8, dtype=np.uint8)
    full_m = dict(m, t=np.arange(N_SLOTS))
    full, fbig = twb._phase_block(streams, bare_rx._meta_dev(full_m, CPU),
                                  il, kc, SPS)
    assert bare_rx._meta_dev(full_m, CPU)["tr"]["slots"] is None
    smalls, bigs = [], []
    for lo, hi in groups:
        small, big = twb._phase_block(
            streams, bare_rx._meta_dev(m, CPU, lo, hi), _sub_il(il, lo, hi),
            kc, SPS)
        smalls.append(small)
        bigs.append(big)
    res = bare_rx._fetch_wait(bare_rx._fetch_start(smalls))
    for k, v in full.items():
        want = v.numpy() if k not in TRAFFIC_KEYS else v.numpy()[t]
        np.testing.assert_array_equal(res[k], want, err_msg=k)
    feb = torch.cat([b["f_ebits"] for b in bigs if "f_ebits" in b])
    assert torch.equal(feb, fbig["f_ebits"][t])
    # the rings: T's rows advanced as in the full batch, the others (no
    # TCH9 there) untouched in both
    buf2 = torch.cat([b["il2"].buf for b in bigs])
    n2 = torch.cat([b["il2"].n for b in bigs])
    assert torch.equal(buf2, fbig["il2"].buf) and torch.equal(n2,
                                                              fbig["il2"].n)
    out = np.setdiff1d(np.arange(N_SLOTS), t)
    assert torch.equal(buf2[out], il.buf[out]) and torch.equal(n2[out],
                                                               il.n[out])
    assert (fbig["il2"].n[t] != il.n[t]).any() or not m["flags"][t].any()
    # a correction chain on a slot outside t: into the sub-batch's
    # post-block ring (the pre-block ring itself where a group ran no
    # traffic half), as into the full batch's
    s = int(out[0])
    j = next(j for j, (lo, hi) in enumerate(groups) if lo <= s < hi)
    lo, hi = groups[j]
    e9 = torch.from_numpy(rng.normal(0, 3, (1, F_CNT, 662)).astype(
        np.float32))
    ks = torch.from_numpy(rng.integers(0, 2, (1, F_CNT, 658)).astype(
        np.uint8))
    fix = torch.tensor([[s, 1, 0b01111000]])
    want, wl2a = twb._chain_fix(il, fbig["il2"], fix, e9, ks)
    prev = _sub_il(il, lo, hi)
    if "f_ebits" not in bigs[j]:
        prev = bigs[j]["il2"]           # the very pre-block ring
    got, gl2a = twb._chain_fix(prev, bigs[j]["il2"],
                               fix - torch.tensor([[lo, 0, 0]]), e9, ks)
    assert torch.equal(gl2a, wl2a)
    assert torch.equal(got.buf, want.buf[lo:hi])
    assert torch.equal(got.n, want.n[lo:hi])


def test_phase_without_traffic_half(bare_rx):
    rng = np.random.default_rng(5)
    m, streams, il = _random_block(rng, [])
    dev = bare_rx._meta_dev(m, CPU)
    assert dev["tr"] is None and set(dev) == {"rows", "freq", "idx_b",
                                              "idx_c", "tr"}
    small, big = twb._phase_block(streams, dev, il, np.zeros(8, np.uint8),
                                  SPS)
    assert big == dict(il2=il)
    assert set(small) == {"l2b", "badb", "toab", "ferrb", "eb", "l2c",
                          "badc", "ec"}


def test_device_block_time_with_and_without_traffic(e2e):
    rx = e2e["rx"]
    empty = next(m for m in e2e["metas"] if not m["t"].size)
    busy = next(m for m in e2e["metas"] if m["t"].size)
    last = rx._last_meta
    seen = []
    phase = twb._phase_block

    def phase_block(streams, m, *args):
        seen.append(m["tr"] is not None)
        return phase(streams, m, *args)
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(twb, "_phase_block", phase_block)
            for meta, traffic in ((empty, False), (busy, True)):
                rx._last_meta = meta
                seen.clear()
                t = rx.device_block_time(iters=1)
                assert isinstance(t, float) and t > 0.0
                assert seen == [traffic] * 2     # the warm call and one
    finally:
        rx._last_meta = last
