"""The readers of the program's own spans and counts, on a synthetic
chrome trace and synthetic contexts: trace.read gives the keys it has
always given, with the same values, on a trace that holds `rx.*` ranges,
and rxtrace's reading of them under `rx`; rxtrace.read sums launches,
device time and idle time by range (idle time that straddles a range's
edge included); each new reader gives its value, or None without what
it reads; and a reader sees the window's summed counts."""

import json

import pytest

from portbench import harness, run, rxtrace, trace

US = 1e-6
# name, start, end (microseconds); the program's ranges on thread 1
RX = [("block", 10, 990), ("phase", 20, 400), ("meta", 20, 60),
      ("dispatch", 60, 390), ("ingest", 400, 600), ("step", 420, 580),
      ("resample", 500, 570), ("fetch", 600, 700), ("walk", 700, 800),
      ("walk_tch3", 800, 850), ("tch9", 850, 980)]
PB = [("pb.block", 0, 1000), ("pb.ingest", 100, 300), ("pb.dft", 150, 200)]
# kernel name, launch time, device start, device end
KERNELS = [("vit_warp_kernel", 100, 120, 220), ("a5_kernel", 150, 220, 260),
           ("branch_filter_kernel", 430, 440, 500),
           ("sm80_xmma_gemm_f32f32", 510, 510, 560),
           ("elementwise_kernel", 5, 680, 720)]


def _trace(tmp_path, rx=RX):
    ev = [dict(ph="X", cat="user_annotation", name=n, pid=1, tid=1, ts=a,
               dur=b - a) for n, a, b in PB]
    ev += [dict(ph="X", cat="user_annotation", name="rx." + n, pid=1, tid=1,
                ts=a, dur=b - a) for n, a, b in rx]
    # another thread's range is not the block loop's
    ev.append(dict(ph="X", cat="user_annotation", name="rx.walk", pid=1,
                   tid=2, ts=0, dur=1000))
    for c, (n, t, a, b) in enumerate(KERNELS):
        ev.append(dict(ph="X", cat="cuda_runtime", name="cudaLaunchKernel",
                       pid=1, tid=1, ts=t, dur=2, args=dict(correlation=c)))
        ev.append(dict(ph="X", cat="kernel", name=n, pid=0, tid=7, ts=a,
                       dur=b - a, args=dict(correlation=c)))
    ev.append(dict(ph="X", cat="gpu_memcpy", name="Memcpy DtoH", pid=0,
                   tid=8, ts=750, dur=10, args={}))
    path = tmp_path / "trace.json"
    path.write_text(json.dumps(dict(traceEvents=ev)))
    return str(path)


# what trace.read gives on this trace, to the last bit
OLD = {"busy_s": 0.0003, "window_s": 0.0006399999999999999,
       "families": {"P": (5.9999999999999995e-05, 1),
                    "V": (9.999999999999999e-05, 1),
                    "A5": (3.9999999999999996e-05, 1),
                    "DFT": (3.9999999999999996e-05, 1)},
       "device_ops": [["vit_warp_kernel", 9.999999999999999e-05],
                      ["branch_filter_kernel", 5.9999999999999995e-05],
                      ["sm80_xmma_gemm_f32f32", 4.9999999999999996e-05],
                      ["a5_kernel", 3.9999999999999996e-05],
                      ["elementwise_kernel", 3.9999999999999996e-05]],
       "idle_gaps": [["pb.block", 0.0003399999999999999]]}


@pytest.mark.parametrize("rx", [RX, []], ids=["rx_ranges", "no_rx_ranges"])
def test_trace_read_ignores_rx_ranges(tmp_path, rx):
    path = _trace(tmp_path, rx=rx)
    got = trace.read(path)
    assert got.pop("rx") == rxtrace.read(path)
    assert got == OLD


def test_rx_sums(tmp_path):
    rx = rxtrace.read(_trace(tmp_path))
    assert rx["blocks"] == 1
    assert [r[0] for r in rx["ranges"]] == [n for n, _a, _b in RX]
    assert rx["launches"] == dict(block=4, phase=2, meta=0, dispatch=2,
                                  ingest=2, step=2, resample=1, fetch=0,
                                  walk=0, walk_tch3=0, tch9=0)
    dev = rx["device_s"]
    assert dev["dispatch"] == pytest.approx(140 * US)
    assert dev["step"] == pytest.approx(110 * US)
    assert dev["resample"] == pytest.approx(50 * US)
    assert dev["block"] == pytest.approx(250 * US)
    idle = dict(block=680, phase=240, meta=40, dispatch=190, ingest=90,
                step=50, resample=20, fetch=80, walk=70, walk_tch3=50,
                tch9=130)
    assert rx["idle_s"] == pytest.approx({k: v * US for k, v in idle.items()})
    own = dict(idle, block=20, phase=10, ingest=40, step=30)
    assert rx["idle_self_s"] == pytest.approx(
        {k: v * US for k, v in own.items()})
    assert rx["idle_extent_s"] == pytest.approx(680 * US)
    assert rx["families"] == dict(P=[1, 1, 0], V=[1, 1, 1], A5=[1, 1, 1])


def test_rx_empty_without_block(tmp_path):
    assert rxtrace.read(_trace(tmp_path, rx=[])) == {}


COUNTS = {"dec.bcch": 10, "dec.ccch": 60, "dec.tch3": 80, "dec.nt9": 80,
          "read.bcch": 10, "read.ccch": 60, "read.tch3": 0, "read.nt9": 0}
PER_BLOCK = dict(dispatch_launches_blk=2.0, idle_walk_ms_blk=0.25,
                 resample_dev_ms_blk=0.05,
                 phase_useful_share=100.0 * 70 / 230)


def test_per_block(tmp_path):
    got = rxtrace.per_block(rxtrace.read(_trace(tmp_path)), COUNTS)
    assert got == pytest.approx(PER_BLOCK)


@pytest.mark.parametrize("counts", [COUNTS, {}], ids=["counts", "none"])
def test_per_block_leaves_out_missing(tmp_path, counts):
    """Without rx ranges, or without counts, their figures are left out."""
    got = rxtrace.per_block(rxtrace.read(_trace(tmp_path, rx=[])), counts)
    assert set(got) == ({"phase_useful_share"} if counts else set())


def _ctx(tmp_path, prof):
    return dict(cfg={}, mix={}, runs=2, iters=4, prof=prof,
                trace=trace.read(_trace(tmp_path)))


WANT = dict(meta_ms_blk=0.5, dispatch_ms_blk=2.0)
PROF = dict(phase=0.012, meta=0.002, dispatch=0.008)


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_value(tmp_path, name):
    read = harness.load_readers([name])[name]
    assert read(_ctx(tmp_path, PROF)) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_none_without_its_source(tmp_path, name):
    """A program without the sections these metrics read: a traced run
    over it leaves them out."""
    read = harness.load_readers([name])[name]
    assert read(_ctx(tmp_path, dict(phase=0.012))) is None
    assert read(dict(_ctx(tmp_path, PROF), iters=0)) is None


def test_reader_sees_counts():
    """run.context, which every reader is handed, sums the window's
    receivers' counts (Run.counts, a copy of rx.counts) and sections."""
    runs = [harness.Run(plan=None, n=0, wall=0.0, sent=[], reads=[],
                        speech={}, locked={}, prof=dict(PROF), iters=4,
                        counts=dict(COUNTS, **{"phase.slots": s}))
            for s in (7, 9)]
    ctx = run.context({}, {}, runs)
    assert ctx["counts"] == {k: 2 * v for k, v in COUNTS.items()} | {
        "phase.slots": 16}
    assert (ctx["runs"], ctx["iters"]) == (2, 8)
    assert ctx["prof"] == pytest.approx({k: 2 * v for k, v in PROF.items()})

    def read(c):       # a reader of counts, as a later metric's would be
        return c["counts"]["read.ccch"] / c["counts"]["dec.ccch"]
    assert read(ctx) == 1.0
    for name in WANT:
        assert harness.load_readers([name])[name](
            dict(ctx, trace=None)) == pytest.approx(WANT[name])
