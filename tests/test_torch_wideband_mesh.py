"""The receiver's multi-device form and int16 ingest, ported:
gmr1_tpu_torch's WidebandReceiver(mesh=Mesh(["cpu"] * 8), device="cpu")
on tests/test_wideband.py's e2e capture (FS 500 kHz, M = 16, two rows
of the 16-carrier bank a shard device).

  * its frames, speech and CSD equal gmr1_tpu's single-device receiver's
    (which JAX's own test_sharded_streaming_identical_frames holds equal
    to JAX's mesh), through the bf16 reshard;
  * h2d_dtype="int16" (single device, and on the mesh) keeps every
    CRC-protected frame of JAX's float32 run and the scenario truth, as
    tests/test_wideband.py:232 asks of JAX;
  * with the carriers restricted to two (C = 2) on Mesh(["cpu"] * 2) the
    block phase splits over the carriers: one phase a carrier group a
    block, the TCH9 rings in two parts, the same-block correction phases
    per group; frames, speech and CSD equal JAX's single-device receiver
    with the same `arfcns`.  The unrestricted capture (an odd C: every
    carrier JAX acquires) on the same mesh runs unsplit, as JAX does;
  * device_block_time returns a positive time after run() (the split form
    too) and raises before it;
  * a mesh with a disagreeing `device`, or one whose size does not divide
    M, raises; int16 ingest at an off-grid rate raises.
"""

import numpy as np
import pytest
import torch

from gmr1_tpu.rx import gsmtap as gt
from gmr1_tpu.rx.wideband import WidebandReceiver as JRx
from gmr1_tpu_torch.parallel import Mesh, ShardedRows
from gmr1_tpu_torch.rx import wideband as twb
from gmr1_tpu_torch.rx.wideband import WidebandReceiver as TRx

from tests.test_torch_wideband_traffic import e2e_capture
from tests.test_wideband import A_AUX, A_FULL, CENTER, FS

torch.set_num_threads(2)

SPS = 4
CRC_TYPES = (gt.GMR1_BCCH, gt.GMR1_CCCH, gt.GMR1_TCH3 | gt.GMR1_FACCH,
             gt.GMR1_TCH9 | gt.GMR1_FACCH)


@pytest.fixture(scope="module")
def runs():
    wb, truth = e2e_capture()
    jrx = JRx(wb, FS, CENTER, sps=SPS)
    jrx.run()
    mesh = TRx(wb, FS, CENTER, sps=SPS, device="cpu",
               mesh=Mesh(["cpu"] * 8))
    mesh.run()
    i16 = TRx(wb, FS, CENTER, sps=SPS, device="cpu", h2d_dtype="int16")
    i16.run()
    return dict(wb=wb, truth=truth, jrx=jrx, mesh=mesh, i16=i16)


def test_mesh_same_frames_speech_csd(runs):
    jrx, rx = runs["jrx"], runs["mesh"]
    assert isinstance(rx.streams, ShardedRows) and len(rx.streams.parts) == 8
    assert rx.frames == jrx.frames
    assert [c.arfcn for c in rx.carriers] == [c.arfcn for c in jrx.carriers]
    for jc, tc in zip(jrx.carriers, rx.carriers):
        assert (tc.speech, tc.csd) == (jc.speech, jc.csd), tc.arfcn
    assert any(c.csd for c in rx.carriers)
    assert rx.ici_bytes_per_block == 2 * (20000 // 8) * 16 * 2 * 2 * 7 // 8


def _truth_ok(rx, jrx, truth):
    for t in CRC_TYPES:
        assert [f for f in rx.frames if f[1] == t] \
            == [f for f in jrx.frames if f[1] == t], t
    car = next(c for c in rx.carriers if c.arfcn == A_FULL)
    assert car.speech[:6] == truth["speech"]
    idx = [car.csd.index(p) for p in truth["csd"][:3] if p in car.csd]
    assert len(idx) == 3 and idx == sorted(idx)


def test_int16_ingest(runs):
    _truth_ok(runs["i16"], runs["jrx"], runs["truth"])


def test_int16_ingest_on_the_mesh(runs):
    rx = TRx(runs["wb"], FS, CENTER, sps=SPS, device="cpu",
             mesh=Mesh(["cpu"] * 2), h2d_dtype="int16")
    rx.run()
    _truth_ok(rx, runs["jrx"], runs["truth"])


def test_quant_row_carries_the_scale(runs):
    rx = runs["i16"]
    x = np.random.default_rng(3).normal(size=(64, 2)).astype(np.float32)
    q = rx._quant(x)
    assert q.dtype == np.int16 and q.shape == (65, 2)
    assert np.abs(q[1:]).max() == 32000
    buf = np.empty((65, 2), np.int16)         # a staging buffer's form
    assert rx._quant(x, out=buf) is buf and np.array_equal(buf, q)
    back = rx._dequant(torch.from_numpy(q)).numpy()
    np.testing.assert_allclose(back, x, atol=np.abs(x).max() / 32000)
    qs = rx._quant(np.stack([x, 2 * x]))            # one scale, two shards
    assert qs.shape == (2, 65, 2) and (qs[0, 0] == qs[1, 0]).all()


def test_device_block_time(runs):
    for rx in (runs["mesh"], runs["i16"]):
        t = rx.device_block_time(iters=1)
        assert isinstance(t, float) and t > 0.0
    fresh = TRx(runs["wb"], FS, CENTER, sps=SPS, device="cpu")
    with pytest.raises(RuntimeError, match="run"):
        fresh.device_block_time()


def test_bad_mesh_arguments():
    wb = np.zeros((16, 2), np.float32)
    with pytest.raises(ValueError, match="disagrees"):
        TRx(wb, FS, CENTER, mesh=Mesh(["cpu"] * 2))      # device="cuda"
    with pytest.raises(ValueError):
        TRx(wb, FS, CENTER, device="cpu", mesh=Mesh(["cpu"] * 3))
    with pytest.raises(ValueError):
        TRx(wb, 530e3, CENTER, device="cpu", h2d_dtype="int16")
    with pytest.raises(ValueError):
        TRx(wb, FS, CENTER, device="cpu", h2d_dtype="int8")


SPLIT_ARFCNS = [A_FULL, A_AUX]
PHASES = ("_phase_block", "_phase_tch3s", "_phase_tch9s")


@pytest.fixture(scope="module")
def split(runs):
    """C = 2 on a 2-device mesh (split), with every phase call recorded
    as (phase, the carrier columns it ran), beside JAX's single-device
    receiver on the same ARFCNs."""
    wb = runs["wb"]
    jrx = JRx(wb, FS, CENTER, sps=SPS, arfcns=SPLIT_ARFCNS)
    jrx.run()
    calls = []

    def recording(name, fn):
        def phase(streams, m, *args):
            calls.append((name, m["rows"].tolist()))
            return fn(streams, m, *args)
        return phase
    with pytest.MonkeyPatch.context() as mp:
        for name in PHASES:
            mp.setattr(twb, name, recording(name, getattr(twb, name)))
        rx = TRx(wb, FS, CENTER, sps=SPS, device="cpu", arfcns=SPLIT_ARFCNS,
                 mesh=Mesh(["cpu"] * 2))
        rx.run()
    return dict(jrx=jrx, rx=rx, calls=calls)


def test_split_mesh_same_frames_speech_csd(split):
    jrx, rx = split["jrx"], split["rx"]
    assert len(rx.carriers) == 2 and len(rx._groups()) == 2
    assert rx.frames == jrx.frames
    assert [c.arfcn for c in rx.carriers] == [c.arfcn for c in jrx.carriers]
    for jc, tc in zip(jrx.carriers, rx.carriers):
        assert (tc.speech, tc.csd) == (jc.speech, jc.csd), tc.arfcn
    assert any(c.csd for c in rx.carriers)
    types = {f[1] for f in rx.frames}
    assert {gt.GMR1_TCH3 | gt.GMR1_FACCH, gt.GMR1_TCH9} <= types


def test_split_mesh_phase_per_group(split):
    """One block phase a carrier group a block, each over its own
    carrier; same-block corrections ran, each within one group; the rings
    are held in two parts."""
    rx, calls = split["rx"], split["calls"]
    cols = [c.col for c in rx.carriers]
    blocks = [rows for name, rows in calls if name == "_phase_block"]
    assert blocks and len(blocks) % 2 == 0
    assert blocks == [[cols[0]], [cols[1]]] * (len(blocks) // 2)
    for name in ("_phase_tch3s", "_phase_tch9s"):
        sub = [rows for n, rows in calls if n == name]
        assert sub, name
        assert all(len(rows) == 1 and rows[0] in cols for rows in sub)
    assert len(rx._il) == 2
    assert [il.buf.shape[0] for il in rx._il] == [1, 1]
    assert [il.n.shape[0] for il in rx._il] == [1, 1]


def test_unsplit_when_c_does_not_divide(runs):
    rx = TRx(runs["wb"], FS, CENTER, sps=SPS, device="cpu",
             mesh=Mesh(["cpu"] * 2))
    rx.run()
    jrx = runs["jrx"]
    n = len(rx.carriers)
    assert n % 2 and n == len(jrx.carriers) and len(rx._groups()) == 1
    assert len(rx._il) == 1 and rx._il[0].buf.shape[0] == n
    assert rx.frames == jrx.frames
    for jc, tc in zip(jrx.carriers, rx.carriers):
        assert (tc.speech, tc.csd) == (jc.speech, jc.csd), tc.arfcn


def test_device_block_time_split(split):
    t = split["rx"].device_block_time(iters=1)
    assert isinstance(t, float) and t > 0.0
