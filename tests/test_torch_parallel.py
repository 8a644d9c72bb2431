"""The multi-device form, ported (gmr1_tpu_torch.parallel): the port on
Mesh(["cpu"] * 8) against gmr1_tpu.parallel on JAX's virtual 8-device
CPU mesh (tests/conftest.py), at FS = 1 MHz (M = 32 channels).

  * overlapped_shards: exactly, numpy and tensors;
  * analyze_reshard against JAX's inside shard_map: f32 transport at
    rtol 1e-4 / atol 1e-4 (and the unsharded analysis), bf16 transport
    within one bf16 ulp (|a - b| <= 2^-7 |b| + 1e-6); column c on device
    c // (M/D), rows in shard order;
  * two streaming steps with the host-carried halo == the unsharded
    analysis of the whole input;
  * ShardedTransponder on tests/test_parallel.py:85's transponder: L2 and
    CRC flags exact against JAX and the truth, n_bad equal;
  * StreamingTransponder on tests/test_parallel.py:162's two-carrier
    fixture over two steps: BCCH, speech, DKAB found flags and soft bits,
    and TCH9 across the step boundary exact against JAX and the truth on
    the seeded carriers; the port's step 2 started from JAX's carry after
    step 1 gives JAX's step 2;
  * ici_bytes_per_step equal;
  * every kernel wrapper launches on its tensor's device (trap of a
    multi-card mesh: the current device is not the tensor's).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh
from jax.sharding import PartitionSpec as P

from gmr1_tpu.channelizer import Channel as JChannel
from gmr1_tpu.channelizer import Channelizer as JChannelizer
from gmr1_tpu.l1 import bcch as j_bcch
from gmr1_tpu.parallel import ingest as j_ingest
from gmr1_tpu.parallel.transponder import ShardedTransponder as JSharded
from gmr1_tpu.parallel.transponder import StreamingTransponder as JStreaming
from gmr1_tpu.sdr import bursts as BU
from gmr1_tpu.sdr import modem as j_modem
from gmr1_tpu_torch import kernels
from gmr1_tpu_torch.channelizer.arfcn import Channel
from gmr1_tpu_torch.channelizer.pfb import Channelizer
from gmr1_tpu_torch.parallel import (Mesh, ShardedRows, ShardedTransponder,
                                     StreamingTransponder, analyze_reshard,
                                     ici_bytes_per_step, overlapped_shards)

from tests.test_parallel import CENTER, FS, make_transponder

torch.set_num_threads(2)

SPS = 4
D = 8


@pytest.fixture(scope="module")
def jmesh():
    return JMesh(np.array(jax.devices()[:D]), ("dev",))


@pytest.fixture(scope="module")
def tmesh():
    return Mesh(["cpu"] * D)


def bf16_close(a, b):
    """Within one bf16 ulp: |a - b| <= 2^-7 |b| + 1e-6."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    bad = np.abs(a - b) > 2.0 ** -7 * np.abs(b) + 1e-6
    assert not bad.any(), (int(bad.sum()), float(np.abs(a - b).max()))


def test_mesh_devices():
    m = Mesh(["cpu"] * 3)
    assert m.size == 3 and all(d == torch.device("cpu") for d in m.devices)
    with pytest.raises(ValueError):
        Mesh([])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            Mesh()
        with pytest.raises(RuntimeError, match="cuda"):
            Mesh(["cuda:0", "cuda:0"])


@pytest.mark.parametrize("as_tensor", [False, True])
def test_overlapped_shards(rng, as_tensor):
    halo, n_local = 96, 256
    x = rng.standard_normal((D * n_local, 2)).astype(np.float32)
    tail = rng.standard_normal((halo, 2)).astype(np.float32)
    want, want_tail = j_ingest.overlapped_shards(x, tail, halo, D)
    if as_tensor:
        got, got_tail = overlapped_shards(torch.as_tensor(x),
                                          torch.as_tensor(tail), halo, D)
        got, got_tail = got.numpy(), got_tail.numpy()
    else:
        got, got_tail = overlapped_shards(x, tail, halo, D)
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(got_tail, np.asarray(want_tail))
    with pytest.raises(ValueError):
        overlapped_shards(x[:-1], tail, halo, D)


def _jax_reshard(jana, jmesh, sh, bf16):
    f = jax.jit(jax.shard_map(
        lambda xh: j_ingest.analyze_reshard(jana, "dev", D, xh[0], bf16),
        mesh=jmesh, in_specs=P("dev"), out_specs=P("dev")))
    return np.asarray(f(jnp.asarray(sh)))            # (M, R_total, 2)


@pytest.mark.parametrize("bf16", [False, True])
def test_analyze_reshard_matches_jax(rng, jmesh, tmesh, bf16):
    jchz, chz = JChannelizer(FS, CENTER, sps=SPS), Channelizer(FS, CENTER,
                                                              sps=SPS)
    ana = chz.analyzer
    np.testing.assert_array_equal(ana.h_poly, np.asarray(jchz.analyzer.h_poly))
    halo, n_local = ana.p * ana.m, 32 * 64
    x = rng.standard_normal((D * n_local, 2)).astype(np.float32)
    sh, _ = overlapped_shards(x, np.zeros((halo, 2), np.float32), halo, D)
    parts = analyze_reshard(ana, tmesh, [torch.from_numpy(s) for s in sh],
                            bf16_reshard=bf16)
    ml, r_total = ana.m // D, n_local // ana.hop * D
    assert all(p.shape == (ml, r_total, 2) for p in parts)
    got = ShardedRows(parts).gather().numpy()
    want = _jax_reshard(jchz.analyzer, jmesh, sh, bf16)
    if bf16:
        bf16_close(got, want)
        # the bf16 rows are the f32 rows rounded to bf16, exactly
        f32 = torch.cat(analyze_reshard(ana, tmesh, [torch.from_numpy(s)
                                                      for s in sh], False))
        np.testing.assert_array_equal(got, f32.bfloat16().float().numpy())
    else:
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
        # column c on device c // (M/D): the unsharded analysis, transposed
        ref = ana(torch.as_tensor(x)).permute(1, 0, 2).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_streaming_halo_carry(rng, tmesh):
    """Two steps with the host-carried halo == the unsharded analysis of
    the concatenated input."""
    ana = Channelizer(FS, CENTER, sps=SPS).analyzer
    halo, n_local = ana.p * ana.m, 32 * 64
    n_total = D * n_local
    x = rng.standard_normal((2 * n_total, 2)).astype(np.float32)
    tail = np.zeros((halo, 2), np.float32)
    got = []
    for s in range(2):
        sh, tail = overlapped_shards(x[s * n_total:(s + 1) * n_total], tail,
                                     halo, D)
        got.append(torch.cat(analyze_reshard(
            ana, tmesh, [torch.from_numpy(v) for v in sh], False)))
    ref = ana(torch.as_tensor(x)).permute(1, 0, 2)
    np.testing.assert_allclose(torch.cat(got, dim=1).numpy(), ref.numpy(),
                               rtol=1e-4, atol=1e-4)


def test_sharded_rows_take(rng):
    parts = [torch.as_tensor(rng.normal(size=(4, 3, 2)).astype(np.float32))
             for _ in range(3)]
    sr = ShardedRows(parts)
    full = torch.cat(parts)
    assert sr.shape == (12, 3, 2)
    rows = [11, 0, 5, 4, 4, 7]
    np.testing.assert_array_equal(sr.take(rows).numpy(), full[rows].numpy())


def test_sharded_transponder(rng, jmesh, tmesh):
    jchz, chz = JChannelizer(FS, CENTER, sps=SPS), Channelizer(FS, CENTER,
                                                              sps=SPS)
    n_local = 32 * 128
    arfcns = [512 + d for d in (1, 3, 6, -5, -9, -14)]
    l2s = [rng.integers(0, 256, 24, dtype=np.uint8) for _ in arfcns]
    wb = make_transponder(rng, jchz, arfcns, l2s, n_local * D)
    # the burst's position in the resampled stream (unsharded JAX probe,
    # as tests/test_parallel.py finds it)
    stream = np.asarray(jchz.extract(jchz.process(wb), JChannel(arfcns[0])))
    blen = BU.BCCH.len_syms * SPS
    probe = j_modem.demod(BU.BCCH, stream, sps=SPS, win=stream.shape[0] - blen)
    assert not int(j_bcch.decode(probe.ebits)[1])
    win = 16 * SPS
    pos = max(int(float(probe.toa)) - win // 2, 0)
    jst = JSharded(jchz, jmesh, n_local, burst=BU.BCCH, sps=SPS,
                   burst_pos=pos, win=win)
    want = [np.asarray(v) for v in jst.step(jst.shard_input(wb))]
    st = ShardedTransponder(chz, tmesh, n_local, burst=BU.BCCH, sps=SPS,
                            burst_pos=pos, win=win)
    assert st.win == jst.win
    l2, crc_fail, _metric, n_bad = st.step(st.shard_input(wb))
    np.testing.assert_array_equal(crc_fail.numpy(), want[1])
    ok = crc_fail.numpy() == 0
    np.testing.assert_array_equal(l2.numpy()[ok], want[0][ok])
    assert int(n_bad) == int(want[3]) == 32 - len(arfcns)
    for a, l2a in zip(arfcns, l2s):
        idx = chz.freq2index(Channel(a).frequency)
        assert ok[idx]
        np.testing.assert_array_equal(l2.numpy()[idx], l2a)
    with pytest.raises(ValueError):
        ShardedTransponder(chz, tmesh, n_local + 16)


@pytest.mark.parametrize("kind", ["sharded", "streaming"])
def test_transponders_run_the_f32_dft(tmesh, kind):
    # they decode every column, those without a carrier too, so they keep
    # the f32 channel DFT whatever the channelizer's analyzer says, and
    # leave that analyzer as it was (parallel/transponder.py _f32_analyzer)
    chz = Channelizer(FS, CENTER, sps=SPS)
    st = (ShardedTransponder(chz, tmesh, 32 * 128) if kind == "sharded"
          else StreamingTransponder(chz, tmesh))
    ana = chz.analyzer
    assert st.analyzer.dft_bf16 is False and ana.dft_bf16 is True
    np.testing.assert_array_equal(st.analyzer.h_poly, ana.h_poly)
    assert (st.analyzer.m, st.analyzer.p, st.analyzer.chunk_frames) == \
        (ana.m, ana.p, ana.chunk_frames)


# ---------------------------------------------------------------------------
# StreamingTransponder: tests/test_parallel.py:162's fixture
# ---------------------------------------------------------------------------

F, STEPS = 8, 2
TN_T, TN9, DKP = 6, 12, 9
DKAB_BITS = [0, 1, 1, 0, 1, 0, 0, 1]


def _streaming_capture():
    """tests/test_parallel.py's `streaming` capture (seed 0x57EA), built
    with the port's encoders and modulator (JAX's, run eagerly, take over
    a minute): two seeded carriers, BCCH at frame 2 of each step, NT3
    speech frames 0-5, DKABs 6-7, a chained TCH9 9k6 train on every
    frame.  Returns (wb, truth, seeds, p0)."""
    from gmr1_tpu_torch.l1 import bcch, tch3, tch9
    from gmr1_tpu_torch.ops import cplx
    from gmr1_tpu_torch.sdr import modem
    from tests.test_parallel import _place
    from tests.test_receiver import dkab_signal

    rng = np.random.default_rng(0x57EA)
    frame_bb = 936 * SPS
    n_bb = STEPS * F * frame_bb + 2000
    seeds = [512 + 3, 512 - 9]
    truth, bbs = {}, {}
    for a in seeds:
        bb = np.zeros(n_bb, np.complex64)
        t = {"bcch": [rng.integers(0, 256, 24, dtype=np.uint8)
                      for _ in range(STEPS)]}
        for s, l2 in enumerate(t["bcch"]):
            x1 = cplx.to_complex(modem.mod(BU.BCCH, bcch.encode(l2[None]))[0])
            _place(bb, (s * F + 2) * frame_bb, x1)
        t["speech"] = []
        for s in range(STEPS):
            for f in range(6):
                f0 = rng.integers(0, 256, 10, dtype=np.uint8)
                f1 = rng.integers(0, 256, 10, dtype=np.uint8)
                t["speech"].append((s, f, bytes(f0), bytes(f1)))
                e = tch3.encode(f0, f1, np.zeros(4, np.uint8))
                x1 = cplx.to_complex(modem.mod(BU.NT3_SPEECH, e[None])[0])
                _place(bb, (s * F + f) * frame_bb + TN_T * 39 * SPS, x1)
        for s in range(STEPS):
            for f in (6, 7):
                sig = dkab_signal(rng, DKP, DKAB_BITS)
                pos = (s * F + f) * frame_bb + TN_T * 39 * SPS
                bb[pos:pos + len(sig)] += sig
        t["csd"] = [rng.integers(0, 256, 60, dtype=np.uint8)
                    for _ in range(STEPS * F)]
        il_e = tch9.interleaver_init(dtype=torch.uint8)
        for i, l2 in enumerate(t["csd"]):
            il_e, eb = tch9.encode(l2, tch9.MODE_9K6, np.zeros(10, np.uint8),
                                   np.zeros(4, np.uint8), il_e)
            x1 = cplx.to_complex(modem.mod(BU.NT9, eb[None], sync_id=1)[0])
            _place(bb, i * frame_bb + TN9 * 39 * SPS, x1)
        truth[a], bbs[a] = t, bb
    ratio = FS / (23400.0 * SPS)
    n_wb = int(n_bb * ratio)
    pos = np.arange(n_wb) / ratio
    grid = np.arange(n_bb, dtype=np.float64)
    tt = np.arange(n_wb) / FS
    wb = (rng.standard_normal(n_wb) + 1j * rng.standard_normal(n_wb)) * 5e-3
    for a, bb in bbs.items():
        s = np.interp(pos, grid, bb.real) + 1j * np.interp(pos, grid, bb.imag)
        wb += s * np.exp(2j * np.pi * (Channel(a).frequency - CENTER) * tt)
    wb = cplx.planar_np(wb.astype(np.complex64))
    # the pipeline delay, from an unsharded probe on carrier 0
    chz = Channelizer(FS, CENTER, sps=SPS)
    stream = chz.extract(chz.process(wb[:14000 * chz.analyzer.hop]),
                         Channel(seeds[0]))
    blen = BU.BCCH.len_syms * SPS
    cal = stream[:5 * frame_bb]
    probe = modem.demod(BU.BCCH, cal, sps=SPS, win=cal.shape[0] - blen)
    assert not int(bcch.decode(probe.ebits)[1])
    p0 = int(round(float(probe.toa))) - 2 * frame_bb
    return wb, truth, seeds, p0


@pytest.fixture(scope="module")
def streaming(jmesh, tmesh):
    wb, truth, seeds, p0 = _streaming_capture()
    kw = dict(frames=F, burst_pos=p0, tn_tch=TN_T, tn_tch9=TN9, dkab_p=DKP)
    jst = JStreaming(JChannelizer(FS, CENTER, sps=SPS), jmesh, **kw)
    st = StreamingTransponder(Channelizer(FS, CENTER, sps=SPS), tmesh, **kw)
    n_step = D * st.n_local
    assert n_step == D * jst.n_local
    steps = [wb[s * n_step:(s + 1) * n_step] for s in range(STEPS)]
    jc, tc = jst.carry_init(), st.carry_init()
    jouts, touts, jcarry = [], [], []
    for x in steps:
        o, jc = jst.step(jst.shard_input(x), jc)
        jouts.append({k: np.asarray(v) for k, v in o.items()})
        jcarry.append(jax.tree_util.tree_map(np.asarray, jc))
        o, tc = st.step(st.shard_input(x), tc)
        touts.append({k: v.numpy() for k, v in o.items()})
    # the port's step 2 from JAX's carry after step 1
    st2 = StreamingTransponder(Channelizer(FS, CENTER, sps=SPS), tmesh, **kw)
    st2.shard_input(steps[0])                 # advance the host halo tail
    o, _ = st2.step(st2.shard_input(steps[1]),
                    st2.carry_from_numpy(jcarry[0]))
    resumed = {k: v.numpy() for k, v in o.items()}
    cols = [st.chz.freq2index(Channel(a).frequency) for a in seeds]
    return dict(jouts=jouts, touts=touts, resumed=resumed, truth=truth,
                seeds=seeds, cols=cols, jst=jst, st=st)


def _same_seeded(t, j, cols):
    """The outputs of the seeded carriers, against JAX's."""
    for k in ("l2b", "crcb"):
        np.testing.assert_array_equal(t[k][cols], j[k][cols], err_msg=k)
    for k in ("sf0", "sf1"):                  # speech frames 0-5
        np.testing.assert_array_equal(t[k][:6, cols], j[k][:6, cols],
                                      err_msg=k)
    np.testing.assert_array_equal(t["dk_found"][:, cols],
                                  j["dk_found"][:, cols])
    np.testing.assert_array_equal(t["dk_bits"][6:, cols],
                                  j["dk_bits"][6:, cols])
    np.testing.assert_array_equal(t["l2_t9"][2:, cols], j["l2_t9"][2:, cols])


def test_streaming_matches_jax(streaming):
    s = streaming
    for t, j in zip(s["touts"], s["jouts"]):
        assert {k: v.shape for k, v in t.items()} \
            == {k: v.shape for k, v in j.items()}
        np.testing.assert_array_equal(t["crcb"], j["crcb"])
        _same_seeded(t, j, s["cols"])
    np.testing.assert_array_equal(s["touts"][1]["l2_t9"][:2, s["cols"]],
                                  s["jouts"][1]["l2_t9"][:2, s["cols"]])


def test_streaming_resumes_from_jax_carry(streaming):
    s = streaming
    _same_seeded(s["resumed"], s["jouts"][1], s["cols"])
    np.testing.assert_array_equal(s["resumed"]["l2_t9"][:2, s["cols"]],
                                  s["jouts"][1]["l2_t9"][:2, s["cols"]])


def test_streaming_truth(streaming):
    """tests/test_parallel.py's checks, on the port: BCCH, speech, the
    DKAB EMA carry, and TCH9 payload i at burst i+2 across the step
    boundary."""
    s = streaming
    outs, truth = s["touts"], s["truth"]
    for a, col in zip(s["seeds"], s["cols"]):
        for st_i, out in enumerate(outs):
            assert not out["crcb"][col], (a, st_i)
            np.testing.assert_array_equal(out["l2b"][col],
                                          truth[a]["bcch"][st_i])
            for f in (6, 7):
                assert out["dk_found"][f, col], (a, st_i, f)
                bits = (out["dk_bits"][f, col] < 0).astype(int).tolist()
                assert bits == DKAB_BITS, (a, st_i, f)
            assert not out["dk_found"][:6, col].any(), (a, st_i)
        for (st_i, f, f0, f1) in truth[a]["speech"]:
            assert (outs[st_i]["sf0"][f, col].tobytes(),
                    outs[st_i]["sf1"][f, col].tobytes()) == (f0, f1)
        for i in range(0, 2 * F - 2):
            st_i, f = divmod(i + 2, F)
            assert outs[st_i]["l2_t9"][f, col].tobytes() \
                == truth[a]["csd"][i].tobytes(), (a, i)


def test_ici_bytes_per_step(streaming):
    s = streaming
    assert s["st"].ici_bytes_per_step == s["jst"].ici_bytes_per_step
    ana = Channelizer(FS, CENTER, sps=SPS).analyzer
    for r_local, d, bf16 in ((2500, 8, True), (2500, 8, False),
                             (10000, 2, True), (7, 3, False)):
        assert ici_bytes_per_step(ana, r_local, d, bf16) \
            == j_ingest.ici_bytes_per_step(ana, r_local, d, bf16)


def test_kernel_launches_take_the_tensor_device(monkeypatch):
    """Each wrapper launches through kernels.launch with its tensor's
    device, and launch makes that device current and takes its stream:
    on a multi-card mesh a shard on cuda:1 must not launch into cuda:0's
    context.  One card cannot show this, so the CUDA calls are mocked."""
    import contextlib

    from gmr1_tpu_torch.channelizer import pfb
    from gmr1_tpu_torch.ops import a5, viterbi

    events = []

    @contextlib.contextmanager
    def device(d):
        events.append(("current", torch.device(d)))
        yield

    class Stream:
        def __init__(self, d):
            self.cuda_stream = 1000 + torch.device(d).index

    def fake_library(name):
        def fn(*args):
            events.append(("call", name, args[-1]))
            return 0
        return fn
    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: Stream(d))
    monkeypatch.setattr(kernels, "library", fake_library)
    kernels.launch("pfb", torch.device("cuda:1"), 1, 2)
    assert events == [("current", torch.device("cuda:1")),
                      ("call", "pfb", 1001)]

    # the wrappers pass their tensor's device (CPU tensors pose as CUDA
    # ones here; kernels.launch is recorded, not run)
    seen = []
    monkeypatch.setattr(kernels, "launch",
                        lambda name, dev, *a: seen.append((name, dev)))
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    counts = (pfb.branch_filter.launches, viterbi.decode_trellis.launches,
              a5.keystream.launches)
    try:
        pfb._branch_filter_cuda(torch.zeros((40, 2)), torch.zeros((6, 4)),
                                4, 4)
        viterbi._decode_trellis_cuda(torch.zeros((2, 8, 2)),
                                     torch.ones((32, 2)), True)
        a5._keystream_cuda(np.zeros(8, np.uint8),
                           torch.zeros(3, dtype=torch.int64), 16)
    finally:
        pfb.branch_filter.launches, viterbi.decode_trellis.launches, \
            a5.keystream.launches = counts
    assert seen == [("pfb", torch.device("cpu")),
                    ("viterbi", torch.device("cpu")),
                    ("a5", torch.device("cpu"))]
