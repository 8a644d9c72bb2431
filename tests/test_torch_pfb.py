"""Parity of the port's channelizer (gmr1_tpu_torch.channelizer.pfb) with
gmr1_tpu, and of its streamed ingest step with the JAX receiver's.

On the CPU the port's analysis runs the plain branch filter (the CPU
form of the CUDA kernel kernels/pfb.cu) and the float32 channel DFT.
It must agree with the JAX shifted-accumulate form `_analyze_block` and
with the Pallas slab kernel in interpret mode (f32 DFT) to rtol 2e-4 /
atol 1e-4, the tolerance of the JAX package's own Pallas parity test
(summation order differs).

The bf16 channel DFT (`dft_bf16`, the card's default) has its plain
version `channel_dft(..., bf16=True)`: it must agree with JAX's
`dft_bf16=True` analysis in interpret mode within 1e-5 of the bank's
peak (products of bf16 values are exact in float32, so only the order of
the sums differs).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gmr1_tpu.channelizer import Channelizer as JChannelizer
from gmr1_tpu.channelizer.pfb import (PFBAnalyzer as JPFBAnalyzer,
                                      _analyze_block, _analyze_block_fused)
from gmr1_tpu.ops import pallas_pfb
from gmr1_tpu.rx.wideband import WidebandReceiver as JRx
from gmr1_tpu_torch.channelizer import pfb
from gmr1_tpu_torch.rx.wideband import WidebandReceiver as TRx

torch.set_num_threads(2)

GEOMS = [(16, 3, 40), (64, 5, 21), (64, 5, 24)]
TOL = dict(rtol=2e-4, atol=1e-4)
FS = 500e3
CENTER = 1525e6 + 31250.0 * 500


def geom_case(rng, m, p, r_cnt):
    hop = m // 2
    x = rng.normal(size=(r_cnt * hop + p * m, 2)).astype(np.float32)
    h_poly = rng.normal(size=(m, p)).astype(np.float32)
    return x, h_poly, hop


@pytest.mark.parametrize("m,p,r_cnt", GEOMS)
def test_block_matches_xla_analysis(rng, m, p, r_cnt):
    x, h_poly, hop = geom_case(rng, m, p, r_cnt)
    want = np.asarray(_analyze_block(jnp.asarray(x), jnp.asarray(h_poly),
                                     m, p, hop))
    got = pfb.PFBAnalyzer.from_numpy(h_poly).block(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("m,p,r_cnt", GEOMS)
def test_block_matches_pallas_interpret(rng, m, p, r_cnt):
    x, h_poly, hop = geom_case(rng, m, p, r_cnt)
    wa = jnp.asarray(pallas_pfb.slab_weights(h_poly, m, p, hop))
    want = np.asarray(_analyze_block_fused(jnp.asarray(x), wa, m, p, hop,
                                           interpret=True, dft_bf16=False))
    got = pfb.PFBAnalyzer.from_numpy(h_poly).block(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("m,p,r_cnt", GEOMS)
def test_branch_filter_matches_pallas_interpret(rng, m, p, r_cnt):
    """The plain branch filter is the Pallas kernel's FIR without the
    128-lane padding: same tables, same packed activation."""
    x, h_poly, hop = geom_case(rng, m, p, r_cnt)
    hp = -(-hop // 128) * 128
    wa_j = pallas_pfb.slab_weights(h_poly, m, p, hop)
    wa_t = pfb.slab_weights(h_poly, m, p, hop)
    np.testing.assert_array_equal(wa_t, wa_j[:, :hop])
    z = pallas_pfb.to_slab(jnp.asarray(x), p, hop, r_cnt)
    want = np.asarray(pallas_pfb.branch_filter_slab(
        z, jnp.asarray(wa_j), m, p, hop, r_cnt, interpret=True))
    want = want.reshape(r_cnt, 4, hp)[..., :hop].reshape(r_cnt, 4 * hop)
    got = pfb.branch_filter(torch.from_numpy(x), torch.from_numpy(wa_t),
                            r_cnt, hop)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    dft_j = pallas_pfb.dft_packed_slab(m, hop).reshape(4, hp, 2 * m)
    np.testing.assert_array_equal(pfb.dft_packed_slab(m, hop),
                                  dft_j[:, :hop].reshape(4 * hop, 2 * m))


REAL_GEOMS = [(34e6, False), (30.72e6, True)]    # M=1088/P=10, M=984/P=19


def compact_taps(wa):
    """The non-zero taps of a slab_weights table, as kernels/pfb.cu loads
    them into registers: (wc (2, P, hop), off (2, hop)) with

      wa[a*(2P+1) + off[a, b] + 2k, b] = wc[a, k, b],  off = (1 - a) + (b == 0)

    and every other entry of wa zero (s = u+1 of half a has a's parity
    for lanes b >= 1, s = u for lane 0).  `wa` is a tensor."""
    taps = wa.shape[0] // 2
    p, hop = taps // 2, wa.shape[1]
    dev = wa.device
    lanes = torch.arange(hop, device=dev)
    off = (1 - torch.arange(2, device=dev))[:, None] + (lanes == 0)[None, :]
    rows = (torch.arange(2, device=dev)[:, None, None] * taps
            + off[:, None, :]
            + 2 * torch.arange(p, device=dev)[None, :, None])
    return wa[rows, lanes], off


def real_wa(fs, need_nx):
    ana = pfb.Channelizer(fs, CENTER, need_nx=need_nx).analyzer
    return ana, torch.from_numpy(ana.wa_np)


@pytest.mark.parametrize("fs,need_nx", REAL_GEOMS, ids=["m1088", "m984"])
def test_compact_taps_hold_every_nonzero_tap(fs, need_nx):
    """kernels/pfb.cu's tap rule: scattering the compact taps back gives
    slab_weights exactly (so every other entry is zero), for lane 0 and
    lanes >= 1, and the zero pattern is the JAX table's."""
    ana, wa = real_wa(fs, need_nx)
    assert (ana.m, ana.p) == ((1088, 10) if not need_nx else (984, 19))
    wc, off = compact_taps(wa)
    p, hop = ana.p, ana.hop
    assert wc.shape == (2, p, hop)
    np.testing.assert_array_equal(off[:, 0].numpy(), [2, 1])
    np.testing.assert_array_equal(off[:, 1:].numpy(),
                                  np.array([[1], [0]]) * np.ones(hop - 1))
    dense = torch.zeros_like(wa)
    lanes = torch.arange(hop)
    for a in (0, 1):
        for k in range(p):
            dense[a * (2 * p + 1) + off[a] + 2 * k, lanes] = wc[a, k]
    np.testing.assert_array_equal(dense.numpy(), wa.numpy())
    wa_j = pallas_pfb.slab_weights(ana.h_poly, ana.m, p, hop)[:, :hop]
    np.testing.assert_array_equal(wa_j != 0, dense.numpy() != 0)


def fir_compact(x, wc, off, r_cnt, hop):
    """The branch filter over the compact taps only, in the dense loop's
    order of u."""
    p = wc.shape[1]
    z = x[:(r_cnt + 2 * p) * hop].reshape(r_cnt + 2 * p, hop, 2)
    lanes = torch.arange(hop)
    out = x.new_zeros((r_cnt, 2, 2, hop))
    for a in (0, 1):
        for k in range(p):
            rows = torch.arange(r_cnt)[:, None] + off[a][None, :] + 2 * k
            out[:, :, a] += (wc[a, k][None, :, None]
                             * z[rows, lanes]).transpose(1, 2)
    return out.reshape(r_cnt, 4 * hop)


@pytest.mark.parametrize("fs,need_nx", REAL_GEOMS, ids=["m1088", "m984"])
def test_compact_fir_equals_plain(rng, fs, need_nx):
    """Dropping the zero taps changes no sum: the FIR over the compact
    table equals branch_filter_plain exactly."""
    ana, wa = real_wa(fs, need_nx)
    r_cnt = 12
    x = torch.from_numpy(rng.normal(size=((r_cnt + 2 * ana.p) * ana.hop, 2))
                         .astype(np.float32))
    wc, off = compact_taps(wa)
    np.testing.assert_array_equal(
        fir_compact(x, wc, off, r_cnt, ana.hop).numpy(),
        pfb.branch_filter_plain(x, wa, r_cnt, ana.hop).numpy())


@pytest.mark.parametrize("p", [1, 10, 19, pfb.PFB_KERNEL_MAX_P])
@pytest.mark.parametrize("n_out", [1, 16, 17, 455, 464])
def test_kernel_ring_schedule(p, n_out):
    """Model of kernels/pfb.cu's tile ring (128 rows of 16-row tiles,
    seven tiles issued ahead, cp.async.wait_group 6 - H): every ring row
    that a stored output reads, lane 0's shifted column included, belongs
    to a tile whose group was waited for and that no later load
    overwrote."""
    tr, ring, ahead, rb = 16, 128, 7, 8
    halo = -(-2 * p // tr)
    assert ahead >= halo + 1
    t_in, t_out = -(-(n_out + 2 * p) // tr), -(-n_out // tr)
    slot = {}                                   # ring tile slot -> tile
    for t in range(ahead):
        if t < t_in:
            slot[t % (ring // tr)] = t
    for k in range(t_out):
        landed = k + halo            # groups done after the wait
        if k + ahead < t_in:
            slot[(k + ahead) % (ring // tr)] = k + ahead
        for o in range(k * tr, min((k + 1) * tr, n_out)):   # stored rows
            for d in (0, 1):         # lanes >= 1, lane 0
                for u in range(2 * p):                # u = (1 - a) + 2k
                    tile = (o + d + u) // tr
                    assert tile <= landed and tile < t_in
                    assert slot[((o + d + u) % ring) // tr] == tile


def test_analyzer_from_taps_and_chunked_call(rng):
    m = 16
    taps = rng.normal(size=5 * m - 3).astype(np.float32)
    ja = JPFBAnalyzer(m, taps, chunk_frames=24)
    ta = pfb.PFBAnalyzer(m, taps, chunk_frames=24)
    np.testing.assert_array_equal(ta.h_poly, np.asarray(ja.h_poly))
    x = rng.normal(size=(50 * (m // 2) + 3, 2)).astype(np.float32)
    np.testing.assert_allclose(ta(torch.from_numpy(x)).numpy(),
                               np.asarray(ja(jnp.asarray(x))), **TOL)


def test_channelizer_and_rrc_geometry():
    jz, tz = JChannelizer(FS, CENTER, sps=4), pfb.Channelizer(FS, CENTER, 4)
    assert (tz.n_chans, tz.rotation, tz.pfb_center_freq, tz.chan_rate) == \
        (jz.n_chans, jz.rotation, jz.pfb_center_freq, jz.chan_rate)
    np.testing.assert_array_equal(tz.analyzer.h_poly,
                                  np.asarray(jz.analyzer.h_poly))
    jr, tr = jz._rrc_resampler(1), tz._rrc_resampler(1)
    np.testing.assert_array_equal(tr.branches, jr.branches)
    fr = pfb.ArbResampler.from_branches(jr.ratio, jr.branches)
    for r in (tr, fr):
        for a, b in zip(r._geometry(5000), jr._geometry(5000)):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(r.window_geometry(3744, 3744),
                        jr.window_geometry(3744, 3744)):
            np.testing.assert_array_equal(a, b)
        k_t, w_t = r.window_matrix(3744, 3744)
        k_j, w_j = jr.window_matrix(3744, 3744)
        assert k_t == k_j
        np.testing.assert_array_equal(w_t, w_j)


def test_off_grid_rate_is_refused():
    """An off-grid rate that is not integral Hz has no exact rational
    ratio, so the streaming pre-resampler refuses it (integral-Hz
    off-grid rates are taken: tests/test_torch_wideband_paths.py)."""
    tz = pfb.Channelizer(900e3 + 0.5, CENTER)
    assert tz.pre_resamp is not None and tz.pre_resamp.ratio_frac is None
    with pytest.raises(ValueError):
        pfb.StreamPreResampler(tz.pre_resamp, 1000,
                               lambda n: np.zeros((0, 2), np.float32),
                               device="cpu")


def test_streamed_ingest_matches_jax(rng):
    """The port's ingest step, block by block with its carried state,
    against the JAX receiver's jitted step on the same blocks."""
    dummy = np.zeros((16, 2), np.float32)
    jrx = JRx(dummy, FS, CENTER, sps=4)
    trx = TRx(dummy, FS, CENTER, sps=4, device="cpu")
    assert (trx.n_block, trx.T_buf, trx.T_tail, trx.S_b) == \
        (jrx.n_block, jrx.T_buf, jrx.T_tail, jrx.S_b)
    j_state, t_state = jrx._state, trx._state
    for _ in range(3):
        x = rng.normal(size=(jrx.n_block, 2)).astype(np.float32)
        out = jrx._step(jnp.asarray(x), *j_state)
        j_stream, j_state = out[0], out[1:]
        t_stream, _rows, t_state = trx._step(torch.from_numpy(x), *t_state)
        np.testing.assert_allclose(t_stream.numpy(), np.asarray(j_stream),
                                   **TOL)
        for a, b in zip(t_state, j_state):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


@pytest.mark.parametrize("m,p,r_cnt", GEOMS)
def test_bf16_channel_dft_matches_pallas_interpret(rng, m, p, r_cnt):
    x, h_poly, hop = geom_case(rng, m, p, r_cnt)
    wa = jnp.asarray(pallas_pfb.slab_weights(h_poly, m, p, hop))
    want = np.asarray(_analyze_block_fused(jnp.asarray(x), wa, m, p, hop,
                                           interpret=True, dft_bf16=True))
    ana = pfb.PFBAnalyzer.from_numpy(h_poly)
    wa_t, dft, _dft16, qpar = ana._tables(torch.device("cpu"))
    a2 = pfb.branch_filter(torch.from_numpy(x), wa_t, r_cnt, hop)
    c2 = pfb.channel_dft(a2, dft, True)
    rpar = (torch.arange(r_cnt) & 1).to(torch.float32)
    c2 = c2 * (1.0 - 2.0 * rpar[:, None] * qpar[None, :])
    got = torch.stack([c2[:, :m], c2[:, m:]], dim=-1).numpy()
    peak = np.abs(want).max()
    assert np.abs(got - want).max() <= 1e-5 * peak
    # the bf16 product, not the f32 one: the f32 bank is far further off
    f32 = ana.block(torch.from_numpy(x)).numpy()
    assert np.abs(f32 - want).max() > 1e-4 * peak


@pytest.mark.parametrize("m,p,r_cnt", GEOMS)
def test_block_on_the_cpu_is_f32_whatever_dft_bf16(rng, m, p, r_cnt):
    """JAX's non-TPU path: the float32 product, bf16 asked for or not."""
    x, h_poly, _hop = geom_case(rng, m, p, r_cnt)
    xt = torch.from_numpy(x)
    on = pfb.PFBAnalyzer.from_numpy(h_poly)
    off = pfb.PFBAnalyzer.from_numpy(h_poly, dft_bf16=False)
    assert on.dft_bf16 and not off.dft_bf16
    assert torch.equal(on.block(xt), off.block(xt))
    wa, dft, _dft16, _qpar = off._tables(torch.device("cpu"))
    a2 = pfb.branch_filter(xt, wa, r_cnt, m // 2)
    assert torch.equal(pfb.channel_dft(a2, dft, False), a2 @ dft)


@pytest.mark.parametrize("m,p,r_cnt", GEOMS)
def test_block_packed_is_block_restacked(rng, m, p, r_cnt):
    x, h_poly, _hop = geom_case(rng, m, p, r_cnt)
    ana = pfb.PFBAnalyzer.from_numpy(h_poly)
    xt = torch.from_numpy(x)
    c2 = ana.block_packed(xt)
    assert c2.shape == (r_cnt, 2 * m)
    assert torch.equal(torch.stack([c2[:, :m], c2[:, m:]], dim=-1),
                       ana.block(xt))


def test_analyzer_carries_dft_bf16(rng):
    m = 16
    taps = rng.normal(size=3 * m).astype(np.float32)
    h_poly = np.asarray(JPFBAnalyzer(m, taps).h_poly)
    for flag in (True, False):
        assert pfb.PFBAnalyzer.from_numpy(h_poly, 64,
                                          dft_bf16=flag).dft_bf16 is flag
        assert pfb.PFBAnalyzer(m, taps, dft_bf16=flag).dft_bf16 is flag
    assert pfb.PFBAnalyzer.from_numpy(h_poly).dft_bf16
    assert pfb.Channelizer(FS, CENTER).analyzer.dft_bf16
    _wa, dft, dft16, _qpar = pfb.PFBAnalyzer(m, taps)._tables(
        torch.device("cpu"))
    assert dft16.dtype == torch.bfloat16 and torch.equal(
        dft16, dft.to(torch.bfloat16))
