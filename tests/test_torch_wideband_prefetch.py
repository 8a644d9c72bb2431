"""The wideband receiver's block reader, ported: gmr1_tpu_torch's
WidebandReceiver reads, rotates and quantizes the next block on one worker
thread while the current block's phase is dispatched (JAX's `_q_start`,
gmr1_tpu/rx/wideband.py:724-749), on tests/test_wideband.py's e2e capture
(FS 500 kHz, M = 16), on the CPU.

  * with the worker, frames, speech and CSD equal gmr1_tpu's, for float32
    and int16 ingest, and equal a port run with the worker disabled;
  * the capture ends mid-block: the short read happens on the worker, and
    the EOF it pins gives JAX's stream length;
  * a source whose read raises on the worker makes run() raise, and the
    worker is shut down;
  * block_profs holds one section split a block-loop iteration; the
    main thread's outermost sections fit in the iteration's wall and
    every section in the ones it runs inside (gmr1_tpu_torch.trace's
    PARENT), the wait for the worker (`ingest_wait`) is one of them, and
    the worker's own time is kept apart (`reader_s`, one entry a job).

On the card the worker writes into pinned staging buffers and the upload
runs on a copy stream; chip_smoke.py's [slice] and [mesh] phases run
that form.
"""

import threading

import numpy as np
import pytest
import torch

from gmr1_tpu.rx.wideband import WidebandReceiver as JRx
from gmr1_tpu_torch import trace
from gmr1_tpu_torch.rx.cfile import ArraySource
from gmr1_tpu_torch.rx.wideband import WidebandReceiver as TRx

from tests.test_torch_wideband_traffic import e2e_capture
from tests.test_wideband import CENTER, FS

torch.set_num_threads(2)

SPS = 4
POOL_PREFIX = "gmr1-block-reader"


class RecordingSource(ArraySource):
    """ArraySource that records, for each read, whether the main thread
    made it and how many samples it returned; with `fail_at`, that read
    raises instead."""

    def __init__(self, data, fail_at: int | None = None):
        super().__init__(data)
        self.reads: list[tuple[bool, int]] = []
        self.fail_at = fail_at
        self.failed_on_main: bool | None = None

    def read(self, n: int) -> np.ndarray:
        on_main = threading.current_thread() is threading.main_thread()
        if len(self.reads) == self.fail_at:
            self.failed_on_main = on_main
            raise OSError("source read failed")
        out = super().read(n)
        self.reads.append((on_main, out.shape[0]))
        return out


def _same(trx, jrx):
    assert trx.frames == jrx.frames
    assert [c.arfcn for c in trx.carriers] == [c.arfcn for c in jrx.carriers]
    for jc, tc in zip(jrx.carriers, trx.carriers):
        assert (tc.speech, tc.csd) == (jc.speech, jc.csd), tc.arfcn
    assert any(c.csd for c in trx.carriers)


@pytest.fixture(scope="module")
def runs():
    wb, _truth = e2e_capture()
    out = dict(wb=wb)
    for dt in ("float32", "int16"):
        jrx = JRx(wb, FS, CENTER, sps=SPS, h2d_dtype=dt)
        jrx.run()
        src = RecordingSource(wb)
        trx = TRx(src, FS, CENTER, sps=SPS, device="cpu", h2d_dtype=dt)
        trx.run()
        out[dt] = (jrx, trx, src)
    src = RecordingSource(wb)
    off = TRx(src, FS, CENTER, sps=SPS, device="cpu")
    off._q_start = lambda: None                  # the worker disabled
    off.run()
    out["off"] = (off, src)
    return out


@pytest.mark.parametrize("dtype", ["float32", "int16"])
def test_same_as_jax_with_the_worker(runs, dtype):
    jrx, trx, src = runs[dtype]
    _same(trx, jrx)
    assert not all(on_main for on_main, _n in src.reads)
    assert trx._q_pool is None and trx._q_job is None


def test_same_as_without_the_worker(runs):
    _jrx, trx, _src = runs["float32"]
    off, src = runs["off"]
    assert all(on_main for on_main, _n in src.reads)
    assert off.frames == trx.frames
    for a, b in zip(off.carriers, trx.carriers):
        assert (a.speech, a.csd) == (b.speech, b.csd)
    assert off.n_stream == trx.n_stream


@pytest.mark.parametrize("dtype", ["float32", "int16"])
def test_mid_block_eof_pins_n_stream(runs, dtype):
    jrx, trx, src = runs[dtype]
    assert runs["wb"].shape[0] % trx.n_block
    short = [on_main for on_main, n in src.reads if n < trx.n_block]
    assert short and not short[0]            # the short read: on the worker
    assert trx._eof and trx.n_stream is not None
    assert (trx.n_stream, trx._n_in, trx._n_pulled) == \
        (jrx.n_stream, jrx._n_in, runs["wb"].shape[0])


def test_failing_read_fails_run(runs):
    _jrx, _trx, src = runs["float32"]
    first = next(i for i, (on_main, _n) in enumerate(src.reads)
                 if not on_main)
    bad = RecordingSource(runs["wb"], fail_at=first)
    rx = TRx(bad, FS, CENTER, sps=SPS, device="cpu")
    with pytest.raises(OSError, match="source read failed"):
        rx.run()
    assert bad.failed_on_main is False
    assert rx._q_pool is None and rx._q_job is None
    assert not [t for t in threading.enumerate()
                if t.name.startswith(POOL_PREFIX)]


def test_block_profs_one_dict_per_iteration(runs):
    _jrx, trx, _src = runs["float32"]
    assert len(trx.block_profs) == len(trx.block_walls) > 0
    for prof, wall in zip(trx.block_profs, trx.block_walls):
        assert set(prof) <= set(trx.prof)
        assert all(v > 0.0 for v in prof.values())
        # sections nest: the outermost ones fit in the wall, and each
        # other one in the sections it runs inside (ingest_wait in ingest)
        assert sum(trace.top_level(prof).values()) <= wall
        for k, v in prof.items():
            held = [prof[p] for p in trace.PARENT.get(k, ()) if p in prof]
            assert not held or v <= sum(held) + 1e-9, k
    assert trace.PARENT["ingest_wait"] == ("ingest",)
    assert "ingest_wait" in trx.prof and "reader" not in trx.prof
    assert trx.reader_s and all(t > 0.0 for t in trx.reader_s)
    for k in trx.prof:
        # the acquisition's sections, and those that also run inside it
        if k != "acquire" and "acquire" not in _holders(k):
            assert sum(p.get(k, 0.0) for p in trx.block_profs) \
                == pytest.approx(trx.prof[k])


def _holders(k: str) -> set:
    """Every section that section k can run inside, at any depth."""
    out = set(trace.PARENT.get(k, ()))
    for p in list(out):
        out |= _holders(p)
    return out
