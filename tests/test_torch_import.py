"""Isolation and no-fallback rules of the port (gmr1_tpu_torch).

  * every module imports without JAX and without gmr1_tpu;
  * asking for CUDA where there is none raises — nothing quietly runs on
    the CPU instead;
  * the kernels' CUDA entry points refuse CPU tensors, and building a
    kernel without nvcc raises rather than falling back.
"""

import inspect
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from gmr1_tpu_torch import codec, kernels
from gmr1_tpu_torch.channelizer import pfb
from gmr1_tpu_torch.ops import viterbi
from gmr1_tpu_torch.rx import Receiver
from gmr1_tpu_torch.rx.__main__ import main as rx_main
from gmr1_tpu_torch.rx.wideband import WidebandReceiver

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "gmr1_tpu_torch"

IMPORT_ALL = """
import importlib, pkgutil, sys
import gmr1_tpu_torch
names = [m.name for m in pkgutil.walk_packages(gmr1_tpu_torch.__path__,
                                                "gmr1_tpu_torch.")]
# the entry points (the receiver, the vocoder, the channelizer and their
# CLI modules, the tools), every L1 coder and the multi-device form
for n in ("gmr1_tpu_torch.rx", "gmr1_tpu_torch.rx.__main__",
          "gmr1_tpu_torch.codec", "gmr1_tpu_torch.codec.__main__",
          "gmr1_tpu_torch.l1.xch_dc12", "gmr1_tpu_torch.l1.rach",
          "gmr1_tpu_torch.parallel", "gmr1_tpu_torch.parallel.ingest",
          "gmr1_tpu_torch.parallel.transponder", "gmr1_tpu_torch.ops.consts",
          "gmr1_tpu_torch.channelizer.ddc",
          "gmr1_tpu_torch.channelizer.__main__",
          "gmr1_tpu_torch.tools.gmr1_gen_mat",
          "gmr1_tpu_torch.tools.gmr1_rach_gen",
          "gmr1_tpu_torch.tools.gmr1_process_recording"):
    assert n in names, n
for n in names:
    importlib.import_module(n)
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "gmr1_tpu"))
print(len(names), bad)
sys.exit(1 if bad else 0)
"""


def test_port_imports_without_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", IMPORT_ALL], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert int(res.stdout.split()[0]) >= 30


def test_sources_name_no_jax():
    for path in PKG.rglob("*.py"):
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]):
                assert words[1].split(".")[0] not in ("jax", "gmr1_tpu"), \
                    (path, line)


def test_cuda_receiver_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="cuda"):
        WidebandReceiver(np.zeros((16, 2), np.float32), 500e3,
                         1525e6 + 31250.0 * 500, device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        Receiver(None, 4, device="cuda")


def test_entry_points_default_to_cuda():
    """The receivers and the streaming pre-resampler run on the card
    unless told otherwise: without CUDA their default device raises
    instead of running on the CPU."""
    for cls in (WidebandReceiver, Receiver, pfb.StreamPreResampler,
                codec.init):
        assert inspect.signature(cls).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="cuda"):
        WidebandReceiver(np.zeros((16, 2), np.float32), 500e3,
                         1525e6 + 31250.0 * 500)
    with pytest.raises(RuntimeError, match="cuda"):
        Receiver(None, 4)
    rr = pfb.Channelizer(900e3, 1525e6 + 31250.0 * 500).pre_resamp
    with pytest.raises(RuntimeError, match="cuda"):
        pfb.StreamPreResampler(rr, 1000,
                               lambda n: np.zeros((0, 2), np.float32))


def test_cli_device_defaults_to_cuda(tmp_path):
    """The CLI runs on the card unless told otherwise: without CUDA its
    default device raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    cap = tmp_path / "c.cfile"
    np.zeros(64, np.complex64).tofile(cap)
    with pytest.raises(RuntimeError, match="cuda"):
        rx_main(["4", str(cap), "--no-udp"])


def test_kernel_library_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    for name in kernels.KERNELS:
        with pytest.raises(RuntimeError):
            kernels.library(name)


def test_kernel_entry_points_refuse_cpu_tensors():
    sym = torch.zeros((2, 8, 2))
    sign = torch.ones((32, 2))
    with pytest.raises(ValueError):
        viterbi._decode_trellis_cuda(sym, sign, True)
    x = torch.zeros((100, 2))
    wa = torch.zeros((2 * 3, 4))
    with pytest.raises(ValueError):
        pfb._branch_filter_cuda(x, wa, 4, 4)
    assert viterbi.decode_trellis.launches == 0
    assert pfb.branch_filter.launches == 0


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        kernels.build("viterbi")


def test_unported_options_raise():
    """Every option of the JAX receiver is ported now (mesh and int16
    ingest since the multi-device slice): what still raises is what JAX
    refuses too, an unknown ingest dtype, int16 ingest at an off-grid
    rate, and an unknown CLI dtype."""
    wb = np.zeros((16, 2), np.float32)
    for fs, kw in ((500e3, dict(h2d_dtype="int8")),
                   (530e3, dict(h2d_dtype="int16"))):
        with pytest.raises(ValueError):
            WidebandReceiver(wb, fs, 1525e6 + 31250.0 * 500, device="cpu",
                             **kw)
    with pytest.raises(SystemExit):
        rx_main(["--wideband", "x.cfile", "--fs", "5e5", "--center",
                 "1.5e9", "--h2d-dtype", "int8", "--device", "cpu"])


def test_new_entry_points_default_to_cuda(tmp_path, monkeypatch):
    """The channelizer CLI, the tools and Mesh() run on the card unless
    told otherwise: without CUDA their defaults raise."""
    from gmr1_tpu_torch.channelizer.__main__ import main as chz_main
    from gmr1_tpu_torch.parallel import Mesh
    from gmr1_tpu_torch.tools import gmr1_gen_mat, gmr1_rach_gen
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    cap = tmp_path / "c.cfile"
    np.zeros(64, np.complex64).tofile(cap)
    monkeypatch.chdir(tmp_path)
    for call in (lambda: chz_main([str(cap), "-s", "5e5", "-f", "1.54e9",
                                   "-a", "500"]),
                 lambda: gmr1_gen_mat.main([]),
                 lambda: gmr1_rach_gen.main([str(tmp_path / "r.cfile"), "1",
                                             "00" * 18]),
                 lambda: Mesh()):
        with pytest.raises(RuntimeError, match="cuda"):
            call()
    assert not (tmp_path / "mat_G.pbm").exists()
