"""gmr1_tpu_torch — the GMR-1 receive framework in PyTorch, with
hand-written CUDA kernels for an NVIDIA Hopper card.

A port of the JAX package `gmr1_tpu`, which stays the reference: the
subpackages and modules mirror its names, module boundaries keep its
planar float32 (..., 2) layout, and the tests feed both packages the
same arrays.  Ported so far is the wideband receiver
(`rx.wideband.WidebandReceiver`): PFB channelization, FCCH acquisition,
BCCH/CCCH, and the TCH3 (speech, FACCH3, DKAB) and TCH9 (FACCH9, CSD)
traffic channels.

  ops/          bit/DSP primitives, conv codes, Viterbi, interleaving,
                puncturing, A5/1
  sdr/          burst catalog, pi4-CxPSK modem, FCCH sync, DKAB
  l1/           BCCH, CCCH, TCH3, FACCH3, FACCH9 and TCH9 channel coders
  channelizer/  polyphase filterbank channelizer
  rx/           receiver control loop, GSMTap output
  kernels/      CUDA sources of the Viterbi, PFB and A5/1 kernels, and
                their build

Importing the package loads no kernel: each is built and loaded at its
first launch on a CUDA tensor.  The entry points run on the card unless
the caller asks for the CPU (`device="cpu"`).
"""

import torch

__version__ = "0.1.0"


def checked_device(device) -> torch.device:
    """torch.device(device); a CUDA device on a machine without CUDA
    raises instead of quietly running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={str(device)!r} was asked for, but "
                           "torch.cuda.is_available() is false (pass "
                           "device='cpu' to run on the CPU)")
    return dev
