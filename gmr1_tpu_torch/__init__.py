"""gmr1_tpu_torch — the GMR-1 receive framework in PyTorch, with
hand-written CUDA kernels for an NVIDIA Hopper card.

A port of the JAX package `gmr1_tpu`, which stays the reference: the
subpackages and modules mirror its names, module boundaries keep its
planar float32 (..., 2) layout, and the tests feed both packages the
same arrays.  Ported so far is the wideband control-channel receiver
(`rx.wideband.WidebandReceiver`): PFB channelization, FCCH acquisition,
BCCH/CCCH demodulation and decoding.

  ops/          bit/DSP primitives, conv codes, Viterbi
  sdr/          burst catalog, pi4-CxPSK modem, FCCH sync
  l1/           BCCH and CCCH channel coders
  channelizer/  polyphase filterbank channelizer
  rx/           receiver control loop, GSMTap output
  kernels/      CUDA sources of the Viterbi and PFB kernels, and their build

Importing the package loads no kernel: each is built and loaded at its
first launch on a CUDA tensor.
"""

__version__ = "0.1.0"
