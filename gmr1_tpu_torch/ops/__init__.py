"""Bit-domain and DSP primitives, conv codes and the Viterbi decoder
(counterpart of gmr1_tpu/ops/), and the device-resident constant tables
they share (`consts`)."""
