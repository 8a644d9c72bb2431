"""Receiver application layer: capture sources, GSMTap output, channel
state and the wideband control-channel receiver (counterpart of
gmr1_tpu/rx/)."""
