"""Wideband capture front-end: ARFCN grid model, polyphase filterbank
channelizer and per-carrier RRC resampler geometry (counterpart of
gmr1_tpu/channelizer/)."""
