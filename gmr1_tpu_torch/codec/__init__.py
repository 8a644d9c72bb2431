"""AMBE speech vocoder (reference src/codec/, SURVEY.md §2.3; counterpart
of gmr1_tpu.codec).

Batched functional decoder: 10-byte AMBE frames -> 8 kHz int16 PCM, in
plain PyTorch on the card (or the CPU).

    from gmr1_tpu_torch import codec
    state = codec.init((n_channels,), device="cuda")
    state, pcm = codec.decode_frames(state, frames)  # (B, T, 10) -> (B, T, 160)
"""

from .codec import CodecState, decode_dtx, decode_frame, decode_frames, init

__all__ = ["CodecState", "decode_dtx", "decode_frame", "decode_frames",
           "init"]
