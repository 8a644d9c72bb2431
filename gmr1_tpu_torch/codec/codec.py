"""Public AMBE codec API (reference src/codec/codec.c + ambe.c;
counterpart of gmr1_tpu/codec/codec.py).

Functional and batched: decoder state is an explicit NamedTuple of
tensors on one device, and one 10-byte frame per channel per step
produces 160 samples of 8 kHz PCM.  The frame-type dispatch (speech /
silence / tone, ambe.c:65-78) is branch-free: every path is computed
and each channel's result selected, so one sequence of batched
operations serves a whole batch of voice channels.

    state = codec.init((n_channels,), device="cuda")
    state, pcm = codec.decode_frames(state, frames)   # (B, T, 10) -> (B, T, 160)
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import checked_device
from . import frame as F
from . import synth as S
from . import tone as TN


class CodecState(NamedTuple):
    sf_prev: F.Subframe
    synth: S.SynthState
    tone_phase_f1: torch.Tensor
    tone_phase_f2: torch.Tensor


def init(batch_shape=(), device="cuda") -> CodecState:
    """The decoder state of a batch of channels on `device` (the card by
    default; without CUDA that raises: pass device="cpu")."""
    dev = checked_device(device)
    z = torch.zeros(batch_shape, dtype=torch.float32, device=dev)
    return CodecState(sf_prev=F.init_subframe(batch_shape, dev),
                      synth=S.init_state(batch_shape, dev),
                      tone_phase_f1=z, tone_phase_f2=z)


def _decode_speech(state: CodecState, frames):
    """ambe_decode_speech (ambe.c:88-118): returns (state', pcm float)."""
    rp = F.unpack_raw(frames)
    sf0, sf1 = F.decode_params(rp, state.sf_prev)
    sf0 = F.expand(sf0)
    sf1 = F.expand(sf1)

    syn = state.synth
    syn, sf0 = S.enhance(syn, sf0)
    syn, a0 = S.audio(syn, sf0, state.sf_prev)
    syn, sf1 = S.enhance(syn, sf1)
    syn, a1 = S.audio(syn, sf1, sf0)

    pcm = torch.cat([a0, a1], dim=-1)                 # (..., 160)
    return state._replace(sf_prev=sf1, synth=syn), pcm


def decode_frame(state: CodecState, frames) -> tuple[CodecState, torch.Tensor]:
    """One frame per channel: (..., 10) uint8 -> (state', (..., 160) int16).

    Speech / silence / tone classified on frame[0] & 0xfc
    (ambe_classify_frame, ambe.c:65-78)."""
    frames = torch.as_tensor(frames).to(device=state.tone_phase_f1.device,
                                        dtype=torch.uint8)
    top = frames[..., 0] & 0xFC
    is_tone = top == 0xFC
    is_silence = top == 0xF8
    is_speech = ~(is_tone | is_silence)

    sp_state, sp_pcm = _decode_speech(state, frames)
    t1, t2, tone_pcm, _tone_ok = TN.decode_tone(
        state.tone_phase_f1, state.tone_phase_f2, frames)

    # merge: speech updates sf_prev/synth; tone updates tone phases;
    # silence leaves state untouched and outputs zeros.
    def sel_speech(new, old):
        m = is_speech.reshape(is_speech.shape
                              + (1,) * (new.ndim - is_speech.ndim))
        return torch.where(m, new, old)

    merged = CodecState(
        sf_prev=F.Subframe(*map(sel_speech, sp_state.sf_prev,
                                state.sf_prev)),
        synth=S.SynthState(*map(sel_speech, sp_state.synth, state.synth)),
        tone_phase_f1=torch.where(is_tone, t1, state.tone_phase_f1),
        tone_phase_f2=torch.where(is_tone, t2, state.tone_phase_f2))

    pcm_f = torch.where(is_speech[..., None], sp_pcm,
                        torch.where(is_tone[..., None], tone_pcm, 0.0))
    # the reference casts each float sample straight to int16
    # (synth.c:388, tone.c:110): truncate toward zero, wrap like C.
    pcm = torch.trunc(pcm_f).to(torch.int32).to(torch.int16)
    return merged, pcm


def decode_frames(state: CodecState, frames) -> tuple[CodecState,
                                                      torch.Tensor]:
    """Decode a stream: frames (..., T, 10) -> (state', (..., T, 160)).

    A loop over the T frames on the state's device (the frame chain is
    sequential through sf_prev/synth; the parallelism is the channel
    batch).  Nothing in it waits for the device."""
    frames = torch.as_tensor(frames).to(device=state.tone_phase_f1.device,
                                        dtype=torch.uint8)
    pcm = []
    for t in range(frames.shape[-2]):
        state, p = decode_frame(state, frames[..., t, :])
        pcm.append(p)
    return state, torch.stack(pcm, dim=-2)


def decode_dtx(state: CodecState, n: int = 160):
    """DTX comfort noise period (ambe_decode_dtx: silence for now,
    matching the reference's FIXME, ambe.c:154-161)."""
    z = state.tone_phase_f1
    return state, torch.zeros((*z.shape, n), dtype=torch.int16,
                              device=z.device)
