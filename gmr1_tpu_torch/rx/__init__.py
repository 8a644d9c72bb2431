"""Receiver application layer (reference src/gmr1_rx.c, src/gsmtap.c;
counterpart of gmr1_tpu/rx/): capture sources, GSMTap output, the
per-carrier `Receiver` and the wideband receiver."""

from .cfile import CFile, load, save
from .gsmtap import GsmtapSink, make_packet
from .receiver import ChanDesc, Receiver


def __getattr__(name):
    # lazy: wideband pulls in the channelizer stack
    if name == "WidebandReceiver":
        from .wideband import WidebandReceiver
        return WidebandReceiver
    raise AttributeError(name)


__all__ = ["CFile", "load", "save", "GsmtapSink", "make_packet",
           "ChanDesc", "Receiver", "WidebandReceiver"]
