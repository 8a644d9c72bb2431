"""GSMTap v2 output for decoded GMR-1 L2 frames.

Replaces the reference's libosmocore gsmtap sink (src/gsmtap.c:44-71 +
gsmtap_source_init at src/gmr1_rx.c:958): builds the 16-byte GSMTap v2
header with type GMR1_UM and sends over UDP (Wireshark-compatible),
and/or appends to a pcap file for offline inspection.
"""

from __future__ import annotations

import socket
import struct
import time

GSMTAP_VERSION = 2
GSMTAP_TYPE_GMR1_UM = 0x0A       # libosmocore gsmtap.h
GSMTAP_UDP_PORT = 4729

# GMR-1 sub-types (libosmocore gsmtap.h; usage gmr1_rx.c:318,433,793,845)
GMR1_UNKNOWN = 0x00
GMR1_BCCH = 0x01
GMR1_CCCH = 0x02
GMR1_PCH = 0x03
GMR1_AGCH = 0x04
GMR1_BACH = 0x05
GMR1_RACH = 0x06
GMR1_CBCH = 0x07
GMR1_SDCCH = 0x08
GMR1_TACCH = 0x09
GMR1_GBCH = 0x0A
GMR1_SACCH = 0x01                # OR'd with TCH6/9
GMR1_FACCH = 0x02                # OR'd with TCH3/6/9
GMR1_DKAB = 0x03                 # OR'd with TCH3
GMR1_TCH3 = 0x10
GMR1_TCH6 = 0x14
GMR1_TCH9 = 0x18


def make_packet(chan_type: int, fn: int, tn: int, l2: bytes,
                arfcn: int = 0) -> bytes:
    """GSMTap v2 header + payload (gsmtap.c:44-68 field-for-field).

    The reference hardcodes arfcn=0 (gmr1_rx decodes one anonymous
    cfile); the wideband receiver knows each carrier's ARFCN and tags
    it so Wireshark can tell carriers apart."""
    hdr = struct.pack(
        "!BBBBHbbIBBBB",
        GSMTAP_VERSION,          # version
        4,                       # hdr_len in 32-bit words
        GSMTAP_TYPE_GMR1_UM,     # type
        int(tn) & 0xFF,          # timeslot
        int(arfcn) & 0x3FFF,     # arfcn
        0,                       # signal_dbm
        0,                       # snr_db
        int(fn) & 0xFFFFFFFF,    # frame_number (BE)
        int(chan_type) & 0xFF,   # sub_type
        0,                       # antenna_nr
        0,                       # sub_slot
        0)                       # res
    return hdr + bytes(l2)


class GsmtapSink:
    """UDP + optional pcap emitter for GSMTap packets."""

    def __init__(self, host: str | None = "127.0.0.1",
                 port: int = GSMTAP_UDP_PORT, pcap_path: str | None = None):
        self.addr = (host, port) if host else None
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM) \
            if host else None
        self.pcap = open(pcap_path, "wb") if pcap_path else None
        self.sent = 0
        if self.pcap:
            # pcap global header, LINKTYPE_NULL=0 would need loopback
            # framing; use LINKTYPE_RAW(101) + IPv4/UDP encap
            self.pcap.write(struct.pack(
                "<IHHiIII", 0xA1B2C3D4, 2, 4, 0, 0, 65535, 101))

    def send(self, chan_type: int, fn: int, tn: int, l2,
             arfcn: int = 0) -> None:
        pkt = make_packet(chan_type, fn, tn, bytes(bytearray(l2)), arfcn)
        if self.sock is not None:
            try:
                self.sock.sendto(pkt, self.addr)
            except OSError:
                pass
        if self.pcap is not None:
            udp = struct.pack("!HHHH", 4729, GSMTAP_UDP_PORT,
                              8 + len(pkt), 0) + pkt
            ip = struct.pack("!BBHHHBBHII", 0x45, 0, 20 + len(udp), 0, 0,
                             64, 17, 0, 0x7F000001, 0x7F000001) + udp
            ts = time.time()
            self.pcap.write(struct.pack(
                "<IIII", int(ts), int((ts % 1) * 1e6), len(ip), len(ip)))
            self.pcap.write(ip)
        self.sent += 1

    def close(self) -> None:
        if self.sock is not None:
            self.sock.close()
        if self.pcap is not None:
            self.pcap.close()
