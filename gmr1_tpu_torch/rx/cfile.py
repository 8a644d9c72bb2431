"""Capture-file IO (replaces libosmodsp cfile_load, SURVEY.md §2.6).

A .cfile is raw interleaved complex64 (float32 re, im) — exactly the
framework's planar layout, so loading is a zero-copy mmap viewed as
(N, 2) float32.  Burst windows are then numpy slices of the map; only
the slices actually demodulated are ever transferred to the device.
"""

from __future__ import annotations

import numpy as np


class ArrayStream:
    """CFile-compatible view over an in-memory planar (N, 2) stream —
    lets the Receiver run over channelizer output without a file."""

    def __init__(self, data: np.ndarray):
        self.data = np.asarray(data, np.float32)
        assert self.data.ndim == 2 and self.data.shape[1] == 2

    def __len__(self) -> int:
        return self.data.shape[0]

    def window(self, begin: int, length: int) -> np.ndarray:
        """Planar slice [begin, begin+length), or None if out of range."""
        if begin < 0 or begin + length > len(self):
            return None
        return self.data[begin:begin + length]


class CFile(ArrayStream):
    """mmap'd capture: planar float32 (n_samples, 2) view."""

    def __init__(self, path: str):
        self.path = path
        raw = np.memmap(path, dtype=np.float32, mode="r")
        if raw.size % 2:
            raw = raw[:-1]
        self.data = raw.reshape(-1, 2)


class SampleSource:
    """Sequential sample source for streamed receive (the role of the
    reference's live osmosdr source, utils/gmr1_rx_sdr.py:814-1068).

    `read(n)` returns the next planar (m, 2) float32 block with m <= n;
    m < n signals end-of-stream.  No rewind — the receiver buffers the
    acquisition prefix itself."""

    def read(self, n: int) -> np.ndarray:
        raise NotImplementedError


class CFileSource(SampleSource):
    """Streamed .cfile reader: mmap'd, but consumed strictly forward in
    blocks — the receiver never holds the whole capture."""

    def __init__(self, path: str):
        self._f = CFile(path)
        self._pos = 0

    def read(self, n: int) -> np.ndarray:
        out = self._f.data[self._pos:self._pos + n]
        self._pos += out.shape[0]
        return out


class ArraySource(SampleSource):
    """SampleSource over an in-memory array (tests, synthetic feeds)."""

    def __init__(self, data: np.ndarray):
        if data.ndim == 1:
            data = np.stack([data.real, data.imag], axis=-1)
        self._d = np.asarray(data, np.float32)
        self._pos = 0

    def read(self, n: int) -> np.ndarray:
        out = self._d[self._pos:self._pos + n]
        self._pos += out.shape[0]
        return out


class SocketSource(SampleSource):
    """Live sample source over a TCP stream of interleaved complex64
    (raw cf32, the wire format rtl_tcp-style IQ servers and GNURadio
    file/TCP sinks emit) — the headless role of the reference
    flowgraph's osmosdr hardware source (utils/gmr1_rx_sdr.py:814-868):
    samples arrive continuously, are consumed strictly forward, and the
    receiver never sees the capture as a whole.

    `read(n)` blocks until n samples arrived or the peer closed; a
    short read signals end-of-stream (same contract as every other
    SampleSource).  `timeout` (seconds) bounds how long a stalled peer
    may hold the receiver: on expiry the stream is treated as ended
    (short read), matching a peer close."""

    def __init__(self, host: str, port: int, timeout: float | None = None):
        import socket
        self._sock = socket.create_connection((host, port))
        if timeout is not None:
            self._sock.settimeout(timeout)
        self._rem = b""

    def read(self, n: int) -> np.ndarray:
        import socket
        need = n * 8                       # complex64
        parts, got = [self._rem], len(self._rem)
        while got < need:
            try:
                chunk = self._sock.recv(min(1 << 20, need - got))
            except socket.timeout:
                chunk = b""                # stalled peer -> end-of-stream
            if not chunk:
                break
            parts.append(chunk)
            got += len(chunk)
        buf = b"".join(parts)
        take = (min(got, need) // 8) * 8
        self._rem = buf[take:]
        out = np.frombuffer(buf[:take], np.float32).reshape(-1, 2)
        return out

    def close(self) -> None:
        self._sock.close()


class BoundedStream:
    """ArrayStream-compatible sliding window over a streamed feed.

    Absolute indexing: `window(begin, length)` addresses positions in
    the full logical stream; positions older than the trimmed base and
    positions past the fed frontier both return None.  `len()` is the
    current frontier, which equals the total stream length once the
    feed ends — so the Receiver's end-of-capture bound checks behave
    exactly as over the fully materialized array.

    This is the streaming role of the reference flowgraph's per-carrier
    output queue between the channelizer and each decoder process
    (utils/gmr1_rx_sdr.py:566-589): the producer `feed`s chunks, the
    consumer decodes forward and `trim`s what it can never revisit, so
    retained memory is O(consumer lag), not O(capture).
    """

    def __init__(self):
        self._base = 0
        self._buf = np.zeros((0, 2), np.float32)
        self.high_water = 0       # max retained samples (memory telemetry)

    def __len__(self) -> int:
        return self._base + self._buf.shape[0]

    def feed(self, chunk: np.ndarray) -> None:
        if self._buf.shape[0]:
            chunk = np.asarray(chunk, np.float32)
            self._buf = np.concatenate([self._buf, chunk])
        else:
            # copy on the aliasing path: a producer that reuses its
            # buffer after feeding must not corrupt retained samples
            self._buf = np.array(chunk, np.float32, copy=True)
        self.high_water = max(self.high_water, self._buf.shape[0])

    def trim(self, keep_from: int) -> None:
        """Drop samples before absolute position keep_from."""
        cut = min(max(keep_from - self._base, 0), self._buf.shape[0])
        if cut:
            self._buf = self._buf[cut:]
            self._base += cut

    def window(self, begin: int, length: int) -> np.ndarray | None:
        if begin < self._base or begin + length > len(self):
            return None
        b = begin - self._base
        return self._buf[b:b + length]


def load(path: str) -> CFile:
    return CFile(path)


def save(path: str, planar: np.ndarray) -> None:
    """Write planar (..., 2) float32 as a .cfile (osmo_cxvec_dbg_dump
    equivalent, used by the RACH generator tool)."""
    np.asarray(planar, np.float32).tofile(path)
