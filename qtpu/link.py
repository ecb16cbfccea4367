"""The classical channel between Alice and Bob.

Reference capability: ``remotecrypto/transferd.c`` (SURVEY.md §3 #8, §4.5) —
one authenticated TCP connection per party pair shipping opaque framed
messages both ways.

Two implementations of one interface (SURVEY.md §6.8 "inter-party channel"):

- `LoopbackLink` — both parties in one process, an in-memory queue pair; the
  test/integration mode (SURVEY.md §5.3).
- `TcpLink` — asyncio-free blocking socket channel with the same 4-byte
  length-prefixed framing the wire format already carries; one side listens,
  the other connects.  (A C++ transferd equivalent lives in
  qtpu/runtime/transferd — see qtpu.runtime.)

Links carry *bytes* (packed Messages); the pipeline layer owns semantics.
"""

from __future__ import annotations

import collections
import socket
import struct
from typing import Optional

from qtpu.messages import Message, pack_message, unpack_message

__all__ = ["DirectLink", "LoopbackLink", "TcpLink", "make_loopback_pair",
           "make_direct_pair"]


class DirectLink:
    """In-process channel passing Message OBJECTS by reference — device
    arrays inside messages (syndromes, hashes, test bits) never cross the
    host↔device boundary.  This is the honest single-machine model of a
    deployment where each party owns its accelerator and the classical
    channel is a NIC between the two hosts: serialization happens at the
    NIC, not on the accelerator's host link.

    ``auth_overhead_bits``: when > 0, every message charges that many bits
    of pre-shared/recycled secret key to ``consumed_bits`` — the ledger
    cost of the Wegman-Carter channel authentication an in-process link
    cannot physically perform (qtpu.auth.AuthedLink does the real MAC on
    serializing links; the KEY CONSUMPTION is what affects net key rate).
    """

    def __init__(self, tx: collections.deque, rx: collections.deque,
                 auth_overhead_bits: int = 0):
        self._tx = tx
        self._rx = rx
        self._auth = auth_overhead_bits
        self.consumed_bits = 0 if auth_overhead_bits else None
        self.messages_sent = 0
        self.messages_received = 0

    def send(self, msg: Message) -> None:
        if self._auth:
            self.consumed_bits += self._auth
        self.messages_sent += 1
        self._tx.append(msg)

    def recv(self, timeout: Optional[float] = None) -> Optional[Message]:
        if not self._rx:
            return None
        if self._auth:
            self.consumed_bits += self._auth
        self.messages_received += 1
        return self._rx.popleft()

    def pending(self) -> int:
        return len(self._rx)


def make_direct_pair(auth_overhead_bits: int = 0
                     ) -> tuple["DirectLink", "DirectLink"]:
    a_to_b: collections.deque = collections.deque()
    b_to_a: collections.deque = collections.deque()
    return (DirectLink(a_to_b, b_to_a, auth_overhead_bits),
            DirectLink(b_to_a, a_to_b, auth_overhead_bits))


class LoopbackLink:
    """One endpoint of an in-memory duplex channel."""

    def __init__(self, tx: collections.deque, rx: collections.deque):
        self._tx = tx
        self._rx = rx
        self.bytes_sent = 0
        self.bytes_received = 0

    def send_bytes(self, data: bytes) -> None:
        self.bytes_sent += len(data)
        self._tx.append(data)

    def recv_bytes(self, timeout: Optional[float] = None) -> Optional[bytes]:
        if not self._rx:
            return None
        data = self._rx.popleft()
        self.bytes_received += len(data)
        return data

    def send(self, msg: Message) -> None:
        self.send_bytes(pack_message(msg))

    def recv(self, timeout: Optional[float] = None) -> Optional[Message]:
        data = self.recv_bytes(timeout)
        return None if data is None else unpack_message(data)

    def pending(self) -> int:
        return len(self._rx)


def make_loopback_pair() -> tuple[LoopbackLink, LoopbackLink]:
    a_to_b: collections.deque = collections.deque()
    b_to_a: collections.deque = collections.deque()
    return LoopbackLink(a_to_b, b_to_a), LoopbackLink(b_to_a, a_to_b)


class TcpLink:
    """Blocking TCP message channel (transferd role) for two-process runs."""

    def __init__(self, sock: socket.socket):
        self._sock = sock
        # Generous buffers: one party may batch several windows of messages
        # while the peer is busy compiling/decoding (blocking sends on both
        # sides with tiny buffers would deadlock).
        for opt in (socket.SO_SNDBUF, socket.SO_RCVBUF):
            sock.setsockopt(socket.SOL_SOCKET, opt, 8 * 1024 * 1024)
        self.bytes_sent = 0
        self.bytes_received = 0

    @classmethod
    def listen(cls, host: str, port: int) -> "TcpLink":
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind((host, port))
        srv.listen(1)
        conn, _ = srv.accept()
        srv.close()
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return cls(conn)

    @classmethod
    def connect(cls, host: str, port: int, retries: int = 50) -> "TcpLink":
        import time
        last = None
        for _ in range(retries):
            try:
                s = socket.create_connection((host, port), timeout=5.0)
                s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                return cls(s)
            except OSError as e:
                last = e
                time.sleep(0.1)
        raise ConnectionError(f"could not connect to {host}:{port}: {last}")

    def send_bytes(self, data: bytes) -> None:
        # Sends must be fully blocking: a timeout inherited from a previous
        # recv() would abort sendall() mid-frame for payloads larger than the
        # socket buffer, desynchronizing the length-prefixed stream.
        self._sock.settimeout(None)
        self._sock.sendall(struct.pack("<I", len(data)) + data)
        self.bytes_sent += len(data) + 4

    def recv_bytes(self, timeout: Optional[float] = None) -> Optional[bytes]:
        # The timeout applies only to *waiting for a frame*; once the header
        # arrives, the payload is read blocking so a slow sender can't leave
        # us with a half-frame.
        self._sock.settimeout(timeout)
        try:
            head = self._recv_exact(4)
        except (socket.timeout, TimeoutError):
            return None
        self._sock.settimeout(None)
        (n,) = struct.unpack("<I", head)
        data = self._recv_exact(n)
        self.bytes_received += n + 4
        return data

    def send(self, msg: Message) -> None:
        self.send_bytes(pack_message(msg))

    def recv(self, timeout: Optional[float] = None) -> Optional[Message]:
        data = self.recv_bytes(timeout)
        return None if data is None else unpack_message(data)

    def _recv_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self._sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("peer closed")
            buf += chunk
        return buf

    def close(self) -> None:
        self._sock.close()
