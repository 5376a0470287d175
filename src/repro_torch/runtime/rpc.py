"""Length-prefixed RPC framing for process-isolated worker actors.

The :class:`~repro_torch.runtime.actor.WorkerActor` tier speaks a deliberately
tiny wire protocol over a unix-domain socket: every message is one *frame*

    +------------+--------+------------+----------------+
    | length u32 | op  u8 | req_id u64 | payload bytes  |
    +------------+--------+------------+----------------+

where ``length`` counts only the payload, ``op`` is one of :data:`OPCODES`,
and ``req_id`` multiplexes concurrent in-flight calls (replies carry the
request's id, so interleaved replies resolve out of order).  Payloads are
pickled python objects — numpy request/response dataclasses, metric dicts,
exceptions (which re-raise on the caller's side with their attributes
intact, e.g. ``AdmissionError.retry_after_ms``).

Everything that can go wrong on the wire raises :class:`ProtocolError`
*deterministically* instead of hanging or corrupting state:

* a frame longer than ``max_frame_bytes`` (oversized / garbage header);
* an unknown opcode (protocol drift or a corrupted stream);
* a truncated frame (peer died mid-write, or the fault layer's
  ``corrupt_reply`` drill);
* an unpicklable / corrupt payload.

The parent treats any :class:`ProtocolError` as worker death: the actor is
killed and the supervisor re-routes its in-flight requests — a byzantine
worker can cost its own life, never the fleet's liveness.  The codec is
pure (``encode_frame`` / :class:`FrameReader`) so the failure modes are
unit-testable without a process pair; the asyncio helpers
(:func:`read_frame` / :func:`write_frame`) are the thin I/O shims the actor
tier uses.
"""
from __future__ import annotations

import asyncio
import pickle
import struct

# one frame header: payload length (u32), opcode (u8), request id (u64)
HEADER = struct.Struct(">IBQ")

# submit/ping/metrics/drain/stop is the whole control surface; HELLO is the
# child's ready handshake, REPLY_* close the request/response pairs
OPCODES = {
    "hello": 1,
    "submit": 2,
    "submit_wave": 3,
    "ping": 4,
    "metrics": 5,
    "warmup": 6,
    "drain": 7,
    "stop": 8,
    "reply_ok": 9,
    "reply_err": 10,
}
OPCODE_NAMES = {v: k for k, v in OPCODES.items()}

# a whole image batch or an LM result list fits comfortably; anything
# larger is a corrupted length field, not a legitimate message
MAX_FRAME_BYTES = 64 * 1024 * 1024


class ProtocolError(RuntimeError):
    """The byte stream violated the frame protocol (truncated, oversized,
    unknown opcode, corrupt payload).  The connection is unrecoverable: the
    peer must be treated as dead."""


def encode_frame(opcode: int, req_id: int, obj,
                 max_frame_bytes: int = MAX_FRAME_BYTES) -> bytes:
    """One wire frame for ``obj`` (pickled)."""
    if opcode not in OPCODE_NAMES:
        raise ProtocolError(f"unknown opcode {opcode}")
    payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    if len(payload) > max_frame_bytes:
        raise ProtocolError(
            f"frame payload {len(payload)} bytes exceeds the "
            f"{max_frame_bytes}-byte frame cap"
        )
    return HEADER.pack(len(payload), opcode, req_id) + payload


def decode_header(buf: bytes,
                  max_frame_bytes: int = MAX_FRAME_BYTES
                  ) -> tuple[int, int, int]:
    """Validate + unpack one header -> (payload_len, opcode, req_id)."""
    length, opcode, req_id = HEADER.unpack(buf)
    if opcode not in OPCODE_NAMES:
        raise ProtocolError(
            f"unknown opcode {opcode} (req_id={req_id}); corrupted stream?"
        )
    if length > max_frame_bytes:
        raise ProtocolError(
            f"oversized frame: {length} bytes declared "
            f"(cap {max_frame_bytes}); corrupted length field?"
        )
    return length, opcode, req_id


def _loads(payload: bytes):
    try:
        return pickle.loads(payload)
    except Exception as e:
        raise ProtocolError(f"corrupt frame payload: {e!r}") from e


class FrameReader:
    """Incremental frame parser over a raw byte stream.

    ``feed(data)`` appends bytes; ``frames()`` yields every complete
    ``(opcode, req_id, obj)``; ``eof()`` must be called when the stream
    closes and raises :class:`ProtocolError` if it closed mid-frame (the
    truncated-frame case).  Pure — the unit tests drive every wire-level
    failure mode through this class without sockets.
    """

    def __init__(self, max_frame_bytes: int = MAX_FRAME_BYTES):
        self.max_frame_bytes = max_frame_bytes
        self._buf = bytearray()

    def feed(self, data: bytes) -> None:
        self._buf.extend(data)

    def frames(self):
        while True:
            if len(self._buf) < HEADER.size:
                return
            length, opcode, req_id = decode_header(
                bytes(self._buf[: HEADER.size]), self.max_frame_bytes
            )
            if len(self._buf) < HEADER.size + length:
                return  # wait for the rest of the payload
            payload = bytes(self._buf[HEADER.size: HEADER.size + length])
            del self._buf[: HEADER.size + length]
            yield opcode, req_id, _loads(payload)

    def eof(self) -> None:
        if self._buf:
            raise ProtocolError(
                f"truncated frame: stream closed with {len(self._buf)} "
                f"dangling bytes"
            )


async def read_frame(reader: asyncio.StreamReader,
                     max_frame_bytes: int = MAX_FRAME_BYTES
                     ) -> tuple[int, int, object]:
    """Read one complete frame -> (opcode, req_id, obj); raises
    :class:`ProtocolError` on truncation/corruption, ``EOFError`` on a
    clean close at a frame boundary."""
    try:
        head = await reader.readexactly(HEADER.size)
    except asyncio.IncompleteReadError as e:
        if not e.partial:
            raise EOFError("connection closed") from e
        raise ProtocolError(
            f"truncated frame header ({len(e.partial)}/{HEADER.size} bytes)"
        ) from e
    length, opcode, req_id = decode_header(head, max_frame_bytes)
    try:
        payload = await reader.readexactly(length)
    except asyncio.IncompleteReadError as e:
        raise ProtocolError(
            f"truncated frame payload ({len(e.partial)}/{length} bytes)"
        ) from e
    return opcode, req_id, _loads(payload)


async def write_frame(writer: asyncio.StreamWriter, opcode: int,
                      req_id: int, obj) -> None:
    writer.write(encode_frame(opcode, req_id, obj))
    await writer.drain()
