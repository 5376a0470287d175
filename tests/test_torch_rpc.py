"""The port's actor RPC frame codec (``repro_torch.runtime.rpc``) against
the reference's (``repro.runtime.rpc``).

Both codecs run on the same inputs: the same (opcode, req_id, payload of
ints, lists and numpy arrays) must encode to the same bytes, and every
wire-level failure — a truncated frame, a garbage or oversized header, an
unknown opcode, a corrupt payload — must raise each package's
``ProtocolError``, never hang or hand back a wrong object.  The codec is
pure, so these run without sockets or processes; the process-level
integration is in ``test_torch_actor.py``.
"""
import asyncio
import pickle
import struct

import numpy as np
import pytest

from repro.runtime import rpc as jrpc
from repro_torch.runtime import rpc
from repro_torch.runtime.batching import AdmissionError

OP = rpc.OPCODES
CODECS = [pytest.param(rpc, id="port"), pytest.param(jrpc, id="reference")]


def _one(reader):
    frames = list(reader.frames())
    assert len(frames) == 1
    return frames[0]


def test_wire_contract_is_the_references():
    assert rpc.OPCODES == jrpc.OPCODES
    assert rpc.HEADER.format == jrpc.HEADER.format and rpc.HEADER.size == 13
    assert rpc.MAX_FRAME_BYTES == jrpc.MAX_FRAME_BYTES


PAYLOADS = [
    pytest.param("submit", 42, {
        "payload": np.arange(12, dtype=np.float32).reshape(3, 4),
        "uid": 7, "deadline_ms": None, "kwargs": {"max_new_tokens": 3}},
        id="submit-image"),
    pytest.param("submit_wave", 2**40, {
        "payloads": [[1, 2, 3], [4, 5]], "kwargs": {}}, id="wave-prompts"),
    pytest.param("reply_ok", 9, [np.int8(-3), np.zeros((2, 2), np.int32),
                                 list(range(50))], id="reply-list"),
    pytest.param("ping", 1, None, id="ping"),
    pytest.param("warmup", 5, ((28, 28, 1), "float32"), id="warmup-spec"),
]


@pytest.mark.parametrize("opname,rid,obj", PAYLOADS)
def test_encode_frame_bytes_equal_the_references(opname, rid, obj):
    buf = rpc.encode_frame(OP[opname], rid, obj)
    assert buf == jrpc.encode_frame(jrpc.OPCODES[opname], rid, obj)
    for codec in (rpc, jrpc):  # each decodes the other's frame
        r = codec.FrameReader()
        r.feed(buf)
        opcode, got_rid, out = _one(r)
        assert (opcode, got_rid) == (OP[opname], rid)
        assert pickle.dumps(out) == pickle.dumps(obj)
        r.eof()  # clean boundary: no dangling bytes


def test_byte_at_a_time_reassembly():
    buf = rpc.encode_frame(OP["ping"], 1, None)
    r = rpc.FrameReader()
    for i in range(len(buf) - 1):
        r.feed(buf[i:i + 1])
        assert list(r.frames()) == []  # incomplete: nothing yielded
    r.feed(buf[-1:])
    assert _one(r)[:2] == (OP["ping"], 1)


def test_interleaved_replies_multiplex_by_req_id():
    buf = (rpc.encode_frame(OP["reply_ok"], 9, "second")
           + rpc.encode_frame(OP["reply_ok"], 3, "first")
           + rpc.encode_frame(OP["reply_err"], 5, ValueError("boom")))
    r = rpc.FrameReader()
    r.feed(buf)
    frames = list(r.frames())
    assert [(op, rid) for op, rid, _ in frames] == [
        (OP["reply_ok"], 9), (OP["reply_ok"], 3), (OP["reply_err"], 5)]
    assert frames[0][2] == "second" and frames[1][2] == "first"
    assert isinstance(frames[2][2], ValueError)


def _truncated(codec):
    buf = codec.encode_frame(OP["submit"], 1, {"x": list(range(100))})
    r = codec.FrameReader()
    r.feed(buf[:len(buf) // 2])
    assert list(r.frames()) == []  # waiting for the rest...
    r.eof()  # ...but the stream closed mid-frame


def _garbage_header(codec):  # the fault layer's "garbage" reply
    r = codec.FrameReader()
    r.feed(b"\xff" * codec.HEADER.size)
    list(r.frames())


def _oversized(codec):
    r = codec.FrameReader(max_frame_bytes=1024)
    r.feed(codec.HEADER.pack(2**31, OP["submit"], 1))
    list(r.frames())


def _unknown_opcode(codec):
    r = codec.FrameReader()
    r.feed(codec.HEADER.pack(0, 255, 1))
    list(r.frames())


def _corrupt_payload(codec):
    garbage = b"\x00not-a-pickle"
    r = codec.FrameReader()
    r.feed(codec.HEADER.pack(len(garbage), OP["reply_ok"], 1) + garbage)
    list(r.frames())


def _encode_unknown_opcode(codec):
    codec.encode_frame(99, 1, None)


def _encode_over_cap(codec):
    codec.encode_frame(OP["submit"], 1, b"x" * 2048, max_frame_bytes=1024)


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("fault,match", [
    (_truncated, "truncated"), (_garbage_header, "unknown opcode"),
    (_oversized, "oversized"), (_unknown_opcode, "unknown opcode"),
    (_corrupt_payload, "corrupt frame payload"),
    (_encode_unknown_opcode, "unknown opcode"),
    (_encode_over_cap, "frame cap")], ids=lambda f: getattr(f, "__name__",
                                                            None))
def test_wire_faults_raise_protocol_error_in_both(codec, fault, match):
    with pytest.raises(codec.ProtocolError, match=match):
        fault(codec)


def test_header_layout_is_stable():
    length, opcode, rid = struct.unpack(
        ">IBQ", rpc.encode_frame(OP["stop"], 2**40, None)[:13])
    assert opcode == OP["stop"] and rid == 2**40


def test_admission_error_keeps_retry_after_ms_through_a_frame():
    # the load-shedding hint survives the pickle hop: supervisor brownout
    # decisions read it off the re-raised exception
    buf = rpc.encode_frame(
        OP["reply_err"], 1, AdmissionError("full", retry_after_ms=5.0))
    r = rpc.FrameReader()
    r.feed(buf)
    _, _, exc = _one(r)
    assert isinstance(exc, AdmissionError) and exc.retry_after_ms == 5.0


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("case", ["header", "payload", "clean_eof",
                                  "roundtrip"])
def test_async_read_frame(codec, case):
    async def run():
        reader = asyncio.StreamReader()
        if case == "header":
            reader.feed_data(b"\x00\x01\x02")  # 3 of 13 header bytes
        elif case == "payload":
            buf = codec.encode_frame(OP["reply_ok"], 1, list(range(50)))
            reader.feed_data(buf[:-5])
        elif case == "roundtrip":
            reader.feed_data(codec.encode_frame(OP["hello"], 0, {"pid": 1}))
        reader.feed_eof()
        if case == "roundtrip":
            assert await codec.read_frame(reader) == (OP["hello"], 0,
                                                      {"pid": 1})
        elif case == "clean_eof":
            with pytest.raises(EOFError):
                await codec.read_frame(reader)
        else:
            with pytest.raises(codec.ProtocolError, match="truncated frame"):
                await codec.read_frame(reader)

    asyncio.run(run())
