"""The port's ``WFFT`` wire protocol (``repro_torch.serve.protocol``)
against the reference's (``repro.serve.protocol``).

The wire is the contract: for the same metadata and arrays both packages
pack the same bytes, each decodes the other's frames, and every fuzz
input of ``tests/test_protocol_fuzz.py`` (random, mutated, truncated and
lying frames) has the same outcome in both — the same frame, or a typed
``ProtocolError`` in each. Plus the reference's own protocol cases
(``tests/test_serve_service.py``) on the port, the frame cap (a complex64
512^3 array is refused by both before a frame exists), clean against
mid-frame EOF on a socket pair, and the fault hooks.
"""
import json
import random
import socket
import threading

import numpy as np
import pytest

import repro.serve.protocol as jproto
import repro_torch.serve.protocol as proto
from repro_torch.serve import FaultInjected, FaultPlan, FaultPoint

RNG = np.random.default_rng(31)


def _array(dtype, shape=(2, 3, 4)):
    x = RNG.standard_normal(shape) * 100
    if np.issubdtype(np.dtype(dtype), np.complexfloating):
        x = x + 1j * RNG.standard_normal(shape)
    return x.astype(dtype)


def _valid_frames(p):
    """The fuzz suite's spread of well-formed frames, packed by ``p``."""
    return [
        p.pack_frame(p.HELLO, {'tenant': 'fuzz', 'client_id': 'c'}),
        p.pack_frame(p.SUBMIT, {'req_id': 1, 'direction': 'fwd', 'key': 'c/1'},
                     [np.arange(64, dtype=np.complex64).reshape(8, 8)]),
        p.pack_frame(p.RESULT, {'req_id': 2, 'form': 'planar'},
                     [np.ones((4, 4), np.float32), np.zeros((4, 4), np.float32)]),
        p.pack_frame(p.HEARTBEAT, {}),
        p.pack_frame(p.RELOAD, {'req_id': 3, 'tenants': [{'name': 't', 'weight': 2.0}]}),
        p.pack_frame(p.ERROR, {'kind': 'protocol', 'error': 'x'}),
    ]


def _outcome(p, buf):
    """What ``p.unpack_frame`` makes of ``buf``: ('error',) for a typed
    rejection, else the frame (arrays as (dtype, shape, bytes))."""
    try:
        msg_type, meta, arrays, consumed = p.unpack_frame(buf)
    except p.ProtocolError as exc:
        return ('error', type(exc).__name__)
    return (msg_type, json.dumps(meta, sort_keys=True), consumed,
            [(a.dtype.str, a.shape, a.tobytes()) for a in arrays])


def _same_outcome(buf):
    out = _outcome(proto, buf)
    assert out == _outcome(jproto, buf)
    return out


# ---------------------------------------------------------------------------
# The contract: constants and bytes
# ---------------------------------------------------------------------------

def test_wire_constants_are_the_references():
    assert proto.PROTOCOL_VERSION == jproto.PROTOCOL_VERSION == 1
    assert proto.MAGIC == jproto.MAGIC == b'WFFT'
    assert proto._HEADER.format == jproto._HEADER.format == '!4sBBHQ'
    assert proto._JLEN.format == jproto._JLEN.format
    assert proto.MAX_FRAME_BYTES == jproto.MAX_FRAME_BYTES == 1 << 30
    assert proto.WIRE_DTYPES == jproto.WIRE_DTYPES
    assert proto.MSG_NAMES == jproto.MSG_NAMES
    assert sorted(proto.MSG_NAMES) == list(range(1, 15))


@pytest.mark.parametrize("form", ['array', 'planar'])
@pytest.mark.parametrize("dtype", sorted(proto.WIRE_DTYPES))
def test_pack_frame_is_byte_identical(dtype, form):
    arrays = [_array(dtype)] if form == 'array' else [_array(dtype), _array(dtype)]
    meta = {'req_id': 7, 'direction': 'fwd', 'form': form, 'key': 'c/1',
            'slo': 'interactive', 'nested': {'a': [1, 2.5, None]}}
    for msg_type in (proto.SUBMIT, proto.RESULT):
        assert proto.pack_frame(msg_type, meta, arrays) == jproto.pack_frame(msg_type, meta,
                                                                            arrays)


@pytest.mark.parametrize("case", ['empty', 'scalar', 'strided', 'fortran', 'zero_size',
                                  'unicode'])
def test_pack_frame_is_byte_identical_on_edge_operands(case):
    base = _array('float32', (4, 6))
    meta, arrays = {'req_id': 1}, []
    if case == 'scalar':
        arrays = [np.array(3.5, dtype=np.float32)]
    elif case == 'strided':
        arrays = [base[:, ::2]]
    elif case == 'fortran':
        arrays = [np.asfortranarray(base)]
    elif case == 'zero_size':
        arrays = [np.zeros((0, 3), np.complex64)]
    elif case == 'unicode':
        meta = {'tenant': 'héllo→', 'error': 'ü' * 3}
    assert proto.pack_frame(proto.RESULT, meta, arrays) == jproto.pack_frame(
        proto.RESULT, meta, arrays)
    metas, blobs = proto.encode_arrays(arrays)
    jmetas, jblobs = jproto.encode_arrays(arrays)
    assert (metas, blobs) == (jmetas, jblobs)


@pytest.mark.parametrize("packer, unpacker", [(proto, jproto), (jproto, proto)],
                         ids=['port->reference', 'reference->port'])
@pytest.mark.parametrize("dtype", sorted(proto.WIRE_DTYPES))
def test_each_package_decodes_the_others_frames(packer, unpacker, dtype):
    arrays = [_array(dtype), _array(dtype, (5,))]
    meta = {'req_id': 3, 'form': 'planar'}
    buf = packer.pack_frame(packer.RESULT, meta, arrays)
    msg_type, got_meta, got, consumed = unpacker.unpack_frame(buf)
    assert (msg_type, got_meta, consumed) == (unpacker.RESULT, meta, len(buf))
    for a, b in zip(arrays, got):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("i", range(6))
def test_valid_frames_are_the_references(i):
    assert _valid_frames(proto)[i] == _valid_frames(jproto)[i]
    _same_outcome(_valid_frames(proto)[i])


# ---------------------------------------------------------------------------
# The frame cap
# ---------------------------------------------------------------------------

def test_complex_512_cubed_is_refused_by_both_packages():
    """A complex64 512^3 array is 2^30 bytes: with the JSON header the
    payload passes ``MAX_FRAME_BYTES``, so neither package builds a
    frame; the port refuses from the descriptors, before copying."""
    big = np.zeros((512, 512, 512), np.complex64)
    assert big.nbytes == proto.MAX_FRAME_BYTES
    for p in (proto, jproto):
        with pytest.raises(p.ProtocolError, match="exceeds the 1073741824-byte cap"):
            p.pack_frame(p.SUBMIT, {'req_id': 1}, [big])
    # the largest real request the service serves fits: 512^3 float32
    # in, its (512, 512, 257) complex64 spectrum out
    spec = np.zeros((512, 512, 257), np.complex64)
    assert spec.nbytes == 538_968_064 < proto.MAX_FRAME_BYTES


def test_oversize_frame_rejected_without_allocation():
    head = proto._HEADER.pack(proto.MAGIC, proto.PROTOCOL_VERSION, proto.SUBMIT, 0,
                              proto.MAX_FRAME_BYTES + 1)
    with pytest.raises(proto.ProtocolError, match="cap"):
        proto._parse_header(head)


# ---------------------------------------------------------------------------
# The reference's protocol cases (tests/test_serve_service.py) on the port
# ---------------------------------------------------------------------------

def test_decoded_arrays_are_zero_copy_read_only():
    buf = proto.pack_frame(proto.RESULT, {}, [_array('complex64', (8, 8))])
    _, _, [a], _ = proto.unpack_frame(buf)
    assert not a.flags.writeable
    with pytest.raises((ValueError, RuntimeError)):
        a[0, 0] = 0


def test_truncated_frames_rejected():
    buf = proto.pack_frame(proto.SUBMIT, {'req_id': 1}, [_array('complex64', (4, 4))])
    for cut in (3, proto._HEADER.size - 1, proto._HEADER.size + 2, len(buf) - 1):
        with pytest.raises(proto.ProtocolError, match="truncated"):
            proto.unpack_frame(buf[:cut])


def test_version_mismatch_and_bad_magic_are_typed():
    buf = bytearray(proto.pack_frame(proto.HELLO, {'tenant': 'a'}))
    buf[4] = proto.PROTOCOL_VERSION + 1
    with pytest.raises(proto.VersionMismatch):
        proto.unpack_frame(bytes(buf))
    assert issubclass(proto.VersionMismatch, proto.ProtocolError)
    buf = bytearray(proto.pack_frame(proto.HELLO, {}))
    buf[:4] = b'EVIL'
    with pytest.raises(proto.ProtocolError, match="magic"):
        proto.unpack_frame(bytes(buf))


def test_non_wire_dtypes_and_lying_descriptors_rejected():
    with pytest.raises(proto.ProtocolError, match="not wire-safe"):
        proto.encode_arrays([np.array(['a', 'b'])])
    with pytest.raises(proto.ProtocolError, match="not wire-safe"):
        proto.pack_frame(proto.SUBMIT, {}, [np.array([object()])])
    with pytest.raises(proto.ProtocolError, match="non-wire dtype"):
        proto.decode_arrays([{'dtype': 'object', 'shape': [1], 'nbytes': 8}], b'\0' * 8, 0)
    with pytest.raises(proto.ProtocolError, match="claims"):
        proto.decode_arrays([{'dtype': 'float32', 'shape': [4], 'nbytes': 12}], b'\0' * 12, 0)
    with pytest.raises(proto.ProtocolError, match="trailing"):
        proto.decode_arrays([{'dtype': 'float32', 'shape': [2], 'nbytes': 8}], b'\0' * 12, 0)
    with pytest.raises(proto.ProtocolError, match="negative"):
        proto.decode_arrays([{'dtype': 'float32', 'shape': [-2], 'nbytes': 8}], b'\0' * 8, 0)


# ---------------------------------------------------------------------------
# tests/test_protocol_fuzz.py against the port, input by input
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(10))
def test_fuzz_random_garbage_same_outcome(seed):
    rng = random.Random(0xF0F0 + seed)
    for _ in range(50):
        n = rng.randrange(0, 200)
        out = _same_outcome(bytes(rng.randrange(256) for _ in range(n)))
        assert out[0] == 'error' or 0 < out[2] <= n


@pytest.mark.parametrize("i", range(6))
def test_fuzz_mutated_valid_frames_same_outcome(i):
    """Single-bit corruption of every position of a real frame: each
    mutant parses to the same frame in both packages, or fails typed in
    both."""
    rng = random.Random(0xBEEF + i)
    frame = _valid_frames(proto)[i]
    for pos in range(len(frame)):
        mutant = bytearray(frame)
        mutant[pos] ^= 1 << rng.randrange(8)
        _same_outcome(bytes(mutant))


@pytest.mark.parametrize("i", range(6))
def test_fuzz_every_truncation_is_typed(i):
    frame = _valid_frames(proto)[i]
    for cut in range(1, len(frame)):
        with pytest.raises(proto.ProtocolError):
            proto.unpack_frame(frame[:cut])
        assert _same_outcome(frame[:cut])[0] == 'error'


LYING = [
    {'dtype': 'object', 'shape': [1], 'nbytes': 8},
    {'dtype': 'float32', 'shape': [-1], 'nbytes': 4},
    {'dtype': 'float32', 'shape': [2, 2], 'nbytes': 9999},
    {'dtype': 'float32', 'shape': 'nope', 'nbytes': 4},
    {'dtype': 'float32'},
]


@pytest.mark.parametrize("desc", LYING, ids=[str(i) for i in range(len(LYING))])
def test_fuzz_lying_array_descriptors(desc):
    jb = json.dumps({'req_id': 1, 'arrays': [desc]}).encode()
    payload = proto._JLEN.pack(len(jb)) + jb + b'\x00' * 16
    buf = proto._HEADER.pack(proto.MAGIC, proto.PROTOCOL_VERSION, proto.SUBMIT, 0,
                             len(payload)) + payload
    with pytest.raises(proto.ProtocolError):
        proto.unpack_frame(buf)
    _same_outcome(buf)


@pytest.mark.parametrize("meta_json", [b'[1,2]', b'"str"', b'42', b'null', b'\xff\xfe'])
def test_fuzz_non_object_metadata_rejected(meta_json):
    payload = proto._JLEN.pack(len(meta_json)) + meta_json
    buf = proto._HEADER.pack(proto.MAGIC, proto.PROTOCOL_VERSION, proto.HELLO, 0,
                             len(payload)) + payload
    with pytest.raises(proto.ProtocolError):
        proto.unpack_frame(buf)
    _same_outcome(buf)


def test_fuzz_oversize_length_prefix_never_allocates():
    huge = proto._HEADER.pack(proto.MAGIC, proto.PROTOCOL_VERSION, proto.SUBMIT, 0,
                              proto.MAX_FRAME_BYTES + 1)
    assert _same_outcome(huge + b'x' * 64)[0] == 'error'


def test_fuzz_round_trip_identity():
    rng = np.random.default_rng(7)
    metas = [{}, {'req_id': 0}, {'nested': {'a': [1, 2, {'b': None}]}, 'unicode': 'héllo→'}]
    arr_sets = [
        [],
        [rng.standard_normal((3, 5)).astype(np.float32)],
        [rng.standard_normal(8).astype(np.complex128), np.arange(6, dtype=np.int64).reshape(2, 3)],
        [np.float16(1.5) * np.ones((2, 2), np.float16)],
    ]
    for meta in metas:
        for arrs in arr_sets:
            buf = proto.pack_frame(proto.SUBMIT, meta, arrs)
            assert buf == jproto.pack_frame(proto.SUBMIT, meta, arrs)
            mt, m2, a2, consumed = proto.unpack_frame(buf)
            assert (mt, consumed, m2) == (proto.SUBMIT, len(buf), meta)
            for x, y in zip(arrs, a2):
                assert x.dtype == y.dtype and x.shape == y.shape and np.array_equal(x, y)


# ---------------------------------------------------------------------------
# Sockets: clean against mid-frame EOF, hostile streams, fault hooks
# ---------------------------------------------------------------------------

def _drain_socket(payload: bytes):
    """Feed ``payload`` through a socket pair and collect what the port's
    ``recv_frame`` makes of it: ('frames', [...]) or ('error', exc). The
    writer closes after the payload, so a torn tail is EOF, never a hang."""
    a, b = socket.socketpair()
    try:
        def feed():
            try:
                a.sendall(payload)
            except OSError:
                pass
            finally:
                try:
                    a.shutdown(socket.SHUT_WR)
                except OSError:
                    pass
        t = threading.Thread(target=feed, daemon=True)
        t.start()
        frames = []
        try:
            while True:
                f = proto.recv_frame(b)
                if f is None:
                    break
                frames.append(f)
        except proto.ProtocolError as exc:
            return 'error', exc
        finally:
            t.join(timeout=10.0)
            assert not t.is_alive(), "feeder wedged"
        return 'frames', frames
    finally:
        a.close()
        b.close()


def test_recv_frame_clean_eof_vs_midframe_eof():
    frame = _valid_frames(proto)[1]
    status, frames = _drain_socket(frame * 3)
    assert status == 'frames' and len(frames) == 3
    assert all(f[0] == proto.SUBMIT and f[1]['key'] == 'c/1' for f in frames)
    status, err = _drain_socket(frame + frame[:len(frame) // 2])
    assert status == 'error' and ('truncat' in str(err) or 'EOF' in str(err))
    status, frames = _drain_socket(b'')
    assert status == 'frames' and frames == []


def test_socket_eof_semantics_across_packages():
    """A reference sender, a port receiver: whole frames then a clean
    close give every frame then None; a torn frame is a typed error."""
    a, b = socket.socketpair()
    frame = jproto.pack_frame(jproto.HELLO, {'tenant': 't'})
    jproto.send_frame(a, jproto.HELLO, {'tenant': 't'})
    a.close()
    assert proto.recv_frame(b)[:2] == (proto.HELLO, {'tenant': 't'})
    assert proto.recv_frame(b) is None
    b.close()
    a, b = socket.socketpair()
    a.sendall(frame[:len(frame) - 3])
    a.close()
    with pytest.raises(proto.ProtocolError, match="EOF|truncated"):
        proto.recv_frame(b)
    b.close()


@pytest.mark.parametrize("seed", range(5))
def test_recv_frame_random_garbage_streams(seed):
    rng = random.Random(0xCAFE + seed)
    for _ in range(10):
        blob = bytes(rng.randrange(256) for _ in range(rng.randrange(1, 300)))
        status, _ = _drain_socket(blob)
        assert status in ('frames', 'error')


def test_recv_frame_hostile_length_does_not_allocate_or_hang():
    huge = proto._HEADER.pack(proto.MAGIC, proto.PROTOCOL_VERSION, proto.SUBMIT, 0,
                              proto.MAX_FRAME_BYTES - 1)
    status, _ = _drain_socket(huge)
    assert status == 'error'


@pytest.mark.parametrize("action", ['drop', 'truncate', 'raise', 'delay'])
def test_send_frame_fault_hooks(action):
    """``protocol.send``: drop hard-closes and raises a reset, truncate
    sends a strict prefix (the peer sees a typed truncation), raise is
    ``FaultInjected``, delay sends the whole frame late."""
    a, b = socket.socketpair()
    plan = FaultPlan([FaultPoint('protocol.send', action, at=[0], delay_s=0.01)])
    try:
        if action in ('drop', 'truncate'):
            with pytest.raises(ConnectionResetError):
                proto.send_frame(a, proto.HELLO, {'tenant': 't'}, faults=plan)
            if action == 'truncate':
                with pytest.raises(proto.ProtocolError, match="EOF|truncated"):
                    proto.recv_frame(b)
            else:
                assert proto.recv_frame(b) is None
        elif action == 'raise':
            with pytest.raises(FaultInjected):
                proto.send_frame(a, proto.HELLO, {'tenant': 't'}, faults=plan)
        else:
            proto.send_frame(a, proto.HELLO, {'tenant': 't'}, faults=plan)
            assert proto.recv_frame(b)[1] == {'tenant': 't'}
        assert plan.stats()['protocol.send'] == {'hits': 1, 'fired': 1}
    finally:
        a.close()
        b.close()


def test_recv_frame_drop_hook_closes_the_link():
    a, b = socket.socketpair()
    plan = FaultPlan([FaultPoint('protocol.recv', 'drop', at=[0])])
    try:
        proto.send_frame(a, proto.HELLO, {'tenant': 't'})
        assert proto.recv_frame(b, faults=plan) is None
        assert b.fileno() == -1
    finally:
        a.close()
