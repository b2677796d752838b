"""Length-prefixed frame protocol for the multi-tenant FFT service.

Port of ``repro.serve.protocol`` (standard library and numpy only; the
port keeps its own copy). The wire is the contract: a frame this module
packs is byte for byte the reference's for the same metadata and
arrays, so a client of either package talks to a server of the other.

One frame = a fixed header + a payload; the payload is a JSON metadata
document followed by the raw bytes of zero or more arrays. Everything
is stdlib + numpy — no serialization dependency rides the hot path,
and an array crosses the wire as exactly its C-contiguous buffer
(``dtype``/``shape``/``nbytes`` declared in the metadata, validated
against a dtype whitelist on decode — a frame can never make the
receiver materialize an object, only a typed ndarray).

Frame layout (network byte order)::

    !4sBBHQ  header: magic 'WFFT' | version | msg type | reserved |
             payload length
    !I       json length
    ...      json metadata (utf-8), including per-array
             {dtype, shape, nbytes} descriptors under 'arrays'
    ...      array buffers, concatenated in descriptor order

Violations raise :class:`ProtocolError`; a peer speaking a different
protocol version raises the :class:`VersionMismatch` subclass (the
server answers it with a typed ERROR frame before closing, so old
clients fail loudly, not mysteriously). A clean EOF *between* frames
is a normal connection close (``recv_frame`` returns None); EOF inside
a frame is a truncation error.

Decoded arrays are zero-copy views into the received payload and
therefore read-only; callers that need to mutate copy explicitly (the
engine's :func:`repro_torch.weights.from_numpy` reads them once, into
the device's tensor or, on the CPU, a tensor of its own).
"""
from __future__ import annotations

import json
import struct
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serve import faults as _f

#: bump when the frame layout or message semantics change
#: incompatibly; the header carries it so mismatches fail typed.
PROTOCOL_VERSION = 1

MAGIC = b'WFFT'
_HEADER = struct.Struct('!4sBBHQ')
_JLEN = struct.Struct('!I')

#: refuse frames larger than this outright — a corrupt/hostile length
#: prefix must not make the receiver allocate unbounded memory.
MAX_FRAME_BYTES = 1 << 30

# -- message types ----------------------------------------------------------

HELLO = 1          # client -> server: {tenant, client_id?}
HELLO_OK = 2       # server -> client: {tenant, slo_classes, quotas, ...}
SUBMIT = 3         # client -> server: {req_id, direction, real, slo,
                   #                    key?} + arrays (key: idempotency)
RESULT = 4         # server -> client: {req_id, form, dedup?} + arrays
RETRY_AFTER = 5    # server -> client: {req_id, reason, retry_after_ms}
ERROR = 6          # server -> client: {req_id?, kind, error}
METRICS = 7        # client -> server: {req_id}
METRICS_OK = 8     # server -> client: {req_id, metrics}
DRAIN = 9          # client -> server: {req_id} — "I am done submitting"
DRAIN_OK = 10      # server -> client: {req_id} — that client's inflight == 0
HEARTBEAT = 11     # client -> server: {} — keepalive (refreshes liveness)
HEARTBEAT_OK = 12  # server -> client: {} — the echo
RELOAD = 13        # client -> server: {req_id, tenants: [{...}]} — hot
                   #                   tenant-config swap (admin tenants only)
RELOAD_OK = 14     # server -> client: {req_id, generation, added, updated,
                   #                    removed}

MSG_NAMES = {v: k for k, v in list(globals().items())
             if k.isupper() and isinstance(v, int) and k != 'PROTOCOL_VERSION'
             and not k.startswith('MAX')}

#: dtypes allowed on the wire. Object/str dtypes are structurally
#: impossible (the whitelist is how), and anything absent here is a
#: typed rejection rather than a silent reinterpretation.
WIRE_DTYPES = frozenset({
    'float16', 'float32', 'float64',
    'complex64', 'complex128',
    'int32', 'int64',
})


class ProtocolError(RuntimeError):
    """Malformed, truncated, oversized, or otherwise invalid frame."""


class VersionMismatch(ProtocolError):
    """The peer speaks a different protocol version."""


# -- array (de)serialization ------------------------------------------------

def _describe(a: np.ndarray) -> dict:
    """One C-contiguous array's wire descriptor, dtype-checked."""
    name = a.dtype.name
    if name not in WIRE_DTYPES:
        raise ProtocolError(
            f"dtype {name!r} is not wire-safe (allowed: "
            f"{sorted(WIRE_DTYPES)})")
    return {'dtype': name, 'shape': [int(s) for s in a.shape],
            'nbytes': int(a.nbytes)}


def encode_arrays(arrays: Sequence) -> Tuple[List[dict], List[bytes]]:
    """Per-array wire descriptors + raw buffers, dtype-checked."""
    arrays = [np.ascontiguousarray(a) for a in arrays]
    return [_describe(a) for a in arrays], [a.tobytes() for a in arrays]


def decode_arrays(metas: Sequence[dict], payload: bytes,
                  offset: int) -> List[np.ndarray]:
    """Rebuild the arrays a frame declared, validating every descriptor
    against the whitelist and the actual byte count — a lying
    descriptor is a :class:`ProtocolError`, never a mis-typed array."""
    arrays = []
    for m in metas:
        name = m.get('dtype')
        if name not in WIRE_DTYPES:
            raise ProtocolError(f"frame declares non-wire dtype {name!r}")
        try:
            shape = tuple(int(s) for s in m['shape'])
            nbytes = int(m['nbytes'])
        except (KeyError, TypeError, ValueError) as exc:
            raise ProtocolError(f"bad array descriptor {m!r}") from exc
        if any(s < 0 for s in shape):
            raise ProtocolError(f"negative extent in shape {shape}")
        dt = np.dtype(name)
        count = int(np.prod(shape, dtype=np.int64)) if shape else 1
        if nbytes != count * dt.itemsize:
            raise ProtocolError(
                f"descriptor claims {nbytes} bytes for shape {shape} "
                f"dtype {name} (expected {count * dt.itemsize})")
        if offset + nbytes > len(payload):
            raise ProtocolError(
                f"truncated frame: array needs {nbytes} bytes, "
                f"{len(payload) - offset} remain")
        arrays.append(np.frombuffer(payload, dt, count=count,
                                    offset=offset).reshape(shape))
        offset += nbytes
    if offset != len(payload):
        raise ProtocolError(
            f"{len(payload) - offset} trailing bytes after the declared "
            f"arrays")
    return arrays


# -- frame (de)serialization ------------------------------------------------

def pack_frame(msg_type: int, meta: Optional[dict] = None,
               arrays: Sequence = ()) -> bytes:
    """One complete wire frame for ``meta`` + ``arrays``. The size cap
    is checked from the descriptors, before any array is copied: a
    refused frame costs no buffer."""
    arrays = [np.ascontiguousarray(a) for a in arrays]
    metas = [_describe(a) for a in arrays]
    head = dict(meta or {})
    head['arrays'] = metas
    jb = json.dumps(head, separators=(',', ':')).encode('utf-8')
    payload_len = _JLEN.size + len(jb) + sum(m['nbytes'] for m in metas)
    if payload_len > MAX_FRAME_BYTES:
        raise ProtocolError(
            f"frame payload of {payload_len} bytes exceeds the "
            f"{MAX_FRAME_BYTES}-byte cap")
    parts = [_HEADER.pack(MAGIC, PROTOCOL_VERSION, int(msg_type), 0,
                          payload_len),
             _JLEN.pack(len(jb)), jb]
    parts.extend(a.tobytes() for a in arrays)
    return b''.join(parts)


def _parse_header(buf: bytes) -> Tuple[int, int]:
    """(msg type, payload length); raises on magic/version trouble."""
    if len(buf) < _HEADER.size:
        raise ProtocolError(
            f"truncated frame: {len(buf)}-byte header (need "
            f"{_HEADER.size})")
    magic, version, msg_type, _, payload_len = _HEADER.unpack(
        buf[:_HEADER.size])
    if magic != MAGIC:
        raise ProtocolError(f"bad magic {magic!r} (expected {MAGIC!r})")
    if version != PROTOCOL_VERSION:
        raise VersionMismatch(
            f"peer speaks protocol v{version}, this build speaks "
            f"v{PROTOCOL_VERSION}")
    if payload_len > MAX_FRAME_BYTES:
        raise ProtocolError(
            f"frame declares a {payload_len}-byte payload (cap "
            f"{MAX_FRAME_BYTES})")
    return msg_type, payload_len


def _parse_payload(payload: bytes) -> Tuple[dict, List[np.ndarray]]:
    if len(payload) < _JLEN.size:
        raise ProtocolError("truncated frame: payload shorter than the "
                            "json length prefix")
    (jlen,) = _JLEN.unpack(payload[:_JLEN.size])
    if _JLEN.size + jlen > len(payload):
        raise ProtocolError(
            f"truncated frame: json section claims {jlen} bytes, "
            f"{len(payload) - _JLEN.size} remain")
    try:
        meta = json.loads(payload[_JLEN.size:_JLEN.size + jlen]
                          .decode('utf-8'))
    except (UnicodeDecodeError, ValueError) as exc:
        raise ProtocolError(f"undecodable frame metadata: {exc}") from exc
    if not isinstance(meta, dict):
        raise ProtocolError(f"frame metadata must be an object, got "
                            f"{type(meta).__name__}")
    arrays = decode_arrays(meta.pop('arrays', []), payload,
                           _JLEN.size + jlen)
    return meta, arrays


def unpack_frame(buf: bytes) -> Tuple[int, dict, List[np.ndarray], int]:
    """Parse ONE frame from the head of ``buf``: (msg type, metadata,
    arrays, total bytes consumed). Raises :class:`ProtocolError` on
    truncation — a partial frame is never silently half-read."""
    msg_type, payload_len = _parse_header(buf)
    end = _HEADER.size + payload_len
    if len(buf) < end:
        raise ProtocolError(
            f"truncated frame: payload has {len(buf) - _HEADER.size} of "
            f"{payload_len} declared bytes")
    meta, arrays = _parse_payload(buf[_HEADER.size:end])
    return msg_type, meta, arrays, end


# -- socket I/O -------------------------------------------------------------

def _recv_exact(sock, n: int, *, at_boundary: bool) -> Optional[bytes]:
    """Exactly ``n`` bytes from ``sock``. Clean EOF before the first
    byte of a frame returns None (normal close); EOF anywhere else is a
    truncation error."""
    chunks, got = [], 0
    while got < n:
        try:
            b = sock.recv(min(n - got, 1 << 20))
        except (ConnectionResetError, BrokenPipeError) as exc:
            if at_boundary and got == 0:
                return None
            raise ProtocolError(
                f"connection lost mid-frame after {got}/{n} bytes") from exc
        if not b:
            if at_boundary and got == 0:
                return None
            raise ProtocolError(
                f"truncated frame: EOF after {got}/{n} bytes")
        chunks.append(b)
        got += len(b)
    return b''.join(chunks)


def recv_frame(sock, *, faults=None,
               site: str = 'protocol.recv'
               ) -> Optional[Tuple[int, dict, List[np.ndarray]]]:
    """One frame from a socket: (msg type, metadata, arrays), or None
    on a clean close at a frame boundary.

    ``faults`` is an optional :class:`repro_torch.serve.faults.FaultPlan`:
    before the header read, a ``drop`` fire hard-closes the socket (the
    caller observes the close), a ``delay`` fire sleeps (slow peer),
    a ``raise`` fire raises :class:`~repro_torch.serve.faults.FaultInjected`.
    """
    if faults is not None:
        pt = faults.draw(site)
        if pt is not None:
            if pt.action == 'drop':
                _f.kill_socket(sock)
                return None            # the peer is gone: a closed link
            if pt.action in ('delay', 'stall'):
                time.sleep(pt.delay_s)
            elif pt.action == 'raise':
                raise _f.FaultInjected(site, pt.note)
    head = _recv_exact(sock, _HEADER.size, at_boundary=True)
    if head is None:
        return None
    msg_type, payload_len = _parse_header(head)
    payload = _recv_exact(sock, payload_len, at_boundary=False)
    meta, arrays = _parse_payload(payload)
    return msg_type, meta, arrays


def send_frame(sock, msg_type: int, meta: Optional[dict] = None,
               arrays: Sequence = (), *, faults=None,
               site: str = 'protocol.send') -> None:
    """Pack and send one frame (the caller serializes concurrent
    senders on one socket).

    ``faults`` is an optional :class:`repro_torch.serve.faults.FaultPlan`:
    a ``drop`` fire hard-closes the socket and raises
    ``ConnectionResetError``; a ``truncate`` fire sends a strict
    prefix of the frame then closes (the peer observes a typed
    mid-frame truncation); ``delay`` sleeps before the send;
    ``raise`` raises :class:`~repro_torch.serve.faults.FaultInjected`.
    """
    buf = pack_frame(msg_type, meta, arrays)
    if faults is not None:
        pt = faults.draw(site)
        if pt is not None:
            if pt.action == 'drop':
                _f.kill_socket(sock)
                raise ConnectionResetError(
                    f"injected connection drop at {site!r}")
            if pt.action == 'truncate':
                try:
                    sock.sendall(buf[:max(1, len(buf) // 2)])
                except OSError:
                    pass
                _f.kill_socket(sock)
                raise ConnectionResetError(
                    f"injected truncated frame at {site!r}")
            if pt.action in ('delay', 'stall'):
                time.sleep(pt.delay_s)
            elif pt.action == 'raise':
                raise _f.FaultInjected(site, pt.note)
    sock.sendall(buf)
