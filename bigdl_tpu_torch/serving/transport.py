"""The fleet's binary wire (the port's copy of
``bigdl_tpu/serving/transport.py``): versioned frames, zero-copy tensor
frames, pooled multiplexed connections, digest auth and the blockwise
int8 weight wire.

The wire is byte for byte the JAX package's, so a JAX client calls a port
worker and the other way round.  **Frame layout** (big-endian)::

    +-------+---------+------------+----------------+-----------------+
    | magic | version | frame type | payload length | payload ...     |
    | 2B BW | 1B      | 1B         | 4B (bounded)   |                 |
    +-------+---------+------------+----------------+-----------------+

Bad magic, a foreign version byte or a length past the frame cap are
refused with a typed error (``WireProtocolError`` / ``WireVersionError``
/ ``WireFrameError``) before anything is allocated; a peer that closes
mid-frame raises with the byte count it got to.

**Messages** are one ``FT_MSG`` skeleton frame -- a JSON envelope ``{"id",
"nt", "body"}`` in which every array of the payload is a ``{"__t__": i}``
placeholder -- followed by ``nt`` ``FT_TENSOR`` frames, each a small
dtype/shape JSON header and the raw buffer.  Arrays on the wire are
numpy: a ``torch.Tensor`` in a payload crosses as ``.cpu().numpy()``, and
a received tensor frame is a numpy array over the frame's own buffer (the
worker moves it to its device).  Other non-JSON metadata falls back to a
restricted unpickler whose allowlist holds a few stdlib types only: a
``torch`` global (a dtype, a device, a tensor pickled whole) is refused as
a protocol error, as any other global is.

**Handshake**: the server sends ``FT_HELLO {v, nonce}``, the client
answers ``FT_AUTH {v, digest}`` with ``digest = HMAC-SHA256(run_token,
nonce)``, the server replies ``FT_OK`` or a typed ``FT_ERR``.  The run
token rides ``BIGDL_RUN_TOKEN`` (``tools/torch_serve_fleet.py`` mints one
per run).

**Connections** are persistent and multiplexed: ``WireClient`` tags each
request with an id and a reader thread hands responses back to their
waiters; ``WirePool`` keeps a capped set per replica, evicts broken ones
and re-dials under ``optim.recovery.capped_backoff``.

**Weight distribution**: ``quantize_tree_for_wire`` rewrites each float
leaf into an int8 payload and fp32 per-block scales through
``ops.quantization.quantize_blockwise`` (bitwise the JAX package's on the
same numpy tree), ``dequantize_wire_tree`` reverses it on the worker.

No device work here: the fleet's router imports this module in a process
that needs no card.
"""

import base64
import hmac
import hashlib
import io
import json
import logging
import os
import pickle
import secrets
import socket
import struct
import threading
import time

import numpy as np
import torch

log = logging.getLogger("bigdl_tpu_torch.serving")

# --------------------------------------------------------------------------- #
# Protocol constants.
# --------------------------------------------------------------------------- #

WIRE_MAGIC = b"BW"
WIRE_VERSION = 1
#: refuse absurd frames instead of allocating them (a corrupt or
#: malicious length must not OOM the process)
MAX_FRAME_BYTES = 1 << 28
#: a message's tensor count is bounded too (the skeleton is parsed
#: before the tensor frames are read)
MAX_TENSORS_PER_MESSAGE = 1 << 16
#: handshake frames are tiny JSON; cap them hard
_HANDSHAKE_FRAME_CAP = 1 << 14

_HEADER = struct.Struct(">2sBBI")

FT_HELLO = 1       # server -> client  {v, nonce, auth}
FT_AUTH = 2        # client -> server  {v, digest}
FT_OK = 3          # server -> client  {v}
FT_MSG = 4         # message skeleton  {id, nt, body}
FT_TENSOR = 5      # dtype/shape header + raw buffer
FT_ERR = 6         # typed wire error  {error, error_type}

#: coalesce buffers smaller than this into one send (TCP_NODELAY means
#: every sendall may flush a packet; headers should ride with payloads)
_COALESCE_BYTES = 1 << 16


def run_token():
    """The shared per-run auth token, if one is configured
    (``BIGDL_RUN_TOKEN``); servers and clients both default to it."""
    tok = os.environ.get("BIGDL_RUN_TOKEN")
    return tok or None


def mint_run_token():
    """A fresh run token for ``BIGDL_RUN_TOKEN`` (the fleet CLI mints
    one per run so restarted workers re-auth against the same secret)."""
    return secrets.token_hex(16)


# --------------------------------------------------------------------------- #
# Typed wire errors.
# --------------------------------------------------------------------------- #


class WireError(RuntimeError):
    """Base of every transport-level failure (never an op-level error:
    those cross as ``{"ok": False, ...}`` responses)."""


class WireProtocolError(WireError, ConnectionError):
    """Malformed stream: bad magic, truncated frame, unexpected frame
    type, refused pickle fallback.  Subclasses ``ConnectionError`` on
    purpose -- a peer speaking garbage is as dead to the router as one
    that hung up."""


class WireVersionError(WireError):
    """The peer speaks a different wire version -- answered as a typed
    error instead of a hung recv, in both directions."""


class WireAuthError(WireError):
    """The client did not present a digest of the shared run token."""


class WireFrameError(WireError, ValueError):
    """A frame exceeds the bounded size (``ValueError`` too, so legacy
    callers of the pickle wire's cap keep their except clauses)."""


_ERROR_TYPES = {
    "WireProtocolError": WireProtocolError,
    "WireVersionError": WireVersionError,
    "WireAuthError": WireAuthError,
    "WireFrameError": WireFrameError,
}


class ReplicaCallError(RuntimeError):
    """The worker answered, but the op failed there (its error text
    rides along) -- distinct from a dead/unreachable worker.
    ``error_type`` carries the worker-side exception's class name so a
    router can recognize typed refusals (e.g. ``EngineDraining``)
    across the socket."""

    def __init__(self, message, error_type=None):
        super().__init__(message)
        self.error_type = error_type


# --------------------------------------------------------------------------- #
# Payload <-> (skeleton, tensors).
# --------------------------------------------------------------------------- #

#: skeleton marker keys; a user dict carrying any of them is shipped as
#: an explicit pair list so markers can never be spoofed by payload data
_RESERVED_KEYS = frozenset(
    {"__t__", "__b__", "__np__", "__py__", "__tup__", "__map__", "__q8__"})

#: the restricted unpickler's entire world: module -> allowed globals.
#: Arrays NEVER take this path (they are split out as tensor frames
#: before the fallback is consulted); this exists only for legacy
#: non-tensor metadata.
_SAFE_PICKLE_GLOBALS = {
    "builtins": {"set", "frozenset", "complex", "bytearray", "slice",
                 "range", "tuple", "list", "dict"},
    "collections": {"OrderedDict", "deque", "defaultdict"},
    "datetime": {"datetime", "date", "time", "timedelta", "timezone"},
}


class _RestrictedUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if name in _SAFE_PICKLE_GLOBALS.get(module, ()):
            return super().find_class(module, name)
        raise WireProtocolError(
            f"wire pickle fallback refused {module}.{name}: only "
            f"{sorted(_SAFE_PICKLE_GLOBALS)} metadata may ride the "
            f"legacy path")


def _restricted_loads(data):
    return _RestrictedUnpickler(io.BytesIO(data)).load()


def _is_array(x):
    # numpy arrays, tensors and anything array-flavored -- but not numpy
    # scalars, which are np.generic and JSON-sized
    if isinstance(x, (np.ndarray, torch.Tensor)):
        return True
    return (hasattr(x, "__array__") and hasattr(x, "dtype")
            and hasattr(x, "shape")
            and not isinstance(x, (np.generic, bytes, bytearray, str)))


def encode_payload(obj):
    """-> ``(skeleton, tensors, stats)``: the JSON-able skeleton with
    every array replaced by a ``{"__t__": i}`` placeholder, the arrays
    themselves (contiguous, ready to ship raw), and honesty counters
    (``pickle_fallbacks`` pins the no-arrays-through-pickle claim)."""
    tensors = []
    stats = {"pickle_fallbacks": 0}

    def enc(x):
        if x is None or isinstance(x, (bool, int, float, str)):
            return x
        if _is_array(x):
            a = np.ascontiguousarray(_host_array(x))
            tensors.append(a)
            return {"__t__": len(tensors) - 1}
        if isinstance(x, np.generic):
            a = np.asarray(x)
            return {"__np__": [str(a.dtype),
                               base64.b64encode(a.tobytes()).decode()]}
        if isinstance(x, (bytes, bytearray)):
            return {"__b__": base64.b64encode(bytes(x)).decode()}
        if isinstance(x, tuple):
            return {"__tup__": [enc(v) for v in x]}
        if isinstance(x, list):
            return [enc(v) for v in x]
        if isinstance(x, dict):
            keys = list(x.keys())
            if all(isinstance(k, str) for k in keys) \
                    and not (_RESERVED_KEYS & set(keys)):
                return {k: enc(v) for k, v in x.items()}
            return {"__map__": [[enc(k), enc(v)] for k, v in x.items()]}
        # legacy metadata only; arrays were already split out above
        stats["pickle_fallbacks"] += 1
        return {"__py__":
                base64.b64encode(pickle.dumps(x)).decode()}

    return enc(obj), tensors, stats


def _host_array(x):
    """An array leaf as numpy: a tensor crosses as ``.cpu().numpy()``."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def decode_payload(skeleton, tensors):
    """The inverse of ``encode_payload`` (``tensors`` are the decoded
    tensor-frame arrays, placeholder order)."""

    def dec(x):
        if isinstance(x, list):
            return [dec(v) for v in x]
        if not isinstance(x, dict):
            return x
        if "__t__" in x:
            return tensors[int(x["__t__"])]
        if "__np__" in x:
            dt, b = x["__np__"]
            return np.frombuffer(base64.b64decode(b),
                                 dtype=_dtype_of(dt))[0]
        if "__b__" in x:
            return base64.b64decode(x["__b__"])
        if "__tup__" in x:
            return tuple(dec(v) for v in x["__tup__"])
        if "__map__" in x:
            return {dec(k): dec(v) for k, v in x["__map__"]}
        if "__py__" in x:
            return _restricted_loads(base64.b64decode(x["__py__"]))
        return {k: dec(v) for k, v in x.items()}

    return dec(skeleton)


def _dtype_of(name):
    try:
        return np.dtype(name)
    except TypeError:
        # bfloat16 and friends register through ml_dtypes, where present
        try:
            import ml_dtypes  # noqa: F401
        except ImportError:
            raise WireProtocolError(
                f"tensor dtype {name!r} needs the ml_dtypes package, "
                f"which this process lacks") from None

        return np.dtype(name)


def _tensor_frame_parts(a):
    """One tensor as its frame payload parts: ``>I`` header length +
    JSON ``{d, s}`` header + the raw buffer (a no-copy memoryview)."""
    hdr = json.dumps({"d": str(a.dtype), "s": list(a.shape)}).encode()
    if a.nbytes:
        buf = memoryview(a).cast("B")
    else:
        buf = memoryview(b"")
    return [struct.pack(">I", len(hdr)), hdr, buf]


def _decode_tensor(payload):
    """Tensor frame payload -> array: ``np.frombuffer`` over the
    frame's own buffer (writable: the buffer is a fresh bytearray the
    array now owns -- the zero-copy receive contract)."""
    if len(payload) < 4:
        raise WireProtocolError(
            f"tensor frame too short ({len(payload)} bytes)")
    (hl,) = struct.unpack_from(">I", payload, 0)
    if 4 + hl > len(payload):
        raise WireProtocolError(
            f"tensor header claims {hl} bytes, frame has "
            f"{len(payload) - 4}")
    hdr = json.loads(bytes(payload[4:4 + hl]))
    dt = _dtype_of(hdr["d"])
    shape = tuple(int(s) for s in hdr["s"])
    want = int(np.prod(shape, dtype=np.int64)) if shape else 1
    body = memoryview(payload)[4 + hl:]
    if body.nbytes != want * dt.itemsize:
        raise WireProtocolError(
            f"tensor frame carries {body.nbytes} bytes, dtype {dt} "
            f"shape {shape} needs {want * dt.itemsize}")
    return np.frombuffer(body, dtype=dt).reshape(shape)


# --------------------------------------------------------------------------- #
# Raw frame I/O.
# --------------------------------------------------------------------------- #


def _nbytes(b):
    return b.nbytes if isinstance(b, memoryview) else len(b)


def _send_buffers(sock, bufs):
    """Send a buffer list: small parts coalesce into one write, large
    tensor buffers go out as-is (no copy)."""
    small = []
    small_n = 0
    for b in bufs:
        n = _nbytes(b)
        if n <= _COALESCE_BYTES:
            small.append(bytes(b) if isinstance(b, memoryview) else b)
            small_n += n
            if small_n >= _COALESCE_BYTES:
                sock.sendall(b"".join(small))
                small, small_n = [], 0
        else:
            if small:
                sock.sendall(b"".join(small))
                small, small_n = [], 0
            sock.sendall(b)
    if small:
        sock.sendall(b"".join(small))


def _send_frame(sock, ftype, parts, max_frame=MAX_FRAME_BYTES):
    """One frame: header + payload parts.  Returns bytes written."""
    n = sum(_nbytes(p) for p in parts)
    if n > max_frame:
        raise WireFrameError(
            f"outbound frame of {n} bytes exceeds the {max_frame}-byte "
            f"frame cap")
    _send_buffers(sock,
                  [_HEADER.pack(WIRE_MAGIC, WIRE_VERSION, ftype, n),
                   *parts])
    return _HEADER.size + n


def _recv_exact_into(sock, view):
    got = 0
    n = len(view)
    while got < n:
        k = sock.recv_into(view[got:])
        if not k:
            raise WireProtocolError(
                f"peer closed mid-frame ({got}/{n} bytes)")
        got += k


def _recv_frame(sock, max_frame=MAX_FRAME_BYTES):
    """-> ``(ftype, payload bytearray)``.  Refuses bad magic, foreign
    versions, oversize lengths BEFORE allocating the payload."""
    hdr = bytearray(_HEADER.size)
    _recv_exact_into(sock, memoryview(hdr))
    magic, ver, ftype, n = _HEADER.unpack(bytes(hdr))
    if magic != WIRE_MAGIC:
        raise WireProtocolError(
            f"bad frame magic {bytes(magic)!r}: peer is not speaking "
            f"the bigdl wire protocol")
    if ver != WIRE_VERSION:
        raise WireVersionError(
            f"peer speaks wire version {ver}, this end speaks "
            f"{WIRE_VERSION}")
    if n > max_frame:
        raise WireFrameError(
            f"inbound frame of {n} bytes exceeds the {max_frame}-byte "
            f"frame cap (refused before allocation)")
    payload = bytearray(n)
    if n:
        _recv_exact_into(sock, memoryview(payload))
    return ftype, payload


def _send_error(sock, exc, max_frame=MAX_FRAME_BYTES):
    body = json.dumps({"error": str(exc)[:500],
                       "error_type": type(exc).__name__}).encode()
    _send_frame(sock, FT_ERR, [body], max_frame)


def _raise_wire_error(payload):
    try:
        msg = json.loads(bytes(payload))
    except Exception:
        raise WireProtocolError("peer sent an undecodable error frame")
    cls = _ERROR_TYPES.get(str(msg.get("error_type")), WireError)
    raise cls(str(msg.get("error", "peer refused the connection")))


# --------------------------------------------------------------------------- #
# Handshake.
# --------------------------------------------------------------------------- #


def _auth_digest(token, nonce):
    return hmac.new((token or "").encode(), nonce.encode(),
                    hashlib.sha256).hexdigest()


def server_handshake(sock, token=None, max_frame_bytes=None,
                     timeout=10.0):
    """Accept side: HELLO out, AUTH in, OK/typed-ERR out.  Raises the
    typed error it answered with; on success returns a
    ``WireConnection`` ready for messages."""
    max_frame = int(max_frame_bytes or MAX_FRAME_BYTES)
    sock.settimeout(timeout)
    nonce = secrets.token_hex(16)
    _send_frame(sock, FT_HELLO,
                [json.dumps({"v": WIRE_VERSION, "nonce": nonce,
                             "auth": bool(token)}).encode()])
    try:
        ftype, payload = _recv_frame(sock, _HANDSHAKE_FRAME_CAP)
        if ftype != FT_AUTH:
            raise WireProtocolError(
                f"expected AUTH frame, got type {ftype}")
        msg = json.loads(bytes(payload))
        if int(msg.get("v", -1)) != WIRE_VERSION:
            raise WireVersionError(
                f"client speaks wire version {msg.get('v')}, this "
                f"worker speaks {WIRE_VERSION}")
        if token:
            want = _auth_digest(token, nonce)
            got = str(msg.get("digest", ""))
            if not hmac.compare_digest(want, got):
                raise WireAuthError(
                    "client did not present a digest of the shared "
                    "run token; refusing")
    except WireError as e:
        try:
            _send_error(sock, e)
        except OSError:
            pass
        raise
    _send_frame(sock, FT_OK, [json.dumps({"v": WIRE_VERSION}).encode()])
    sock.settimeout(None)
    return WireConnection(sock, max_frame_bytes=max_frame)


def client_handshake(sock, token=None, timeout=10.0):
    """Dial side of the handshake (see ``server_handshake``)."""
    sock.settimeout(timeout)
    ftype, payload = _recv_frame(sock, _HANDSHAKE_FRAME_CAP)
    if ftype == FT_ERR:
        _raise_wire_error(payload)
    if ftype != FT_HELLO:
        raise WireProtocolError(f"expected HELLO frame, got type {ftype}")
    hello = json.loads(bytes(payload))
    if int(hello.get("v", -1)) != WIRE_VERSION:
        raise WireVersionError(
            f"server speaks wire version {hello.get('v')}, this "
            f"client speaks {WIRE_VERSION}")
    digest = _auth_digest(token, str(hello.get("nonce", "")))
    _send_frame(sock, FT_AUTH,
                [json.dumps({"v": WIRE_VERSION,
                             "digest": digest}).encode()])
    ftype, payload = _recv_frame(sock, _HANDSHAKE_FRAME_CAP)
    if ftype == FT_ERR:
        _raise_wire_error(payload)
    if ftype != FT_OK:
        raise WireProtocolError(f"expected OK frame, got type {ftype}")
    sock.settimeout(None)


# --------------------------------------------------------------------------- #
# A framed connection (post-handshake).
# --------------------------------------------------------------------------- #


class WireConnection:
    """One handshaken socket speaking framed messages.  NOT internally
    locked: callers serialize sends (the client under its send lock,
    the server under its per-connection response lock); receives are
    single-threaded by construction (one reader per connection)."""

    def __init__(self, sock, max_frame_bytes=None):
        self.sock = sock
        self.max_frame = int(max_frame_bytes or MAX_FRAME_BYTES)
        self.bytes_sent = 0
        self.bytes_recv = 0
        self.pickle_fallbacks = 0

    def send_message(self, obj, msg_id):
        """Encode + ship one message; returns bytes written."""
        skeleton, tensors, stats = encode_payload(obj)
        if len(tensors) > MAX_TENSORS_PER_MESSAGE:
            raise WireFrameError(
                f"message carries {len(tensors)} tensors, cap is "
                f"{MAX_TENSORS_PER_MESSAGE}")
        self.pickle_fallbacks += stats["pickle_fallbacks"]
        env = json.dumps({"id": int(msg_id), "nt": len(tensors),
                          "body": skeleton}).encode()
        frames = [(FT_MSG, [env])]
        frames += [(FT_TENSOR, _tensor_frame_parts(a)) for a in tensors]
        for _, parts in frames:
            nf = sum(_nbytes(p) for p in parts)
            if nf > self.max_frame:
                # refuse BEFORE any frame leaves: a skeleton already on
                # the wire with its tensor frames missing would desync
                # every later message on this multiplexed stream
                raise WireFrameError(
                    f"outbound frame of {nf} bytes exceeds the "
                    f"{self.max_frame}-byte frame cap")
        n = 0
        for ftype, parts in frames:
            n += _send_frame(self.sock, ftype, parts, self.max_frame)
        self.bytes_sent += n
        return n

    def send_error(self, exc):
        _send_error(self.sock, exc, self.max_frame)

    def recv_message(self):
        """-> ``(msg_id, obj, nbytes)``.  Raises the typed error when
        the peer answered ``FT_ERR``."""
        ftype, payload = _recv_frame(self.sock, self.max_frame)
        n = _HEADER.size + len(payload)
        if ftype == FT_ERR:
            _raise_wire_error(payload)
        if ftype != FT_MSG:
            raise WireProtocolError(
                f"expected message frame, got type {ftype}")
        env = json.loads(bytes(payload))
        nt = int(env.get("nt", 0))
        if nt < 0 or nt > MAX_TENSORS_PER_MESSAGE:
            raise WireProtocolError(f"message claims {nt} tensors")
        tensors = []
        for _ in range(nt):
            ft2, tp = _recv_frame(self.sock, self.max_frame)
            n += _HEADER.size + len(tp)
            if ft2 == FT_ERR:
                _raise_wire_error(tp)
            if ft2 != FT_TENSOR:
                raise WireProtocolError(
                    f"expected tensor frame, got type {ft2}")
            tensors.append(_decode_tensor(tp))
        self.bytes_recv += n
        return int(env["id"]), decode_payload(env["body"], tensors), n

    def close(self):
        try:
            self.sock.close()
        except OSError:
            pass


# --------------------------------------------------------------------------- #
# Server side: one connection served.
# --------------------------------------------------------------------------- #


def serve_connection(sock, handler, token=None, max_frame_bytes=None,
                     max_workers=8):
    """The worker's per-connection loop: handshake, then read messages
    until the peer hangs up, dispatching each message onto a small
    per-connection thread pool so one slow op cannot
    head-of-line-block the multiplexed connection (responses serialize
    under a per-connection lock).  A POOL, not a thread per message:
    thread spawn is ~50us of pure dispatch latency on the predict hot
    path, and ``max_workers`` bounds how much concurrent op work one
    connection can demand of the worker.

    ``handler(req) -> response`` must not raise (the worker wraps op
    errors into ``{"ok": False, ...}`` envelopes itself).  An oversize
    inbound frame is refused with a typed ``FT_ERR`` and the connection
    closed (the stream position is unrecoverable past an unread
    payload)."""
    from concurrent.futures import ThreadPoolExecutor

    try:
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    except OSError:
        pass
    try:
        conn = server_handshake(sock, token=token,
                                max_frame_bytes=max_frame_bytes)
    except (WireError, OSError, ConnectionError, ValueError):
        return                          # refusal already answered typed
    send_lock = threading.Lock()
    ops = ThreadPoolExecutor(max_workers=max_workers,
                             thread_name_prefix="bigdl-wire-op")

    def serve_one(mid, req):
        resp = handler(req)
        try:
            with send_lock:
                conn.send_message(resp, mid)
        except WireFrameError as e:
            # the RESPONSE outgrew the cap: tell the waiter instead of
            # silently dropping its request id
            try:
                with send_lock:
                    conn.send_message(
                        {"ok": False, "error": str(e)[:500],
                         "error_type": type(e).__name__}, mid)
            except OSError:
                pass
        except OSError:
            pass                        # client hung up mid-response

    while True:
        try:
            mid, req, _ = conn.recv_message()
        except WireFrameError as e:
            try:
                with send_lock:
                    conn.send_error(e)
            except OSError:
                pass
            conn.close()
            ops.shutdown(wait=False)
            return
        except (WireError, OSError, ConnectionError):
            conn.close()
            ops.shutdown(wait=False)
            return
        ops.submit(serve_one, mid, req)


# --------------------------------------------------------------------------- #
# Client side: multiplexed connection + capped pool.
# --------------------------------------------------------------------------- #


class WireClient:
    """One persistent multiplexed connection: requests are tagged with
    ids, a reader thread matches responses back to waiters, so many
    RPC threads share this socket concurrently."""

    def __init__(self, host, port, token=None, dial_timeout=5.0,
                 max_frame_bytes=None):
        self.host, self.port = host, int(port)
        if token is None:
            token = run_token()
        sock = socket.create_connection((host, int(port)),
                                        timeout=dial_timeout)
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            client_handshake(sock, token=token, timeout=dial_timeout)
        except BaseException:
            sock.close()
            raise
        self._conn = WireConnection(sock, max_frame_bytes=max_frame_bytes)
        self._send_lock = threading.Lock()
        self._plock = threading.Lock()
        self._pending = {}
        self._next_id = 0
        self._broken = None
        self._reader = threading.Thread(target=self._read_loop,
                                        name="bigdl-wire-reader",
                                        daemon=True)
        self._reader.start()

    # -- internals -- #
    def _read_loop(self):
        while True:
            try:
                mid, obj, nbytes = self._conn.recv_message()
            except Exception as e:
                self._fail_all(e)
                return
            with self._plock:
                ent = self._pending.pop(mid, None)
            if ent is None:
                continue                # waiter timed out and left
            ent["resp"], ent["nbytes"] = obj, nbytes
            ent["evt"].set()

    def _fail_all(self, exc):
        with self._plock:
            if self._broken is None:
                self._broken = exc
            pending = list(self._pending.values())
            self._pending.clear()
        for ent in pending:
            ent["err"] = exc
            ent["evt"].set()
        self._conn.close()

    @property
    def broken(self):
        return self._broken is not None

    @property
    def bytes_sent(self):
        return self._conn.bytes_sent

    @property
    def bytes_recv(self):
        return self._conn.bytes_recv

    @property
    def pickle_fallbacks(self):
        return self._conn.pickle_fallbacks

    # -- requests -- #
    def request_ex(self, op, rpc_timeout=30.0, **kwargs):
        """-> ``(result, bytes_out, bytes_in)``; raises
        ``ReplicaCallError`` when the worker answered an error, a
        ``WireError``/``OSError`` when the connection failed, and
        ``TimeoutError`` when no response landed in time (the
        connection itself stays healthy: the late response is dropped
        by the reader)."""
        if self._broken is not None:
            raise ConnectionError(
                f"wire connection to {self.host}:{self.port} is "
                f"broken: {self._broken}") from self._broken
        with self._plock:
            self._next_id += 1
            mid = self._next_id
            ent = {"evt": threading.Event(), "resp": None, "err": None,
                   "nbytes": 0}
            self._pending[mid] = ent
        try:
            with self._send_lock:
                out = self._conn.send_message({"op": op, **kwargs}, mid)
        except WireFrameError:
            with self._plock:
                self._pending.pop(mid, None)
            raise
        except OSError as e:
            self._fail_all(e)
            raise ConnectionError(
                f"send to worker {self.host}:{self.port} failed: {e}"
            ) from e
        if not ent["evt"].wait(rpc_timeout):
            with self._plock:
                self._pending.pop(mid, None)
            raise TimeoutError(
                f"no response for {op} from worker "
                f"{self.host}:{self.port} within {rpc_timeout}s")
        if ent["err"] is not None:
            raise ent["err"]
        resp = ent["resp"]
        if not isinstance(resp, dict) or not resp.get("ok"):
            err = (resp or {}).get("error", "malformed response")
            raise ReplicaCallError(
                f"{op} failed on worker {self.host}:{self.port}: {err}",
                error_type=(resp or {}).get("error_type"))
        return resp.get("result"), out, ent["nbytes"]

    def request(self, op, rpc_timeout=30.0, **kwargs):
        return self.request_ex(op, rpc_timeout=rpc_timeout, **kwargs)[0]

    def close(self):
        self._fail_all(ConnectionError("client closed"))


class WirePool:
    """A small capped set of persistent ``WireClient`` connections to
    ONE replica: requests round-robin over healthy connections, broken
    ones are evicted, and re-dials back off under the existing
    ``capped_backoff`` so a dead worker is not hammered."""

    def __init__(self, host, port, token=None, size=2,
                 dial_timeout=5.0, backoff_base_s=0.05,
                 backoff_max_s=2.0, max_frame_bytes=None, on_wire=None,
                 clock=time.monotonic):
        self.host, self.port = host, int(port)
        self.token = token
        self.size = max(1, int(size))
        self.dial_timeout = float(dial_timeout)
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_max_s = float(backoff_max_s)
        self.max_frame_bytes = max_frame_bytes
        self.on_wire = on_wire          # cb(verb, rtt_s, out, in)
        self.clock = clock
        self._lock = threading.Lock()
        self._clients = []
        self._rr = 0
        self._dial_fails = 0
        self._next_dial = 0.0

    def _acquire(self):
        from bigdl_tpu_torch.optim.recovery import capped_backoff

        with self._lock:
            self._clients = [c for c in self._clients if not c.broken]
            if len(self._clients) < self.size:
                now = self.clock()
                if now >= self._next_dial:
                    try:
                        self._clients.append(
                            WireClient(self.host, self.port,
                                       token=self.token,
                                       dial_timeout=self.dial_timeout,
                                       max_frame_bytes=
                                       self.max_frame_bytes))
                        self._dial_fails = 0
                    except (OSError, ConnectionError) as e:
                        self._dial_fails += 1
                        self._next_dial = now + capped_backoff(
                            self._dial_fails - 1, self.backoff_base_s,
                            self.backoff_max_s)
                        if not self._clients:
                            raise ConnectionError(
                                f"dial to worker {self.host}:"
                                f"{self.port} failed: {e}") from e
                elif not self._clients:
                    raise ConnectionError(
                        f"worker {self.host}:{self.port} unreachable; "
                        f"re-dial backing off another "
                        f"{self._next_dial - now:.3f}s")
            self._rr += 1
            return self._clients[self._rr % len(self._clients)]

    def _evict(self, client):
        with self._lock:
            self._clients = [c for c in self._clients if c is not client]
        client.close()

    def request_ex(self, op, rpc_timeout=30.0, **kwargs):
        client = self._acquire()
        t0 = time.perf_counter()
        try:
            result, out, inn = client.request_ex(
                op, rpc_timeout=rpc_timeout, **kwargs)
        except Exception:
            if client.broken:
                self._evict(client)
            raise
        if self.on_wire is not None:
            try:
                self.on_wire(op, time.perf_counter() - t0, out, inn)
            except Exception:
                log.exception("wire stats callback failed")
        return result, out, inn

    def request(self, op, rpc_timeout=30.0, **kwargs):
        return self.request_ex(op, rpc_timeout=rpc_timeout, **kwargs)[0]

    @property
    def connections(self):
        with self._lock:
            return len(self._clients)

    def stats(self):
        """Aggregate live-connection counters -- read BEFORE ``close``
        (``pickle_fallbacks`` pins the no-arrays-through-pickle claim)."""
        with self._lock:
            return {"connections": len(self._clients),
                    "bytes_sent": sum(c.bytes_sent
                                      for c in self._clients),
                    "bytes_recv": sum(c.bytes_recv
                                      for c in self._clients),
                    "pickle_fallbacks": sum(c.pickle_fallbacks
                                            for c in self._clients)}

    def close(self):
        with self._lock:
            clients, self._clients = self._clients, []
        for c in clients:
            c.close()


def call_once(host, port, op, rpc_timeout=30.0, auth_token=None,
              **kwargs):
    """One request/response on a throwaway binary-wire connection (the
    tooling/test shape; fleets keep a ``WirePool``).  The handshake
    secret is named ``auth_token`` ON PURPOSE: the deploy ops carry a
    staged-handle ``token=`` request field through ``**kwargs``."""
    client = WireClient(host, port, token=auth_token,
                        dial_timeout=rpc_timeout)
    try:
        return client.request(op, rpc_timeout=rpc_timeout, **kwargs)
    finally:
        client.close()


# --------------------------------------------------------------------------- #
# Blockwise-int8 weight distribution (EQuARX direction).
# --------------------------------------------------------------------------- #

WIRE_QUANT_BLOCK = 256


def quantize_tree_for_wire(tree, block_size=WIRE_QUANT_BLOCK,
                           min_size=1024):
    """Rewrite floating leaves into blockwise-int8 wire form: each
    becomes ``{"__q8__": 1, "q": int8 payload, "s": fp32 per-block
    scales, "shape", "n", "bs", "dtype"}`` using the blockwise kernels
    (``ops/quantization.py``, bitwise the JAX package's on the same
    numpy tree; scales are fp32 so the worker-side dequantization is
    bit-deterministic).  Leaves smaller than
    ``min_size`` elements or non-floating ship raw -- the bookkeeping
    overhead would beat the savings.  Per-element roundtrip error is
    bounded by ~0.51 int8 ulp of the block absmax (the kernels'
    documented bound); the deploy gate still judges the staged result.
    """
    from bigdl_tpu_torch.ops.quantization import quantize_blockwise

    bs = int(block_size)

    def walk(x):
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(walk(v) for v in x)
        if x is None or not _is_array(x) and not isinstance(x, np.generic):
            return x
        a = _host_array(x)
        if a.dtype.kind != "f" or a.size < int(min_size):
            return x
        flat = np.ascontiguousarray(a, dtype=np.float32).ravel()
        pad = (-flat.size) % bs
        if pad:
            flat = np.concatenate([flat, np.zeros(pad, np.float32)])
        q, s = quantize_blockwise(torch.from_numpy(flat), bs,
                                  scale_dtype="fp32")
        return {"__q8__": 1, "q": q.numpy(),
                "s": s.numpy().astype(np.float32, copy=False),
                "shape": [int(d) for d in a.shape], "n": int(a.size),
                "bs": bs, "dtype": str(a.dtype)}

    return walk(tree)


def dequantize_wire_tree(tree):
    """Invert ``quantize_tree_for_wire`` (identity on trees with no
    ``__q8__`` markers, so fp32 staging traffic takes the same call)."""
    def walk(x):
        if isinstance(x, dict):
            if x.get("__q8__"):
                from bigdl_tpu_torch.ops.quantization import \
                    dequantize_blockwise

                flat = dequantize_blockwise(
                    torch.from_numpy(np.ascontiguousarray(x["q"])),
                    torch.from_numpy(np.ascontiguousarray(
                        x["s"], np.float32)),
                    int(x["bs"])).numpy()
                n = int(x["n"])
                a = flat[:n].reshape([int(d) for d in x["shape"]])
                return a.astype(_dtype_of(x["dtype"]))
            return {k: walk(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(walk(v) for v in x)
        return x

    return walk(tree)


def tree_wire_bytes(tree):
    """The tensor-frame bytes a tree will put on the wire (payload
    buffers only; the JSON skeleton adds a few hundred bytes)."""
    _, tensors, _ = encode_payload(tree)
    return int(sum(a.nbytes for a in tensors))
