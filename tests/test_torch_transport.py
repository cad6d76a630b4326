"""The port's binary wire (``bigdl_tpu_torch/serving/transport.py``)
against the JAX package's (``bigdl_tpu/serving/transport.py``) on the
CPU.

Held bitwise: the frames of the same payload (numpy float32, int32, int8
and bool arrays nested with plain values), the int8 weight wire's
payload, scales and dequantized tree (``quantize_tree_for_wire`` against
JAX's on the same numpy tree).  Held by name: the exception type each
package raises for a truncated frame, bad magic, a foreign version and
an oversize frame, and for a restricted-unpickler refusal.  Across
packages: JAX's ``WireClient`` against the port's ``serve_connection``
and the other way round, with the right run token and a wrong one.  The
pool's eviction and re-dial after a SIGKILLed child: the listening
socket stays open in this process and is handed to the child and to its
successor, so no port is given up and bound again.

Every listener binds ``127.0.0.1:0``; every child is a fresh interpreter
with its output in ``tmp_path``, killed and waited for with a timeout.
"""

import base64
import json
import os
import pickle
import signal
import socket
import struct
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from bigdl_tpu.serving import transport as jt
from bigdl_tpu_torch.serving import transport as tt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PAYLOADS = {
    "float32": {"x": np.random.default_rng(0).standard_normal(
        (3, 5)).astype(np.float32)},
    "int32_int8_bool": {"ids": np.arange(12, dtype=np.int32).reshape(3, 4),
                        "q": np.arange(-4, 4, dtype=np.int8),
                        "mask": np.array([True, False, True])},
    "nested_plain": {"op": "predict", "timeout": 2.5, "n": 3,
                     "flag": None, "tags": ["a", "b"],
                     "pair": (1, np.float32(0.5)),
                     "blob": b"\x00\x01", "odd": {1: "one"},
                     "rows": [np.ones((2, 2), np.float32),
                              {"deep": np.zeros(0, np.int32)}]},
    "reserved_key": {"__t__": 7, "feature": np.full(4, 2.0, np.float32)},
    "scalar_array": {"s": np.array(3.25, np.float32),
                     "v": np.arange(5, dtype=np.int32)},
}


def _wire_bytes(mod, payload, msg_id=7):
    """The bytes one ``WireConnection.send_message`` puts on a socket."""
    a, b = socket.socketpair()
    a.settimeout(5.0)
    b.settimeout(5.0)
    got, done = [], threading.Event()

    def drain():
        while True:
            try:
                chunk = b.recv(1 << 16)
            except OSError:
                break
            if not chunk:
                break
            got.append(chunk)
        done.set()

    t = threading.Thread(target=drain, daemon=True)
    t.start()
    try:
        n = mod.WireConnection(a).send_message(payload, msg_id)
    finally:
        a.close()
    done.wait(5.0)
    b.close()
    data = b"".join(got)
    assert len(data) == n
    return data


@pytest.mark.parametrize("name", sorted(PAYLOADS))
def test_payload_frames_are_byte_identical(name):
    payload = PAYLOADS[name]
    want = _wire_bytes(jt, payload)
    assert _wire_bytes(tt, payload) == want
    sk, tensors, stats = tt.encode_payload(payload)
    assert stats["pickle_fallbacks"] == 0
    back = tt.decode_payload(sk, tensors)
    jback = jt.decode_payload(*jt.encode_payload(payload)[:2])
    assert repr(back) == repr(jback)


def test_tensors_cross_as_numpy():
    """A tensor in a payload crosses as ``.cpu().numpy()``: the frames of
    a tensor payload are those of its numpy twin, and the receiver gets
    numpy."""
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    ids = torch.tensor([3, 1], dtype=torch.int32)
    want = _wire_bytes(jt, {"x": x.numpy(), "ids": ids.numpy()})
    assert _wire_bytes(tt, {"x": x, "ids": ids}) == want
    sk, tensors, _ = tt.encode_payload({"x": x})
    out = tt.decode_payload(sk, tensors)["x"]
    assert isinstance(out, np.ndarray)
    np.testing.assert_array_equal(out, x.numpy())


def _pair():
    a, b = socket.socketpair()
    a.settimeout(5.0)
    b.settimeout(5.0)
    return a, b


def _raw_truncated(a, mod):
    a.sendall(mod._HEADER.pack(b"BW", 1, mod.FT_MSG, 100) + b"x" * 10)
    a.close()


def _raw_bad_magic(a, mod):
    a.sendall(struct.pack(">2sBBI", b"GE", 1, 4, 0))


def _raw_foreign_version(a, mod):
    a.sendall(struct.pack(">2sBBI", b"BW", 9, 4, 0))


def _raw_oversize(a, mod):
    a.sendall(struct.pack(">2sBBI", b"BW", 1, 4, mod.MAX_FRAME_BYTES + 1))


def _raw_truncated_tensor(a, mod):
    env = json.dumps({"id": 1, "nt": 1,
                      "body": {"x": {"__t__": 0}}}).encode()
    a.sendall(mod._HEADER.pack(b"BW", 1, mod.FT_MSG, len(env)) + env)
    hdr = json.dumps({"d": "float32", "s": [1024]}).encode()
    a.sendall(mod._HEADER.pack(b"BW", 1, mod.FT_TENSOR,
                               4 + len(hdr) + 4096))
    a.sendall(struct.pack(">I", len(hdr)) + hdr + b"\x00" * 100)
    a.close()


RAW = {"truncated": _raw_truncated, "bad_magic": _raw_bad_magic,
       "foreign_version": _raw_foreign_version, "oversize": _raw_oversize,
       "truncated_tensor": _raw_truncated_tensor}


def _refusal(mod, case):
    a, b = _pair()
    try:
        RAW[case](a, mod)
        try:
            mod.WireConnection(b).recv_message()
        except Exception as e:
            return type(e).__name__, str(e)
        raise AssertionError(f"{case}: nothing refused")
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("case", sorted(RAW))
def test_refusals_raise_the_same_types(case):
    """Each malformed stream is refused by an exception of the same type
    name, with the same message, in both packages."""
    assert _refusal(tt, case) == _refusal(jt, case)


def test_outbound_oversize_refused_in_both():
    got = []
    for mod in (jt, tt):
        a, b = _pair()
        try:
            with pytest.raises(mod.WireFrameError) as e:
                mod.WireConnection(a, max_frame_bytes=1024).send_message(
                    {"x": np.zeros(4096, np.float32)}, 1)
            got.append(str(e.value))
        finally:
            a.close()
            b.close()
    assert got[0] == got[1]


@pytest.mark.parametrize("obj", ["dtype", "device", "tensor", "system"])
def test_restricted_unpickler_refuses_torch_and_globals(obj):
    """Nothing of torch reaches a decoded payload: a ``torch.dtype``,
    ``torch.device`` or a whole tensor on the pickle fallback is refused
    by both packages' unpicklers, as ``os.system`` is."""
    value = {"dtype": torch.float32, "device": torch.device("cpu"),
             "tensor": torch.ones(2), "system": os.system}[obj]
    blob = pickle.dumps(value)
    sk = {"__py__": base64.b64encode(blob).decode()}
    names = []
    for mod in (tt, jt):
        with pytest.raises(mod.WireProtocolError) as e:
            mod.decode_payload(sk, [])
        names.append(type(e.value).__name__)
    assert names == ["WireProtocolError"] * 2


class _Listener:
    """A ``serve_connection`` server of one package on 127.0.0.1:0."""

    def __init__(self, mod, handler, token=None):
        self.sock = socket.socket()
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(8)
        self.sock.settimeout(0.2)
        self.port = self.sock.getsockname()[1]
        self.mod, self.handler, self.token = mod, handler, token
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._loop, daemon=True)
        self._t.start()

    def _loop(self):
        while not self._stop.is_set():
            try:
                conn, _ = self.sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            conn.settimeout(None)
            threading.Thread(target=self.mod.serve_connection,
                             args=(conn, self.handler),
                             kwargs={"token": self.token},
                             daemon=True).start()

    def close(self):
        self._stop.set()
        self._t.join(5.0)
        self.sock.close()


def _echo(req):
    return {"ok": True, "result": {"got": req.get("x"),
                                   "sum": float(np.sum(req["a"]))}}


@pytest.mark.parametrize("client,server", [("jax", "torch"),
                                           ("torch", "jax")])
def test_clients_and_servers_interoperate(client, server):
    """JAX's client against the port's server and the other way round:
    the right token answers (tensor frames both ways), a wrong one is
    refused with ``WireAuthError`` before any message."""
    mods = {"jax": jt, "torch": tt}
    srv = _Listener(mods[server], _echo, token="s3cret")
    cmod = mods[client]
    try:
        cli = cmod.WireClient("127.0.0.1", srv.port, token="s3cret",
                              dial_timeout=5.0)
        try:
            a = np.arange(10, dtype=np.float32)
            assert cli.request("ping", rpc_timeout=5.0, x=[1, "two"],
                               a=a) == {"got": [1, "two"], "sum": 45.0}
            assert cli.pickle_fallbacks == 0
        finally:
            cli.close()
        with pytest.raises(cmod.WireAuthError, match="run token"):
            cmod.WireClient("127.0.0.1", srv.port, token="wrong",
                            dial_timeout=5.0)
    finally:
        srv.close()


def test_quantize_tree_for_wire_is_bitwise_jax():
    rng = np.random.default_rng(5)
    tree = {"w": rng.standard_normal((64, 48)).astype(np.float32),
            "b": rng.standard_normal(48).astype(np.float32),
            "big": (rng.standard_normal(3000) * 50).astype(np.float32),
            "ids": np.arange(2048, dtype=np.int32),
            "nested": [{"z": np.zeros(1500, np.float32)},
                       rng.standard_normal((40, 40)).astype(np.float32)],
            "meta": "keep"}
    got = tt.quantize_tree_for_wire(tree)
    want = jt.quantize_tree_for_wire(tree)
    assert _wire_bytes(tt, got) == _wire_bytes(jt, want)
    assert got["big"]["q"].dtype == np.int8
    assert got["b"] is tree["b"]                 # under min_size: raw
    deq, jdeq = tt.dequantize_wire_tree(got), jt.dequantize_wire_tree(want)
    for k in ("w", "big"):
        np.testing.assert_array_equal(deq[k], np.asarray(jdeq[k]))
        # within ~0.51 int8 ulp of the block's absmax
        err = np.abs(deq[k] - tree[k]).max()
        assert err <= 0.51 * np.abs(tree[k]).max() / 127
    assert tt.tree_wire_bytes(got) == jt.tree_wire_bytes(want)


_CHILD = (
    "import socket, sys, threading\n"
    "import torch\n"
    "torch.set_num_threads(1)\n"
    "from bigdl_tpu_torch.serving.transport import serve_connection\n"
    "srv = socket.socket(fileno=int(sys.argv[1]))\n"
    "print('ready', flush=True)\n"
    "def h(req):\n"
    "    return {'ok': True, 'result': 'pong'}\n"
    "while True:\n"
    "    c, _ = srv.accept()\n"
    "    c.settimeout(None)\n"
    "    threading.Thread(target=serve_connection, args=(c, h),\n"
    "                     daemon=True).start()\n")


def _spawn(listener, log):
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    fd = listener.fileno()
    with open(log, "a") as f:
        return subprocess.Popen(
            [sys.executable, "-c", _CHILD, str(fd)], pass_fds=(fd,),
            env=env, stdout=f, stderr=subprocess.STDOUT, cwd=REPO)


def _until(fn, seconds):
    deadline = time.monotonic() + seconds
    while True:
        try:
            return fn()
        except (ConnectionError, OSError, TimeoutError):
            if time.monotonic() > deadline:
                raise
            time.sleep(0.05)


def test_pool_evicts_and_redials_after_sigkill(tmp_path):
    """A SIGKILLed peer process: in-flight requests fail typed, the broken
    connections are evicted, and once a successor accepts on the same
    listening socket (held open here throughout) the pool re-dials under
    its backoff and recovers."""
    listener = socket.socket()
    listener.bind(("127.0.0.1", 0))
    listener.listen(16)
    port = listener.getsockname()[1]
    log = str(tmp_path / "peer.log")
    procs = [_spawn(listener, log)]
    pool = tt.WirePool("127.0.0.1", port, size=2, dial_timeout=1.0,
                       backoff_base_s=0.01, backoff_max_s=0.05)
    try:
        assert _until(lambda: pool.request("ping", rpc_timeout=2.0),
                      30.0) == "pong"
        assert pool.request("ping", rpc_timeout=2.0) == "pong"
        assert pool.connections == 2
        os.kill(procs[0].pid, signal.SIGKILL)
        procs[0].wait(10)
        deadline = time.monotonic() + 10.0
        while not all(c.broken for c in pool._clients):
            assert time.monotonic() < deadline, "no connection broke"
            time.sleep(0.02)
        # no peer accepts: the re-dial's handshake times out, typed
        with pytest.raises(ConnectionError, match="dial"):
            pool.request("ping", rpc_timeout=2.0)
        assert pool.connections == 0, "broken connections evicted"
        procs.append(_spawn(listener, log))    # the successor
        assert _until(lambda: pool.request("ping", rpc_timeout=2.0),
                      30.0) == "pong"
        assert pool.stats()["pickle_fallbacks"] == 0
    finally:
        pool.close()
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait(10)
        listener.close()
