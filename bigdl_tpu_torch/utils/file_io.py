"""Checkpoint persistence, local and remote (the port's copy of
``bigdl_tpu/utils/file_io.py``: the path helpers :83-146, ``save`` /
``atomic_save`` / ``with_write_retries`` :166-203, the manifests and
quarantine :225-365, ``load`` :374 and the checkpoint functions
:379-435).

A snapshot is a pickle of numpy trees, the JAX package's format: the
same names (``checkpoint.<neval>.pkl`` beside
``checkpoint.<neval>.pkl.manifest.json``), the same payload keys, dicts
with their keys sorted and every leaf a numpy array, as ``jax.tree.map``
leaves them.  A snapshot written by either package loads in the other.
Torch tensors are copied to host numpy on the way (``_to_numpy``).

Crash safety is JAX's: every snapshot is written under a temporary name
and renamed into place, a sidecar manifest stamps the byte count and
sha256 of every file it covers, resolution verifies candidates newest
first and renames a failure to ``*.corrupt`` (evidence kept), and a
write retries transient ``OSError``s with bounded backoff.  URL-schemed
paths (``s3://``, ``gs://``, ``memory://`` ...) go through ``fsspec``
where it is installed, plain paths through ``os``.  The orbax sharded
snapshots are not ported: the single-device optimizer refuses them, as
the JAX ``LocalOptimizer`` does.
"""

import hashlib
import json
import logging
import os
import pickle
import re
import time
from typing import Any

import numpy as np
import torch

from bigdl_tpu_torch.utils import config

log = logging.getLogger("bigdl_tpu_torch.optim")

_SCHEME = re.compile(r"^[a-zA-Z][a-zA-Z0-9+.-]*://")

#: sidecar integrity manifest next to every snapshot
MANIFEST_SUFFIX = ".manifest.json"
#: a snapshot that failed verification is renamed, never deleted
QUARANTINE_SUFFIX = ".corrupt"
#: in-flight writes carry this marker until the atomic rename
TMP_MARKER = ".tmp-"


def _is_remote(path: str) -> bool:
    return bool(_SCHEME.match(str(path))) and not str(path).startswith(
        "file://")


def is_remote(path: str) -> bool:
    """True for URL-schemed (fsspec-routed) paths."""
    return _is_remote(path)


def _fs_for(path: str):
    try:
        import fsspec
    except ImportError as e:
        raise ImportError(
            f"reading/writing {path} needs the optional fsspec "
            f"dependency") from e
    fs, _, paths = fsspec.get_fs_token_paths(path)
    return fs, paths[0]


def open_file(path: str, mode: str = "rb"):
    """Open a local path or any fsspec URL (hdfs://, s3://, gs://, ...)."""
    if _is_remote(path):
        fs, p = _fs_for(path)
        if "w" in mode:
            parent = p.rsplit("/", 1)[0]
            if parent:
                fs.makedirs(parent, exist_ok=True)
        return fs.open(p, mode)
    if "w" in mode:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    return open(path, mode)


def exists(path: str) -> bool:
    if _is_remote(path):
        fs, p = _fs_for(path)
        return fs.exists(p)
    return os.path.exists(path)


def listdir(path: str):
    if _is_remote(path):
        fs, p = _fs_for(path)
        if not fs.isdir(p):
            return []
        return [e.rsplit("/", 1)[-1] for e in fs.ls(p, detail=False)]
    if not os.path.isdir(path):
        return []
    return os.listdir(path)


def join(path: str, *parts: str) -> str:
    if _is_remote(path):
        return "/".join([str(path).rstrip("/")] + [p.strip("/")
                                                   for p in parts])
    return os.path.join(path, *parts)


def getsize(path: str) -> int:
    if _is_remote(path):
        fs, p = _fs_for(path)
        return int(fs.size(p))
    return os.path.getsize(path)


def isdir(path: str) -> bool:
    if _is_remote(path):
        fs, p = _fs_for(path)
        return fs.isdir(p)
    return os.path.isdir(path)


def rename(src: str, dst: str):
    """Atomic replace for local paths; a best-effort move for remote ones
    (object stores have no true rename)."""
    if _is_remote(src):
        fs, s = _fs_for(src)
        _, d = _fs_for(dst)
        fs.mv(s, d, recursive=True)
        return
    os.replace(src, dst)


def sha256_of(path: str) -> str:
    h = hashlib.sha256()
    with open_file(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _to_numpy(tree):
    """``tree`` as ``jax.tree.map(np.asarray, tree)`` leaves it: dicts
    with sorted keys, tuples and lists kept, ``None`` kept, every other
    leaf a numpy array (a tensor copied to the host)."""
    if isinstance(tree, dict):
        return {k: _to_numpy(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to_numpy(v) for v in tree)
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


def save(obj: Any, path: str):
    with open_file(path, "wb") as f:
        pickle.dump(_to_numpy(obj), f)


def atomic_save(obj: Any, path: str):
    """``save`` through a temp name and a rename: a writer killed
    mid-write leaves only a ``*.tmp-*`` orphan, never a truncated
    ``path``."""
    tmp = path + TMP_MARKER + str(os.getpid())
    with open_file(tmp, "wb") as f:
        pickle.dump(_to_numpy(obj), f)
        f.flush()
        try:
            os.fsync(f.fileno())
        except (OSError, AttributeError):  # remote/exotic filesystems
            pass
    rename(tmp, path)


def with_write_retries(fn, what="checkpoint write", retries=None,
                       backoff_s=0.1, sleep=time.sleep):
    """Run ``fn()``, retrying transient IO failures (``OSError``) with
    exponential backoff, one warning a retry; re-raise past the budget
    (``BIGDL_CKPT_WRITE_RETRIES``, default 2).  Other failures (a
    pickling error) are not retried."""
    if retries is None:
        retries = config.ckpt_write_retries()
    for attempt in range(retries + 1):
        try:
            return fn()
        except OSError as e:
            if attempt >= retries:
                raise
            delay = backoff_s * (2 ** attempt)
            log.warning("%s failed (%s); retry %d/%d in %.2fs",
                        what, e, attempt + 1, retries, delay)
            sleep(delay)


# --------------------------------------------------------------------------- #
# Snapshot integrity: sidecar manifests, verification, quarantine.
# --------------------------------------------------------------------------- #


def _walk_files(target: str):
    """Relative paths of every regular file under ``target`` (itself,
    when it is a file), keyed relative to its parent directory: the
    manifest's key space."""
    base = os.path.basename(str(target).rstrip("/"))
    if not isdir(target):
        return [base]
    out = []
    for root, _, files in os.walk(target):
        rel_root = os.path.relpath(root, os.path.dirname(target))
        out.extend(os.path.join(rel_root, f) for f in files)
    return sorted(out)


def write_snapshot_manifest(target: str, extra_files=(), meta=None):
    """Stamp ``<target>.manifest.json``: bytes and sha256 of every file
    the snapshot consists of, plus the caller's metadata.  Written
    atomically, after the snapshot itself is renamed into place, so a
    manifest's presence implies the files it covers were fully
    written."""
    parent = os.path.dirname(str(target).rstrip("/"))
    rels = _walk_files(target) + [os.path.basename(str(f)) for f in
                                  extra_files]
    files = {}
    for rel in rels:
        p = join(parent, rel) if parent else rel
        if _is_remote(target) and isdir(target):
            continue
        files[rel] = {"bytes": getsize(p), "sha256": sha256_of(p)}
    manifest = {"schema_version": 1, "created": time.time(),
                "kind": "dir" if isdir(target) else "file",
                "files": files}
    if meta:
        manifest.update(meta)
    mpath = str(target).rstrip("/") + MANIFEST_SUFFIX
    tmp = mpath + TMP_MARKER + str(os.getpid())
    with open_file(tmp, "wb") as f:
        f.write(json.dumps(manifest, indent=1).encode())
    rename(tmp, mpath)
    return mpath


def read_manifest(target: str):
    """The parsed sidecar manifest of a snapshot path, or None (absent
    or unparseable: an unparseable manifest must not brick resume)."""
    mpath = str(target).rstrip("/") + MANIFEST_SUFFIX
    if not exists(mpath):
        return None
    try:
        with open_file(mpath, "rb") as f:
            return json.loads(f.read().decode(errors="replace"))
    except (OSError, ValueError):
        return None


def verify_snapshot(target: str, legacy_load: bool = False):
    """None when the snapshot passes verification, else the reason.
    With a manifest every covered file must exist with the stamped size
    and sha256 (truncation and bit flips).  Without one (a legacy
    snapshot, or a crash between the data rename and the manifest's)
    ``legacy_load`` falls back to an unpickle attempt."""
    if not exists(target):
        return "missing"
    manifest = read_manifest(target)
    if manifest is None:
        if legacy_load and not isdir(target):
            try:
                load(target)
            except Exception as e:
                return f"no manifest and unreadable pickle ({e!r:.120})"
        return None
    parent = os.path.dirname(str(target).rstrip("/"))
    for rel, rec in (manifest.get("files") or {}).items():
        p = join(parent, rel) if parent else rel
        if not exists(p):
            return f"{rel}: missing"
        size = getsize(p)
        if size != rec.get("bytes"):
            return f"{rel}: {size} bytes, manifest says {rec.get('bytes')}"
        if sha256_of(p) != rec.get("sha256"):
            return f"{rel}: sha256 mismatch"
    return None


def quarantine_snapshot(target: str, sidecars=()):
    """Rename a failed snapshot (and its manifest and sidecars) to
    ``*.corrupt``: out of resume's way, evidence kept.  Returns the
    quarantined paths."""
    moved = []
    for p in [str(target).rstrip("/"),
              str(target).rstrip("/") + MANIFEST_SUFFIX] + \
            [str(s) for s in sidecars]:
        if not exists(p):
            continue
        try:
            rename(p, p + QUARANTINE_SUFFIX)
            moved.append(p + QUARANTINE_SUFFIX)
        except OSError:
            log.warning("could not quarantine %s", p, exc_info=True)
    if moved:
        log.warning("quarantined corrupt snapshot: %s", moved)
    return moved


def load(path: str) -> Any:
    with open_file(path, "rb") as f:
        return pickle.load(f)


def save_checkpoint(path: str, tag, model_params, model_state, opt_state,
                    driver_state, manifest_meta=None):
    """One training snapshot (model, optimizer state, loop counters),
    resumable: temp write and atomic rename, a sidecar digest manifest,
    transient-IO retries.  Returns the snapshot's path."""
    target = join(path, f"checkpoint.{tag}.pkl")
    payload = {
        "model_params": model_params,
        "model_state": model_state,
        "opt_state": opt_state,
        "driver_state": dict(driver_state),
    }

    def write():
        atomic_save(payload, target)
        write_snapshot_manifest(target, meta=manifest_meta)

    with_write_retries(write, what=f"checkpoint write ({target})")
    return target


def _ckpt_tag(name):
    try:
        return int(str(name).split(".")[1].split("_")[-1])
    except (ValueError, IndexError):
        return -1


def scan_checkpoints(path: str):
    """``([newest intact snapshot path] or [], quarantined paths)``.
    Verifies the ``checkpoint.<tag>.pkl`` candidates newest first,
    quarantining failures on the spot, and stops at the first intact
    one; older snapshots stay unverified until a resolution reaches
    them."""
    quarantined = []
    snaps = sorted((f for f in listdir(path)
                    if f.startswith("checkpoint.") and f.endswith(".pkl")),
                   key=_ckpt_tag, reverse=True)
    for name in snaps:
        target = join(path, name)
        reason = verify_snapshot(target, legacy_load=True)
        if reason is None:
            return [target], quarantined
        log.warning("snapshot %s failed verification (%s)",
                    target, reason)
        quarantined.extend(quarantine_snapshot(target))
    return [], quarantined


def latest_checkpoint(path: str):
    """The newest intact snapshot (corrupt ones are quarantined), or
    None."""
    intact, _ = scan_checkpoints(path)
    return intact[0] if intact else None
