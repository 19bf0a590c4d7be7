"""Versioned on-disk store for the built kernel library.

The port's copy of ``eges_tpu/crypto/aotstore.py``.  The reference
stores one ``jax.export``-serialized graph per (op, bucket); the port's
artifact is the shared library ``ops/build.py`` makes with ``nvcc`` (all
29 kernels, every lane instance), so a store holds one artifact per
device kind, keyed by the torch and CUDA versions, the card's sm
capability and ``ops/build.py``'s ``source_hash()`` (the sources and
the flags they are built with).

``ops/build.py`` already keeps the library it built in the checkout's
build directory, so a node restarted in the same checkout opens it
without the store.  The store serves what that cache cannot: a new
checkout of the same sources (a redeploy, or another host of an ssh
fan-out) whose ``EGES_AOT_DIR`` outlives or is shared beyond one
checkout.  Such a node finds no library in its build directory, writes
the stored one there and loads it in a fraction of a second where
``nvcc`` takes minutes.  The load/build policy lives in
:func:`load_or_build` and
:meth:`eges_tpu_torch.crypto.verifier.BatchVerifier.aot_prewarm`.

Every artifact carries a versioned header and a sha256 integrity
digest of the payload.  ANY mismatch — torn file, corrupted payload,
another torch or CUDA version, another sm capability, an edited kernel
source, another device kind — makes :meth:`AotStore.load` return
``None``, and the caller builds with ``nvcc`` and saves: a bad artifact
degrades to a build, never to a crash.  A build that fails raises; no
caller runs on without its kernels.

Knobs:

* ``EGES_AOT_DIR`` — artifact directory (default ``<repo>/build/aot``);
* ``EGES_AOT_DISABLE=1`` — disable the store entirely
  (:func:`default_store` returns ``None``; every consumer then builds
  exactly as before this layer).

The reference's ``enable_persistent_cache`` configures JAX's compile
cache; an eager CUDA port has no graph compile to cache, so it has no
counterpart here.  This module imports torch only inside
:func:`runtime_versions`, lazily.
"""

from __future__ import annotations

import hashlib
import json
import os
import struct
import tempfile
import time

_MAGIC = b"EGESAOT1"

# the one artifact a store holds for a device kind
LIBRARY = "kernels"


def _repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def code_fingerprint() -> str:
    """The ``code_rev`` half of the artifact key: ``ops/build.py``'s
    hash of the kernel sources, headers, build units and flags — the
    same hash that names the library in the build directory."""
    from eges_tpu_torch.ops import build
    return build.source_hash()


def runtime_versions() -> dict:
    """The torch and CUDA versions and the sm capability baked into
    every artifact header.  Without a card the capability is ``none``
    (such a process never builds a library, so it saves none)."""
    import torch

    sm = "none"
    if torch.cuda.is_available():
        major, minor = torch.cuda.get_device_capability()
        sm = f"{major}.{minor}"
    return {"torch": torch.__version__,
            "cuda": torch.version.cuda or "none", "sm": sm}


def _safe(part: str) -> str:
    return "".join(c if c.isalnum() or c in "._-" else "_" for c in part)


class AotStore:
    """One directory of ``<name>_<device-kind>.aot`` artifacts.

    File format: ``EGESAOT1`` magic, a u32 header length, the header
    JSON (versions, sm capability, device kind, name, code rev, payload
    sha256 + length), then the payload (the library's bytes).  Writes
    are atomic (tempfile + rename) so a crashed writer leaves no torn
    artifact under the key — a torn temp file is never looked at.
    """

    def __init__(self, root: str, fingerprint: str | None = None,
                 versions: dict | None = None):
        self.root = root
        self.fingerprint = fingerprint or code_fingerprint()
        self.versions = dict(versions or runtime_versions())

    def path_for(self, name: str, device_kind: str) -> str:
        return os.path.join(self.root,
                            f"{_safe(name)}_{_safe(device_kind)}.aot")

    def _header(self, name: str, device_kind: str, payload: bytes) -> dict:
        return {"format": 1, "name": name, "device_kind": device_kind,
                "code_rev": self.fingerprint,
                "torch": self.versions.get("torch", "none"),
                "cuda": self.versions.get("cuda", "none"),
                "sm": self.versions.get("sm", "none"),
                "payload_len": len(payload),
                "sha256": hashlib.sha256(payload).hexdigest()}

    def save(self, name: str, device_kind: str, payload: bytes) -> str:
        """Atomically write one artifact; returns its path."""
        from eges_tpu_torch.utils.metrics import DEFAULT as metrics

        header = json.dumps(self._header(name, device_kind, payload),
                            sort_keys=True).encode()
        path = self.path_for(name, device_kind)
        _write_atomic(path, _MAGIC + struct.pack("<I", len(header))
                      + header + payload)
        metrics.counter("verifier.aot_saves").inc()
        return path

    def load(self, name: str, device_kind: str) -> bytes | None:
        """The payload for one key, or ``None`` on ANY mismatch
        (missing file, bad magic, torn/corrupted payload, another torch,
        CUDA or sm capability, another code rev) — callers fall through
        to a build, they never crash on a bad artifact."""
        path = self.path_for(name, device_kind)
        try:
            with open(path, "rb") as fh:
                blob = fh.read()
        except OSError:
            return None
        want = self._header(name, device_kind, b"")
        try:
            if blob[:8] != _MAGIC:
                raise ValueError("bad magic")
            (hlen,) = struct.unpack("<I", blob[8:12])
            header = json.loads(blob[12:12 + hlen])
            payload = blob[12 + hlen:]
            for key in ("format", "name", "device_kind", "code_rev",
                        "torch", "cuda", "sm"):
                if header.get(key) != want[key]:
                    raise ValueError(
                        f"{key} mismatch: artifact has "
                        f"{header.get(key)!r}, runtime wants {want[key]!r}")
            if header.get("payload_len") != len(payload):
                raise ValueError("payload length mismatch (torn write?)")
            if header.get("sha256") != hashlib.sha256(payload).hexdigest():
                raise ValueError("payload digest mismatch (corruption)")
            return payload
        # analysis: allow-swallow(a stale/corrupted artifact degrades to
        # a build — the error is logged + counted, the caller sees a
        # plain miss)
        except Exception as e:
            from eges_tpu_torch.utils.log import get_logger
            from eges_tpu_torch.utils.metrics import DEFAULT as metrics

            metrics.counter("verifier.aot_load_errors").inc()
            get_logger("geec.aot").warn(
                "aot artifact rejected", path=path, err=str(e))
            return None

    def entries(self) -> list[str]:
        """Artifact file names currently in the store (diagnostics)."""
        try:
            return sorted(f for f in os.listdir(self.root)
                          if f.endswith(".aot"))
        except OSError:
            return []


def default_store() -> AotStore | None:
    """The process-default store per the env knobs; ``None`` when
    disabled (consumers then build exactly as before this layer)."""
    if os.environ.get("EGES_AOT_DISABLE") == "1":
        return None
    root = os.environ.get("EGES_AOT_DIR") or os.path.join(
        _repo_root(), "build", "aot")
    return AotStore(root)


def _write_atomic(path: str, payload: bytes) -> None:
    """Write ``path`` through a tempfile and a rename, so no reader ever
    sees a torn file under the name."""
    d = os.path.dirname(path) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as fh:
            fh.write(payload)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def load_or_build(store: AotStore | None, device_kind: str, build,
                  target: str) -> tuple[str, float, str]:
    """Put the kernel library at ``target``, where ``ops/build.py``
    loads it from, and leave a valid copy in ``store``.

    The mode says where the library came from: ``"build_dir"`` when
    ``target`` already holds it (``ops/build.py``'s own cache: no nvcc,
    no store read), ``"load"`` when the store's artifact was written
    there (atomically: a process that has the old file open keeps it),
    ``"compile"`` when ``build()`` ran nvcc.  ``build()`` returns
    ``ops/build.py``'s ``{"path", "built", ...}`` and raises when the
    build fails; a build that found the library made by another process
    meanwhile (``built`` false) is a ``"build_dir"`` hit too.  Unless
    the mode is ``"load"``, a store without a valid artifact gets this
    library for the next checkout; an unwritable store costs only that
    checkout its warm start.  Returns ``(mode, seconds, path)``."""
    from eges_tpu_torch.utils.log import get_logger

    t0 = time.monotonic()
    if os.path.exists(target):
        mode, path = "build_dir", target
    else:
        payload = store.load(LIBRARY, device_kind) if store is not None \
            else None
        if payload is not None:
            _write_atomic(target, payload)
            return "load", time.monotonic() - t0, target
        res = build()
        mode = "compile" if res["built"] else "build_dir"
        path = res["path"]
    dt = time.monotonic() - t0
    if store is not None and store.load(LIBRARY, device_kind) is None:
        try:
            with open(path, "rb") as fh:
                store.save(LIBRARY, device_kind, fh.read())
        # analysis: allow-swallow(an unwritable artifact dir only costs
        # the NEXT checkout its warm start; this one has its library)
        except Exception as e:
            get_logger("geec.aot").warn("aot artifact save failed",
                                        path=path, err=str(e))
    return mode, dt, path
