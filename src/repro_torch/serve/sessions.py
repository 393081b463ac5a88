"""Per-tenant twin sessions: checkpoint and restore through the codec
(port of ``repro.serve.sessions``).

A *session* is the durable identity of one tenant's twin mid-stream: the
calibrated :class:`~repro_torch.core.state.TwinState`, the next window its
stream expects, and the rolling digest the result cache keys on.  The
:class:`SessionStore` writes each as one codec blob
(:func:`repro_torch.core.codec.dumps` — same one-byte-id envelope as every
other artifact in the repo), so killing a
:class:`~repro_torch.serve.service.TwinService` and restoring it resumes
**bit-for-bit**: the restored twin replays exactly where the
uninterrupted one would be.  The blobs are the JAX package's format.

Writes are atomic (tempfile + ``os.replace``) like
:meth:`repro_torch.core.telemetry.TelemetryStore.flush` — a crash mid-
checkpoint leaves the previous consistent snapshot.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import tempfile

from repro_torch.core import codec
from repro_torch.core.state import TwinState, state_from_bytes, state_to_bytes

_SESSION_VERSION = 1


@dataclasses.dataclass(frozen=True)
class Session:
    """One tenant's durable stream position."""

    tenant: str
    state: TwinState
    next_window: int
    digest: str


def _filename(tenant: str) -> str:
    # tenant names come from config files and tests; keep the mapping
    # readable but filesystem-safe (and collision-free via a suffix hash)
    safe = "".join(c if c.isalnum() or c in "-_." else "_" for c in tenant)
    tag = hashlib.sha256(tenant.encode()).hexdigest()[:8]
    return f"{safe}.{tag}.session"


class SessionStore:
    """Directory of per-tenant session blobs; states load onto ``device``."""

    def __init__(self, root, device="cuda"):
        self.root = os.fspath(root)
        self.device = device
        os.makedirs(self.root, exist_ok=True)

    def _path(self, tenant: str) -> str:
        return os.path.join(self.root, _filename(tenant))

    def save(self, session: Session) -> None:
        payload = {
            "version": _SESSION_VERSION,
            "tenant": session.tenant,
            "next_window": int(session.next_window),
            "digest": session.digest,
            "state": state_to_bytes(session.state),
        }
        blob = codec.dumps(payload)
        fd, tmp = tempfile.mkstemp(dir=self.root, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(blob)
            os.replace(tmp, self._path(session.tenant))
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    def load(self, tenant: str) -> Session:
        with open(self._path(tenant), "rb") as f:
            payload = codec.loads(f.read())
        if payload.get("version") != _SESSION_VERSION:
            raise ValueError(
                f"session blob for {tenant!r} has version "
                f"{payload.get('version')}, expected {_SESSION_VERSION}")
        return Session(
            tenant=payload["tenant"],
            state=state_from_bytes(payload["state"], device=self.device),
            next_window=int(payload["next_window"]),
            digest=payload["digest"],
        )

    def __contains__(self, tenant: str) -> bool:
        return os.path.exists(self._path(tenant))

    @property
    def tenants(self) -> "list[str]":
        """Tenants with a saved session, sorted by name."""
        names = []
        for fn in os.listdir(self.root):
            if not fn.endswith(".session"):
                continue
            with open(os.path.join(self.root, fn), "rb") as f:
                names.append(codec.loads(f.read())["tenant"])
        return sorted(names)
