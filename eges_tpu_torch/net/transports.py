"""Real-socket network planes (asyncio).

The port's copy of ``eges_tpu/net/transports.py``, unchanged but for its
imports; a port plane and a reference plane handshake and exchange
frames.

The production counterpart of the simulator transports, mirroring the
reference's two planes (SURVEY §2.3):

* **Direct plane** — UDP datagrams, RLP payloads, exactly like the
  reference's election/reply sockets (consensus/geec/election/server.go
  binds ``--consensusPort``; replies dial ``ip:port`` from the request).
* **Gossip plane** — persistent TCP connections to a static peer list
  with length-prefixed frames.  The reference runs RLPx-encrypted devp2p
  here (p2p/rlpx.go: ECDH handshake + AES-CTR framing + MAC); the
  RLPx-parity layer here is :class:`_FrameAuth`: an ECDSA-signed ECDH
  handshake derives per-direction session keys, every keyed frame is
  ENCRYPTED with a per-frame SHAKE-256 keystream and carries a 16-byte
  keccak-MAC over (key, sequence, ciphertext) — encrypt-then-MAC —
  with a per-direction monotonic sequence, so tampered, replayed,
  reordered, or readable-on-the-wire frames are all ruled out.  Three
  generations interop (v3 encrypted / v2 MAC-only / v1 symmetric);
  downgrades below the endpoint's best generation are rejected unless
  explicitly allowed (mixed-mode upgrade flags).

Everything runs on one asyncio loop; inbound messages call straight into
the single-threaded :class:`~eges_tpu_torch.consensus.node.GeecNode`, so the
no-locks design of the state machines carries over unchanged.
"""

from __future__ import annotations

import asyncio
import struct
import time

from eges_tpu_torch.utils.log import get_logger

# peer-facing parse/dispatch errors are routine against hostile or
# mid-upgrade peers: logged at GDBUG so -v5 shows them without letting
# default verbosity drown in them
log = get_logger("net")


class AsyncioClock:
    """Clock interface over the running asyncio loop."""

    def __init__(self, loop: asyncio.AbstractEventLoop | None = None):
        self._loop = loop or asyncio.get_event_loop()

    def now(self) -> float:
        return self._loop.time()

    def call_later(self, delay_s: float, fn):
        return self._loop.call_later(delay_s, fn)  # TimerHandle has .cancel()


class _UdpProtocol(asyncio.DatagramProtocol):
    def __init__(self, on_datagram):
        self._on_datagram = on_datagram

    def datagram_received(self, data, addr):
        try:
            self._on_datagram(data)
        except Exception as exc:
            # one bad datagram must not kill the receive loop
            log.gdbug("direct datagram handler error", peer=str(addr),
                      err=repr(exc))


class DirectPlane:
    """UDP send/receive for election messages and validate/query replies."""

    def __init__(self, bind_ip: str, bind_port: int, on_direct):
        self.bind_ip = bind_ip
        self.bind_port = bind_port
        self._on_direct = on_direct
        self._transport: asyncio.DatagramTransport | None = None

    async def start(self) -> None:
        loop = asyncio.get_running_loop()
        self._transport, _ = await loop.create_datagram_endpoint(
            lambda: _UdpProtocol(self._on_direct),
            local_addr=(self.bind_ip, self.bind_port))

    def send(self, ip: str, port: int, data: bytes) -> None:
        if self._transport is not None:
            self._transport.sendto(data, (ip, port))

    def close(self) -> None:
        if self._transport is not None:
            self._transport.close()


class AuthError(Exception):
    """Peer failed the gossip-plane handshake or sent a bad MAC."""


def _keystream(key: bytes, seq: int, n: int) -> bytes:
    """Per-frame keystream: SHAKE-256 as a XOF keyed by
    ``(enc_key, sequence)``.  One hashlib call emits the whole stream
    for a frame of any size, and the per-direction monotonic sequence
    guarantees the (key, nonce) pair is never reused — the stream-
    cipher contract.  Fills the AES-CTR role of the reference's RLPx
    framing (p2p/rlpx.go) with a primitive the stdlib provides."""
    import hashlib

    return hashlib.shake_256(key + seq.to_bytes(8, "big")).digest(n)


def _xor(a: bytes, b: bytes) -> bytes:
    n = len(a)
    return (int.from_bytes(a, "big") ^ int.from_bytes(b, "big")).to_bytes(
        n, "big") if n else b""


class _FrameAuth:
    """Per-connection frame authentication + encryption (the
    p2p/rlpx.go-parity layer).

    Three handshake generations:

    * **v3 (ECDH, encrypted — the default when a node key is present)**
      — each side sends ``MAGIC3 || pubkey64 || nonce16 || sig65``
      where ``sig`` signs ``keccak(MAGIC3 || pubkey || nonce)`` with
      the node key.  MAC and encryption keys derive per-direction from
      the ECDH shared secret mixed with both nonces, so every
      connection has fresh keys no other member can compute.  Frames
      are sealed ciphertext (encrypt-then-MAC): a wire observer sees
      lengths and nothing else.  The peer's recovered address is
      exposed as :attr:`peer_addr` for membership gating.
    * **v2 (ECDH, MAC-only)** — same handshake body under ``MAGIC2``,
      frames authenticated but plaintext.  Hellos cross simultaneously
      (both sides write first), so a v3 endpoint's MAGIC3 hello is
      already on the wire when a v2 hello arrives; mixed mode works
      because v2 endpoints accept the higher-generation magic (same
      body shape) while the v3 side accepts the v2 hello only with
      ``allow_v2`` — both then derive the MAC-only keys.  The session
      runs at the lower of the two offered generations, never silently
      below what a flag allows.
    * **v1 (symmetric)** — ``MAGIC || nonce16`` with keys
      ``keccak(secret || nonces)``; kept for keyless tooling, rejected
      by keyed endpoints unless ``allow_downgrade``.

    Every frame carries ``keccak(key || seq_be8 || body)[:16]`` with a
    per-direction monotonic sequence — tampered, replayed or reordered
    frames fail.  (A keccak prefix-MAC is sound: sponges have no
    length-extension weakness.)"""

    MAGIC = b"geec-gossip-v1\x00\x00"
    MAGIC2 = b"geec-gossip-v2\x00\x00"
    MAGIC3 = b"geec-gossip-v3\x00\x00"

    def __init__(self, secret: bytes, keypair: tuple[bytes, bytes] | None = None,
                 allow_downgrade: bool = False, allow_v2: bool = False,
                 version: int = 3):
        import secrets as _secrets

        self.secret = secret
        self.keypair = keypair  # (priv32, pub64) -> v2/v3 handshake
        # Round-3 advisor: a keyed side silently accepting a v1 hello
        # bypasses the authorize() membership gate (peer_addr never
        # set), and the default v1 secret is derivable from the public
        # genesis file.  Downgrade is therefore opt-in (mixed-mode
        # deployments mid-upgrade), never the default.  The same policy
        # guards v3 -> v2 (losing confidentiality).
        self.allow_downgrade = allow_downgrade
        self.allow_v2 = allow_v2
        self.version = version if keypair is not None else 1
        self.my_nonce = _secrets.token_bytes(16)
        self.send_key = b""
        self.recv_key = b""
        self.send_enc = b""      # v3: per-direction encryption keys
        self.recv_enc = b""
        self.encrypts = False
        self.send_seq = 0
        self.recv_seq = 0
        self.peer_addr: bytes | None = None  # v2/v3: authenticated identity

    def hello(self) -> bytes:
        if self.keypair is None:
            return self.MAGIC + self.my_nonce
        from eges_tpu_torch.crypto import secp256k1 as secp
        from eges_tpu_torch.crypto.keccak import keccak256

        priv, pub = self.keypair
        magic = self.MAGIC3 if self.version >= 3 else self.MAGIC2
        body = magic + pub + self.my_nonce
        sig = secp.ecdsa_sign(keccak256(body), priv)
        return body + sig

    def on_hello(self, data: bytes) -> None:
        """Derive session keys from the peer's hello.

        Version negotiation: both sides send their best generation
        simultaneously; the session runs at the LOWER of the two — but
        an endpoint only accepts a generation below its own when the
        matching mixed-mode flag allows it (``allow_v2`` for
        v3 endpoints meeting v2, ``allow_downgrade`` for keyed
        endpoints meeting keyless v1).  A keyless endpoint can parse a
        v2/v3 hello's nonce and derive the v1 keys, so keyless tooling
        interops with a flagged keyed peer instead of mutually
        AuthError-ing."""
        from eges_tpu_torch.crypto.keccak import keccak256

        m2 = len(self.MAGIC2)
        keyed = (data[:m2] in (self.MAGIC2, self.MAGIC3)
                 and len(data) == m2 + 64 + 16 + 65)
        if keyed:
            peer_version = 3 if data[:m2] == self.MAGIC3 else 2
            peer_pub = data[m2 : m2 + 64]
            peer_nonce = data[m2 + 64 : m2 + 80]
            if self.keypair is not None:
                from eges_tpu_torch.crypto import secp256k1 as secp

                if peer_version < 3 <= self.version and not self.allow_v2:
                    raise AuthError("v2 hello rejected (downgrade)")
                sig = data[m2 + 80 :]
                body = data[: m2 + 80]
                try:
                    signer = secp.recover_address(keccak256(body), sig)
                except Exception:
                    raise AuthError("bad hello signature")
                if signer != secp.pubkey_to_address(peer_pub):
                    raise AuthError("hello signature/pubkey mismatch")
                self.peer_addr = signer
                try:
                    shared = secp.ecdh_shared(self.keypair[0], peer_pub)
                except ValueError:
                    raise AuthError("bad peer pubkey")
                # mix the network secret in as a domain separator
                self.send_key = keccak256(shared + self.secret
                                          + self.my_nonce + peer_nonce)
                self.recv_key = keccak256(shared + self.secret
                                          + peer_nonce + self.my_nonce)
                if peer_version >= 3 and self.version >= 3:
                    self.send_enc = keccak256(b"enc" + shared + self.secret
                                              + self.my_nonce + peer_nonce)
                    self.recv_enc = keccak256(b"enc" + shared + self.secret
                                              + peer_nonce + self.my_nonce)
                    self.encrypts = True
                return
            # keyless side of a mixed pair: v1 keys from the v2/v3
            # hello's nonce (the keyed peer sees our v1 hello and,
            # when flagged, derives the same)
        elif data.startswith(self.MAGIC) and len(data) == len(self.MAGIC) + 16:
            peer_nonce = data[len(self.MAGIC):]
            if self.keypair is not None:
                if not self.allow_downgrade:
                    raise AuthError("v1 hello rejected (downgrade)")
                # keyed side of a mixed pair: fall back to v1
                self.keypair = None
        else:
            raise AuthError("bad hello")
        self.send_key = keccak256(self.secret + self.my_nonce + peer_nonce)
        self.recv_key = keccak256(self.secret + peer_nonce + self.my_nonce)

    def seal(self, payload: bytes) -> bytes:
        from eges_tpu_torch.crypto.keccak import keccak256

        if self.encrypts:
            payload = _xor(payload, _keystream(self.send_enc,
                                               self.send_seq, len(payload)))
        mac = keccak256(self.send_key + self.send_seq.to_bytes(8, "big")
                        + payload)[:16]
        self.send_seq += 1
        return mac + payload

    def open(self, frame: bytes) -> bytes:
        import hmac as _hmac

        from eges_tpu_torch.crypto.keccak import keccak256

        if len(frame) < 16:
            raise AuthError("short frame")
        mac, payload = frame[:16], frame[16:]
        want = keccak256(self.recv_key + self.recv_seq.to_bytes(8, "big")
                        + payload)[:16]
        if not _hmac.compare_digest(mac, want):  # constant-time compare
            raise AuthError("bad frame MAC")
        if self.encrypts:
            payload = _xor(payload, _keystream(self.recv_enc,
                                               self.recv_seq, len(payload)))
        self.recv_seq += 1
        return payload


class Protocol:
    """A named message-code space on the gossip plane (the p2p.Protocol
    / eth ProtocolManager role, ref: p2p/peer.go matchProtocols,
    eth/protocol.go:38-44 eth/62+63).

    ``versions`` is the full list this endpoint can speak; capability
    negotiation picks the highest version both ends offer — exactly how
    eth/62 and eth/63 co-exist in the reference.  ``codes`` is the set
    of frame codes the protocol owns; the mux refuses codes outside
    every negotiated protocol and scores the sender (ref: p2p/peer.go
    handle → DiscProtocolError)."""

    def __init__(self, name: str, versions: tuple[int, ...],
                 codes: frozenset[int] | set[int], handler):
        self.name = name
        self.versions = tuple(sorted(versions))
        self.codes = frozenset(codes)
        self.handler = handler


CAPS_MAGIC = b"geec-caps\x00"


def encode_caps(protocols: list[Protocol]) -> bytes:
    from eges_tpu_torch.core import rlp

    return CAPS_MAGIC + rlp.encode(
        [[p.name.encode(), list(p.versions)] for p in protocols])


def decode_caps(data: bytes) -> dict[str, tuple[int, ...]]:
    from eges_tpu_torch.core import rlp

    out: dict[str, tuple[int, ...]] = {}
    for entry in rlp.decode(data[len(CAPS_MAGIC):]):
        name = bytes(entry[0]).decode()
        out[name] = tuple(rlp.decode_uint(bytes(v)) for v in entry[1])
    return out


def shared_caps(mine: list[Protocol],
                theirs: dict[str, tuple[int, ...]]) -> dict[str, int]:
    """Highest mutually-offered version per protocol name."""
    shared: dict[str, int] = {}
    for p in mine:
        common = set(p.versions) & set(theirs.get(p.name, ()))
        if common:
            shared[p.name] = max(common)
    return shared


class _Session:
    """Per-connection state: auth layer, negotiated capabilities, and
    the misbehavior score (ref: p2p/peer.go per-peer protocol state)."""

    __slots__ = ("writer", "auth", "shared", "score", "dropped", "born")

    def __init__(self, writer, auth):
        self.writer = writer
        self.auth = auth
        self.shared: dict[str, int] | None = None  # None until caps
        #                                            frame (legacy peer:
        #                                            never arrives)
        self.score = 0
        self.dropped = False
        self.born = time.monotonic()


class GossipPlane:
    """Static-peer-list TCP gossip with 4-byte length-prefixed frames.

    Reconnects with backoff; sends are fire-and-forget like the
    reference's per-peer ``p2p.Send`` loops (eth/handler.go:1071-1080).
    With ``secret`` set, every connection runs the :class:`_FrameAuth`
    handshake — encrypted + MACed frames when keyed (the p2p/rlpx.go
    role, v3) — while ``secret=None`` keeps the plaintext wire for
    tests/local rigs.  ``version=2`` pins a keyed plane to the MAC-only
    generation (mixed-mode upgrades; pair with ``allow_v2_peers`` on
    the v3 side).

    With ``protocols`` set the plane runs the devp2p protocol-mux role:
    right after the transport handshake each side sends a capability
    frame listing its protocols' offered versions; frames then route by
    code to the owning protocol's handler, frames for un-negotiated or
    unknown codes raise the connection's misbehavior score, and a peer
    crossing :data:`MISBEHAVIOR_LIMIT` is disconnected (the reference's
    DiscProtocolError path).  Cap-less legacy peers interop: they are
    muxed against the full registered code set.
    """

    MAX_FRAME = 64 * 1024 * 1024
    MISBEHAVIOR_LIMIT = 100   # four strikes: protocol violations are
    #                           either a broken build or an attack, but
    #                           a one-off corrupt relay shouldn't sever

    def __init__(self, bind_ip: str, bind_port: int, peers: list[tuple[str, int]],
                 on_gossip, secret: bytes | None = None,
                 keypair: tuple[bytes, bytes] | None = None,
                 authorize=None, allow_v1_peers: bool = False,
                 allow_v2_peers: bool = False, version: int = 3,
                 protocols: list[Protocol] | None = None):
        self.bind_ip = bind_ip
        self.bind_port = bind_port
        self.peers = [p for p in peers if p != (bind_ip, bind_port)]
        self._on_gossip = on_gossip
        self.secret = secret
        self.keypair = keypair if secret is not None else None
        self.authorize = authorize  # callable(addr20) -> bool, v2+ only
        self.allow_v1_peers = allow_v1_peers  # mixed-mode upgrades only
        self.allow_v2_peers = allow_v2_peers  # accept MAC-only peers
        self.version = version
        self.protocols = protocols
        self._code_to_proto: dict[int, Protocol] = {}
        for p in protocols or []:
            for c in p.codes:
                if c in self._code_to_proto:
                    raise ValueError("code %#x claimed twice" % c)
                self._code_to_proto[c] = p
        self._server: asyncio.AbstractServer | None = None
        self._writers: dict[tuple[str, int], _Session] = {}
        self._tasks: list[asyncio.Task] = []
        self._closed = False
        # dial + accept coroutines both bump this, but all of them run
        # on the plane's single asyncio loop — never concurrently
        self.auth_failures = 0  # guarded-by: event-loop
        self.peer_drops = 0       # misbehavior disconnects
        self._peer_gauge()  # register net.peer_count at 0

    def _peer_gauge(self) -> None:
        from eges_tpu_torch.utils import metrics

        metrics.DEFAULT.gauge("net.peer_count").set(len(self._writers))

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._handle_conn, self.bind_ip, self.bind_port)
        for peer in self.peers:
            self._tasks.append(asyncio.create_task(self._dial_loop(peer)))

    def add_peer(self, peer: tuple[str, int]) -> None:
        """Dial a newly-discovered peer (the discovery plane feeds this);
        no-op for self or already-known peers."""
        if self._closed or peer == (self.bind_ip, self.bind_port):
            return
        if peer in self.peers:
            return
        self.peers.append(peer)
        # prune finished dial loops so re-homing churn (remove_peer /
        # add_peer cycles from discovery records) can't grow the task
        # list without bound over a long-lived node
        self._tasks = [t for t in self._tasks if not t.done()]
        self._tasks.append(asyncio.create_task(self._dial_loop(peer)))

    def remove_peer(self, peer: tuple[str, int]) -> None:
        """Stop dialing an endpoint a peer no longer lives at (a
        higher-seq discovery record re-homed it); closes any live
        connection so the dial loop winds down instead of redialing a
        dead address forever."""
        if peer not in self.peers:
            return
        self.peers.remove(peer)
        sess = self._writers.pop(peer, None)
        self._peer_gauge()
        if sess is not None:
            try:
                sess.writer.close()
            # analysis: allow-swallow(best-effort close of a possibly dead writer)
            except Exception:
                pass

    @staticmethod
    async def _read_frame(reader) -> bytes:
        hdr = await reader.readexactly(4)
        (n,) = struct.unpack("<I", hdr)
        if n > GossipPlane.MAX_FRAME:
            raise AuthError("oversized frame")
        return await reader.readexactly(n)

    @staticmethod
    def _frame(data: bytes) -> bytes:
        return struct.pack("<I", len(data)) + data

    async def _handshake(self, reader, writer) -> _Session:
        """Transport handshake + capability announcement; returns the
        connection's session (auth is None in plaintext mode)."""
        auth = None
        if self.secret is not None:
            auth = _FrameAuth(self.secret, keypair=self.keypair,
                              allow_downgrade=self.allow_v1_peers,
                              allow_v2=self.allow_v2_peers,
                              version=self.version)
            writer.write(self._frame(auth.hello()))
            await writer.drain()
            auth.on_hello(await asyncio.wait_for(self._read_frame(reader),
                                                 timeout=5.0))
            if (auth.peer_addr is not None and self.authorize is not None
                    and not self.authorize(auth.peer_addr)):
                raise AuthError("peer not authorized")
        sess = _Session(writer, auth)
        if self.protocols is not None:
            # first frame each way is the capability list (the devp2p
            # protocol handshake, ref: p2p/peer.go Hello/matchProtocols)
            caps = encode_caps(self.protocols)
            writer.write(self._frame(
                auth.seal(caps) if auth is not None else caps))
        return sess

    def _misbehave(self, sess: _Session, points: int) -> None:
        sess.score += points
        if sess.score >= self.MISBEHAVIOR_LIMIT and not sess.dropped:
            sess.dropped = True        # count ONE drop per connection,
            self.peer_drops += 1       # and stop dispatching its
            try:                       # already-buffered frames
                sess.writer.close()
            # analysis: allow-swallow(best-effort close of a misbehaving peer)
            except Exception:
                pass

    def _dispatch(self, sess: _Session, data: bytes) -> None:
        """Route one opened frame: caps handshake, then per-code mux."""
        if sess.dropped:
            return  # connection is being cut; drain without dispatching
        if data.startswith(CAPS_MAGIC):
            try:
                sess.shared = shared_caps(self.protocols or [],
                                          decode_caps(data))
            except Exception:
                self._misbehave(sess, 25)
            return
        if self.protocols is None:
            try:
                self._on_gossip(data)
            except Exception as exc:
                log.gdbug("gossip handler error", err=repr(exc))
            return
        from eges_tpu_torch.core import rlp
        from eges_tpu_torch.utils import tracing

        # peek past a possible trace header; handlers strip it themselves
        proto = self._code_to_proto.get(
            rlp.peek_first_uint(tracing.payload_of(data)))
        if proto is None:
            # a code outside every protocol we registered: out of
            # contract, score it (ref: p2p/peer.go invalid msg code)
            self._misbehave(sess, 25)
            return
        if sess.shared is not None and proto.name not in sess.shared:
            # a protocol WE speak but this pair didn't negotiate.  The
            # sender may legitimately not have our caps yet (its burst
            # can be in flight before our caps frame crosses), so this
            # is dropped, never scored — the negotiation race must not
            # cut honest mixed-version peers.
            return
        try:
            proto.handler(data)
        except Exception as exc:
            log.gdbug("protocol handler error", proto=proto.name,
                      err=repr(exc))

    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        try:
            sess = await self._handshake(reader, writer)
            while True:
                frame = await self._read_frame(reader)
                if sess.auth is not None:
                    frame = sess.auth.open(frame)
                self._dispatch(sess, frame)
        except (asyncio.IncompleteReadError, ConnectionError,
                asyncio.TimeoutError):
            pass
        except AuthError:
            self.auth_failures += 1
        finally:
            writer.close()

    AUTH_RETRY_S = 60.0  # gate-rejected peers re-dial slowly: the
    #                      membership gate may admit them once they
    #                      register, but each attempt costs a full
    #                      ECDSA+ECDH handshake — not a transient error.
    #                      Two shapes of rejection: our own gate raises
    #                      AuthError (rejected below), and the REMOTE
    #                      gate just closes right after the handshake —
    #                      the dialer can't see why, so repeated
    #                      instant-closes escalate to the same slow
    #                      cadence.  Connection-refused (peer not up
    #                      yet: late joiners, restarts) never counts.

    async def _dial_loop(self, peer: tuple[str, int]) -> None:
        backoff = 0.2
        quick_closes = 0
        while not self._closed and peer in self.peers:
            rejected = False
            held = None
            try:
                reader, writer = await asyncio.open_connection(*peer)
                try:
                    sess = await self._handshake(reader, writer)
                except AuthError:
                    self.auth_failures += 1
                    rejected = True
                    raise ConnectionError
                self._writers[peer] = sess
                self._peer_gauge()
                t0 = time.monotonic()
                try:
                    # hold the connection, reading the acceptor's side
                    # of the stream: its capability frame arrives here
                    # (writer errors still surface on send).  The
                    # timeout wraps ONLY the 4-byte header read —
                    # readexactly is buffer-atomic, so a timed-out
                    # header consumes nothing, while a timeout spanning
                    # header+body could cancel between them and
                    # permanently desync the framing.  Once a header
                    # is committed the body read runs untimed; a stall
                    # mid-frame ends via remove_peer/close() closing
                    # the transport under it.
                    while not writer.is_closing() and not self._closed \
                            and peer in self.peers:
                        try:
                            hdr = await asyncio.wait_for(
                                reader.readexactly(4), timeout=0.5)
                        except asyncio.TimeoutError:
                            continue
                        (n,) = struct.unpack("<I", hdr)
                        if n > self.MAX_FRAME:
                            raise AuthError("oversized frame")
                        frame = await reader.readexactly(n)
                        if sess.auth is not None:
                            frame = sess.auth.open(frame)
                        self._dispatch(sess, frame)
                except (asyncio.IncompleteReadError, AuthError):
                    pass  # remote closed or broke framing: reconnect
                finally:
                    held = time.monotonic() - t0
            except (ConnectionError, OSError, asyncio.TimeoutError):
                pass
            self._writers.pop(peer, None)
            self._peer_gauge()
            if held is not None and held >= 2.0:
                backoff, quick_closes = 0.2, 0  # was a real connection
            elif held is not None:
                quick_closes += 1
            await asyncio.sleep(
                self.AUTH_RETRY_S if rejected or quick_closes >= 3
                else backoff)
            backoff = min(backoff * 2, 5.0)

    CAPS_GRACE_S = 1.0  # how long a fresh session may lack the peer's
    #                     caps frame before we treat it as legacy.  In
    #                     devp2p no protocol msg flows before the Hello
    #                     exchange completes; holding broadcasts for
    #                     this window is the same ordering, and keeps a
    #                     mixed-version peer from scoring our burst as
    #                     misbehavior before it could tell us its caps.

    def broadcast(self, data: bytes) -> None:
        proto = None
        if self.protocols is not None:
            from eges_tpu_torch.core import rlp
            from eges_tpu_torch.utils import tracing

            proto = self._code_to_proto.get(
                rlp.peek_first_uint(tracing.payload_of(data)))
        now = time.monotonic()
        for peer, sess in list(self._writers.items()):
            if proto is not None and sess.shared is None \
                    and now - sess.born < self.CAPS_GRACE_S:
                continue  # caps still in flight; gossip retries cover it
            if (proto is not None and sess.shared is not None
                    and proto.name not in sess.shared):
                continue  # peer never negotiated this protocol — the
                #           reference sends eth msgs only to eth peers
            try:
                payload = (sess.auth.seal(data)
                           if sess.auth is not None else data)
                sess.writer.write(self._frame(payload))
            except Exception:
                self._writers.pop(peer, None)
                self._peer_gauge()

    def close(self) -> None:
        self._closed = True
        for t in self._tasks:
            t.cancel()
        for sess in self._writers.values():
            sess.writer.close()
        if self._server is not None:
            self._server.close()


class SocketTransport:
    """The Transport interface GeecNode expects, over the two planes."""

    def __init__(self, gossip: GossipPlane, direct: DirectPlane):
        self._gossip = gossip
        self._direct = direct

    def gossip(self, data: bytes) -> None:
        from eges_tpu_torch.utils import tracing
        from eges_tpu_torch.utils.metrics import DEFAULT as metrics
        data = tracing.inject_current(data)
        metrics.counter("net.gossip_bytes").inc(len(data))
        metrics.counter("net.gossip_msgs").inc()
        self._gossip.broadcast(data)

    def send_direct(self, ip: str, port: int, data: bytes) -> None:
        from eges_tpu_torch.utils import tracing
        from eges_tpu_torch.utils.metrics import DEFAULT as metrics
        data = tracing.inject_current(data)
        metrics.counter("net.direct_bytes").inc(len(data))
        metrics.counter("net.direct_msgs").inc()
        self._direct.send(ip, port, data)


class GeecTxnService:
    """UDP transaction-ingest API: every datagram on ``--geecTxnPort``
    becomes an unsigned Geec transaction (ref: consensus/geec/geec_api.go:11)."""

    def __init__(self, bind_ip: str, port: int, on_txn_payload):
        self.bind_ip = bind_ip
        self.port = port
        self._on_txn = on_txn_payload
        self._transport = None

    async def start(self) -> None:
        loop = asyncio.get_running_loop()
        self._transport, _ = await loop.create_datagram_endpoint(
            lambda: _UdpProtocol(self._on_txn),
            local_addr=(self.bind_ip, self.port))

    def close(self) -> None:
        if self._transport is not None:
            self._transport.close()
