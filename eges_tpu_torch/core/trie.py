"""Merkle-Patricia trie: root hashing and key/value proofs-of-inclusion.

The port's copy of ``eges_tpu/core/trie.py``, over the port's Keccak.

Fills the role of the reference's ``trie/`` package for the paths the
consensus capability set needs: ``DeriveSha`` over transactions/receipts
(ref: core/types/derive_sha.go) and a generic secure-keyed KV trie for
state roots (ref: trie/trie.go, trie/secure_trie.go).  This is a batch
constructor — it materialises the node structure for a key set and folds it
into the keccak root — rather than a journaled incremental trie; the
chain layer rebuilds roots per block, which at Geec's 1000-txn operating
point is microseconds of host work and keeps the structure immutable
(functional style, no in-place node mutation).
"""

from __future__ import annotations

from eges_tpu_torch.core import rlp
from eges_tpu_torch.crypto.keccak import keccak256

EMPTY_ROOT = bytes.fromhex(
    "56e81f171bcc55a6ff8345e692c0f86e5b48e01b996cadc001622fb5e363b421"
)  # keccak256(rlp(b''))


def _nibbles(key: bytes) -> list[int]:
    out = []
    for b in key:
        out.append(b >> 4)
        out.append(b & 0xF)
    return out


def _hp_encode(nibbles: list[int], terminal: bool) -> bytes:
    """Hex-prefix encoding (ref: trie/encoding.go hexToCompact)."""
    flag = 2 if terminal else 0
    if len(nibbles) % 2:
        head = [flag + 1] + nibbles
    else:
        head = [flag, 0] + nibbles
    return bytes(
        (head[i] << 4) | head[i + 1] for i in range(0, len(head), 2)
    )


def _node_ref(encoded: bytes):
    """Nodes < 32 bytes embed in the parent; otherwise refer by hash."""
    if len(encoded) < 32:
        return rlp.decode(encoded)
    return keccak256(encoded)


def _lcp_below(items, depth: int) -> int:
    """Longest common nibble prefix of ``items`` at/below ``depth``."""
    first = items[0][0]
    lcp = len(first)
    for nib, _ in items[1:]:
        i = depth
        limit = min(len(first), len(nib))
        while i < limit and nib[i] == first[i]:
            i += 1
        lcp = min(lcp, i)
    return lcp


def _build(items: list[tuple[list[int], bytes]], depth: int):
    """Build the node for items sharing a prefix of length ``depth``.

    Returns the RLP *structure* of the node (to be encoded / hashed by
    the caller).  ``items`` must be sorted and have distinct keys.
    """
    if not items:
        return b""
    if len(items) == 1:
        nib, val = items[0]
        return [_hp_encode(nib[depth:], True), val]

    # longest common prefix below depth
    first = items[0][0]
    lcp = _lcp_below(items, depth)
    if lcp > depth:
        child = _build(items, lcp)
        return [_hp_encode(first[depth:lcp], False), _node_ref(rlp.encode(child))]

    # branch node
    children = [b""] * 16
    value = b""
    buckets: dict[int, list] = {}
    for nib, val in items:
        if len(nib) == depth:
            value = val
        else:
            buckets.setdefault(nib[depth], []).append((nib, val))
    for idx, bucket in buckets.items():
        child = _build(bucket, depth + 1)
        children[idx] = _node_ref(rlp.encode(child))
    return children + [value]


def trie_root(pairs: dict[bytes, bytes]) -> bytes:
    """Root hash of the MPT holding ``pairs`` (raw keys)."""
    if not pairs:
        return EMPTY_ROOT
    items = sorted((_nibbles(k), v) for k, v in pairs.items())
    node = _build(items, 0)
    return keccak256(rlp.encode(node))


def secure_trie_root(pairs: dict[bytes, bytes]) -> bytes:
    """Root with keccak-hashed keys (ref: trie/secure_trie.go)."""
    return trie_root({keccak256(k): v for k, v in pairs.items()})


def derive_sha(encoded_items: list[bytes]) -> bytes:
    """Tx/receipt root: trie keyed by rlp(index) (ref: core/types/derive_sha.go:30)."""
    return trie_root({rlp.encode(i): item for i, item in enumerate(encoded_items)})


# ---------------------------------------------------------------------------
# proofs of inclusion / exclusion (ref: trie/proof.go Prove/VerifyProof)
# ---------------------------------------------------------------------------

def _hp_decode(data: bytes) -> tuple[list[int], bool]:
    nibs = _nibbles(data)
    flag = nibs[0]
    terminal = flag >= 2
    skip = 1 if flag % 2 else 2
    return nibs[skip:], terminal


def trie_prove(pairs: dict[bytes, bytes], key: bytes) -> list[bytes]:
    """Merkle proof for ``key`` against ``trie_root(pairs)``: the encoded
    nodes on the key's path that are referenced by hash (embedded short
    nodes travel inside their parent, as in the reference's proof lists).
    Valid for absent keys too (an exclusion proof)."""
    if not pairs:
        return []
    nib = _nibbles(key)
    items = sorted((_nibbles(k), v) for k, v in pairs.items())
    depth = 0
    proof: list[bytes] = []
    enc = rlp.encode(_build(items, depth))  # root node
    hashed = True  # the root is always by-hash
    while True:
        if hashed:
            proof.append(enc)
        if len(items) == 1:
            return proof
        lcp = _lcp_below(items, depth)
        if lcp > depth:  # extension node
            if nib[depth:lcp] != items[0][0][depth:lcp]:
                return proof  # diverges here: exclusion proven
            depth = lcp
            enc = rlp.encode(_build(items, depth))
            hashed = len(enc) >= 32
            continue
        # branch node
        if len(nib) == depth:
            return proof  # value (or absence) sits in this branch
        bucket = [(n, v) for n, v in items
                  if len(n) > depth and n[depth] == nib[depth]]
        if not bucket:
            return proof  # empty child slot: exclusion proven
        items = bucket
        depth += 1
        enc = rlp.encode(_build(items, depth))
        hashed = len(enc) >= 32


def verify_proof(root: bytes, key: bytes, proof: list[bytes]):
    """Walk ``proof`` from ``root``; returns the proven value, or None
    when the proof shows the key absent.  Raises ValueError on any
    inconsistency (a forged proof)."""
    if root == EMPTY_ROOT:
        if proof:
            raise ValueError("non-empty proof for the empty trie")
        return None
    nib = _nibbles(key)
    it = iter(proof)

    def load(ref):
        if isinstance(ref, (bytes, bytearray)) and len(ref) == 32:
            enc = next(it, None)
            if enc is None:
                raise ValueError("proof truncated")
            if keccak256(enc) != bytes(ref):
                raise ValueError("proof node hash mismatch")
            return rlp.decode(enc)
        return ref  # embedded node (list) or empty slot (b"")

    node = load(root)
    i = 0
    while True:
        if isinstance(node, (bytes, bytearray)):
            if len(node) == 0:
                return None  # empty slot: key absent
            raise ValueError("malformed proof node")
        if len(node) == 17:  # branch
            if i == len(nib):
                val = bytes(node[16])
                return val if val else None
            node = load(node[nib[i]])
            i += 1
            continue
        if len(node) != 2:
            raise ValueError("malformed proof node")
        path, terminal = _hp_decode(bytes(node[0]))
        if terminal:
            return bytes(node[1]) if nib[i:] == path else None
        if nib[i:i + len(path)] != path:
            return None  # extension diverges: key absent
        i += len(path)
        node = load(node[1])


def secure_trie_prove(pairs: dict[bytes, bytes], key: bytes) -> list[bytes]:
    """Proof against :func:`secure_trie_root` (keccak-hashed keys)."""
    return trie_prove({keccak256(k): v for k, v in pairs.items()},
                      keccak256(key))


def verify_secure_proof(root: bytes, key: bytes, proof: list[bytes]):
    return verify_proof(root, keccak256(key), proof)


# ---------------------------------------------------------------------------
# persistent incremental trie (ref: trie/trie.go insert/delete — redesigned
# as an immutable structure-sharing tree instead of geth's mutable nodes +
# journal, so every chain snapshot holds a root pointer and per-block cost
# is O(dirty keys x depth), round-2 verdict item 10)
# ---------------------------------------------------------------------------

class _Leaf:
    __slots__ = ("path", "value", "_enc")

    def __init__(self, path: tuple[int, ...], value: bytes):
        self.path = path
        self.value = value
        self._enc = None


class _Ext:
    __slots__ = ("path", "child", "_enc")

    def __init__(self, path: tuple[int, ...], child):
        self.path = path
        self.child = child
        self._enc = None


class _Branch:
    __slots__ = ("children", "value", "_enc")

    def __init__(self, children: tuple, value: bytes):
        self.children = children  # 16-tuple of nodes | None
        self.value = value
        self._enc = None


def _encode_node(node) -> bytes:
    """RLP encoding of a node, memoized on the (immutable) node object."""
    if node._enc is None:
        if isinstance(node, _Leaf):
            s = [_hp_encode(list(node.path), True), node.value]
        elif isinstance(node, _Ext):
            s = [_hp_encode(list(node.path), False),
                 _node_ref(_encode_node(node.child))]
        else:
            s = [(b"" if c is None else _node_ref(_encode_node(c)))
                 for c in node.children] + [node.value]
        node._enc = rlp.encode(s)
    return node._enc


def _insert(node, nibs: tuple[int, ...], value: bytes):
    """Insert/overwrite; returns the new node (shares unchanged subtrees)."""
    if node is None:
        return _Leaf(nibs, value)
    if isinstance(node, _Leaf):
        if node.path == nibs:
            return _Leaf(nibs, value)
        # branch at the divergence point, extension over the shared
        # prefix (a chain of single-child branches would hash to a
        # non-canonical root)
        n = _common_len(node.path, nibs)
        children: list = [None] * 16
        bval = b""
        for path, val in ((node.path, node.value), (nibs, value)):
            if len(path) == n:
                bval = val
            else:
                children[path[n]] = _Leaf(path[n + 1:], val)
        return _make_ext(node.path[:n], _Branch(tuple(children), bval))
    if isinstance(node, _Ext):
        p = node.path
        n = _common_len(p, nibs)
        if n == len(p):
            return _make_ext(p, _insert(node.child, nibs[n:], value))
        # split the extension at n
        below = node.child if len(p) == n + 1 else _Ext(p[n + 1:], node.child)
        children: list = [None] * 16
        children[p[n]] = below
        branch = _Branch(tuple(children), b"")
        branch = _insert(branch, nibs[n:], value)
        return _make_ext(p[:n], branch) if n else branch
    # branch
    if not nibs:
        return _Branch(node.children, value)
    i = nibs[0]
    new_child = _insert(node.children[i], nibs[1:], value)
    ch = list(node.children)
    ch[i] = new_child
    return _Branch(tuple(ch), node.value)


def _common_len(a, b) -> int:
    n = 0
    m = min(len(a), len(b))
    while n < m and a[n] == b[n]:
        n += 1
    return n


def _make_ext(path: tuple[int, ...], child):
    """Extension constructor that collapses degenerate shapes."""
    if not path:
        return child
    if isinstance(child, _Ext):
        return _Ext(path + child.path, child.child)
    if isinstance(child, _Leaf):
        return _Leaf(path + child.path, child.value)
    return _Ext(path, child)


def _delete(node, nibs: tuple[int, ...]):
    """Delete; returns the new node or None.  Missing keys are a no-op."""
    if node is None:
        return None
    if isinstance(node, _Leaf):
        return None if node.path == nibs else node
    if isinstance(node, _Ext):
        n = _common_len(node.path, nibs)
        if n != len(node.path):
            return node  # key not present
        child = _delete(node.child, nibs[n:])
        if child is node.child:
            return node
        if child is None:
            return None
        return _make_ext(node.path, child)
    # branch
    if not nibs:
        if not node.value:
            return node
        new = _Branch(node.children, b"")
    else:
        i = nibs[0]
        child = _delete(node.children[i], nibs[1:])
        if child is node.children[i]:
            return node
        ch = list(node.children)
        ch[i] = child
        new = _Branch(tuple(ch), node.value)
    # collapse if degenerate
    live = [(i, c) for i, c in enumerate(new.children) if c is not None]
    if new.value and not live:
        return _Leaf((), new.value)
    if not new.value and len(live) == 1:
        i, c = live[0]
        return _make_ext((i,), c)
    if not new.value and not live:
        return None
    return new


def _get(node, nibs: tuple[int, ...]):
    while node is not None:
        if isinstance(node, _Leaf):
            return node.value if node.path == nibs else None
        if isinstance(node, _Ext):
            n = _common_len(node.path, nibs)
            if n != len(node.path):
                return None
            node, nibs = node.child, nibs[n:]
            continue
        if not nibs:
            return node.value or None
        node, nibs = node.children[nibs[0]], nibs[1:]
    return None


class IncrementalTrie:
    """Immutable MPT handle: ``update``/``delete`` return NEW handles that
    share structure with the old one, so chain snapshots are cheap and a
    block's root costs O(dirty keys x depth) rehashing (node encodings
    memoize on the shared immutable nodes)."""

    __slots__ = ("_root",)

    def __init__(self, _root=None):
        self._root = _root

    @classmethod
    def from_pairs(cls, pairs: dict[bytes, bytes]) -> "IncrementalTrie":
        t = cls()
        for k, v in pairs.items():
            t = t.update(k, v)
        return t

    def update(self, key: bytes, value: bytes) -> "IncrementalTrie":
        if not value:
            return self.delete(key)
        return IncrementalTrie(
            _insert(self._root, tuple(_nibbles(key)), value))

    def delete(self, key: bytes) -> "IncrementalTrie":
        return IncrementalTrie(_delete(self._root, tuple(_nibbles(key))))

    def get(self, key: bytes):
        return _get(self._root, tuple(_nibbles(key)))

    def items(self):
        """Yield ``(key, value)`` over every leaf, keys re-packed from
        nibble paths.  This is the state-sync SERVING walk (ref role:
        trie.Iterator in eth/downloader/statesync.go's source side); on
        a secure trie the keys that come back are the hashed ones."""
        def walk(node, path):
            if node is None:
                return
            if isinstance(node, _Leaf):
                yield path + node.path, node.value
            elif isinstance(node, _Ext):
                yield from walk(node.child, path + node.path)
            else:  # _Branch
                if node.value:
                    yield path, node.value
                for i, ch in enumerate(node.children):
                    if ch is not None:
                        yield from walk(ch, path + (i,))
        for nibs, val in walk(self._root, ()):
            yield (bytes((nibs[i] << 4) | nibs[i + 1]
                         for i in range(0, len(nibs), 2)), val)

    def root(self) -> bytes:
        if self._root is None:
            return EMPTY_ROOT
        return keccak256(_encode_node(self._root))


class SecureIncrementalTrie:
    """Secure-keyed wrapper (keys pre-hashed, ref: trie/secure_trie.go)."""

    __slots__ = ("_t",)

    def __init__(self, _t: IncrementalTrie | None = None):
        self._t = _t if _t is not None else IncrementalTrie()

    def update(self, key: bytes, value: bytes) -> "SecureIncrementalTrie":
        return SecureIncrementalTrie(self._t.update(keccak256(key), value))

    def delete(self, key: bytes) -> "SecureIncrementalTrie":
        return SecureIncrementalTrie(self._t.delete(keccak256(key)))

    def get(self, key: bytes):
        return self._t.get(keccak256(key))

    def items(self):
        """(hashed_key, value) pairs — see IncrementalTrie.items."""
        return self._t.items()

    @classmethod
    def from_hashed_pairs(cls, pairs) -> "SecureIncrementalTrie":
        """Rebuild from ``(hashed_key, value)`` pairs as served by
        ``items()`` — the state-sync RECEIVING side.  The caller proves
        integrity by comparing ``root()`` against a certified
        commitment; nothing here trusts the pairs."""
        return cls(IncrementalTrie.from_pairs(dict(pairs)))

    def root(self) -> bytes:
        return self._t.root()
