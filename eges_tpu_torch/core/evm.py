"""EVM subset: contract create/call with gas metering and precompiles.

The port's copy of ``eges_tpu/core/evm.py``: in-contract recovery rides
the port's verifier; the pairing precompiles use the port's ``bn254``.

Fills the ``core/vm`` role for the capability set (ref: core/vm/evm.go,
core/vm/interpreter.go, core/vm/contracts.go, core/vm/gas_table.go).
This is a deliberate subset, not a consensus-grade mainnet EVM: the
homestead-era opcode set the reference's chain config enables, a
simplified-but-deterministic gas schedule (constants below; identical on
every node, which is what consensus needs), and the four classic
precompiles — with **ecrecover routed through the batch verifier** when
one is attached, so even in-contract signature checks ride the TPU path
(SURVEY §3.5's hot loop).

Design choices vs the reference:

* Frames run on a :class:`~eges_tpu_torch.core.state.StateDB` overlay copy and
  either ``absorb`` (success) or drop (revert) — replacing geth's
  journal/revert machinery (core/state/journal.go) with the snapshot
  structure the chain layer already has.
* Storage writes accumulate in a per-frame cache and flush as one merge
  per touched account (``set_storage_many``), so SSTORE in a loop is
  O(1) amortized instead of O(account storage).
* The interpreter is a GENERATOR driven by an explicit frame trampoline
  (``_drive``): a CALL/CREATE opcode *yields* a sub-call request instead
  of recursing, so Python stack depth stays O(1) at any EVM depth — the
  full ``params.CallCreateDepth = 1024`` of the reference
  (core/vm/evm.go:44) with no ``setrecursionlimit`` hack and no
  interpreter-crash class (r5 verdict item 6).
* Byzantium-rule gas refund counter: 15 000 per SSTORE nonzero->zero
  (ref: core/vm/gas_table.go:117 gasSStore pre-Constantinople) and
  24 000 per first SELFDESTRUCT of an address (params.SuicideRefundGas),
  rolled back frame-wise on revert like the reference's journal; the
  txn-level cap of gas_used/2 is applied in
  :func:`eges_tpu_torch.core.state.apply_txn` (core/state_transition.go
  refundGas).  No access lists (post-Berlin; out of the reference's
  chain-config scope).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field

from eges_tpu_torch.core.state import StateError
from eges_tpu_torch.crypto.keccak import keccak256

U256 = 1 << 256
MAXU = U256 - 1
STACK_LIMIT = 1024
CALL_DEPTH_LIMIT = 1024  # params.CallCreateDepth (core/vm/evm.go:44)


class EvmError(Exception):
    """Frame-aborting failure: out of gas, bad jump, stack violation…
    Consumes all gas passed to the frame (ref: vm.ErrOutOfGas class)."""


class Revert(Exception):
    def __init__(self, data: bytes):
        self.data = data


# -- gas schedule (simplified; ref role: core/vm/gas_table.go) -------------
G_ZERO_BYTE = 4
G_NONZERO_BYTE = 68
G_TX = 21_000
G_TX_CREATE = 53_000
G_BASE = 2
G_VERYLOW = 3
G_LOW = 5
G_MID = 8
G_HIGH = 10
G_EXP = 10
G_EXP_BYTE = 50
G_SHA3 = 30
G_SHA3_WORD = 6
G_COPY_WORD = 3
G_BALANCE = 400
G_SLOAD = 200
G_SSTORE_SET = 20_000
G_SSTORE_RESET = 5_000
G_JUMPDEST = 1
G_LOG = 375
G_LOG_TOPIC = 375
G_LOG_BYTE = 8
G_CREATE = 32_000
G_CALL = 700
G_CALL_VALUE = 9_000
G_CALL_STIPEND = 2_300
G_NEW_ACCOUNT = 25_000
G_CODE_DEPOSIT_BYTE = 200
G_MEMORY_WORD = 3
G_EXTCODE = 700
G_SELF_DESTRUCT = 5_000
# refunds (ref: params/protocol_params.go SstoreRefundGas /
# SuicideRefundGas; accounting in core/vm/gas_table.go:117)
R_SCLEAR = 15_000
R_SELFDESTRUCT = 24_000


@dataclass
class BlockCtx:
    """Execution environment of the enclosing block (ref: vm.Context)."""

    coinbase: bytes = bytes(20)
    number: int = 0
    time: int = 0
    difficulty: int = 1
    gas_limit: int = 30_000_000
    blockhash: object = None  # callable number -> 32 bytes, or None


@dataclass
class ExecResult:
    success: bool
    gas_used: int
    output: bytes = b""
    logs: tuple = ()
    created: bytes | None = None
    reverted: bool = False  # REVERT opcode vs any other failure — the
    #                         tracers report the two differently, as the
    #                         reference does (vm.ErrExecutionReverted)


@dataclass
class _Frame:
    code: bytes
    addr: bytes            # executing account (storage context)
    caller: bytes
    origin: bytes
    value: int
    data: bytes
    gas: int
    static: bool
    stack: list = field(default_factory=list)
    mem: bytearray = field(default_factory=bytearray)
    pc: int = 0
    ret: bytes = b""       # last sub-call return data
    swrites: dict = field(default_factory=dict)  # slot -> value cache


@dataclass
class _Task:
    """One live frame on the trampoline's explicit stack: the suspended
    interpreter generator plus everything needed to commit or roll back
    when it finishes (the per-frame half of geth's journal)."""

    kind: str              # "call" | "codecall" | "create"
    gen: object            # suspended _run generator
    frame: _Frame
    depth: int
    snapshot: object       # parent state: absorb target / restore point
    frame_state: object    # overlay this frame runs on
    log_mark: int
    refund_mark: int
    suicide_mark: frozenset
    gas: int               # gas handed to the frame
    to: bytes              # account that receives the storage write-set
    new_addr: bytes | None = None


def _words(n: int) -> int:
    return (n + 31) // 32


def _mem_gas(words: int) -> int:
    return G_MEMORY_WORD * words + (words * words) // 512


def _sha256(d: bytes) -> bytes:
    return hashlib.sha256(d).digest()


def _ripemd160(d: bytes) -> bytes:
    try:
        h = hashlib.new("ripemd160", d).digest()
    except Exception:  # openssl without legacy digests
        raise EvmError("ripemd160 unavailable")
    return bytes(12) + h


class EVM:
    """One instance per transaction execution (ref: vm.NewEVM)."""

    def __init__(self, state, ctx: BlockCtx, *, verifier=None, tracer=None):
        self.state = state        # the txn-level StateDB overlay
        self.ctx = ctx
        self.verifier = verifier
        self.logs: list = []
        # per-opcode hook (ref: vm.Config.Tracer -> interpreter.Run's
        # CaptureState) — see eges_tpu_torch.core.tracer.StructLogTracer
        self.tracer = tracer
        # Byzantium refund counter + self-destruct set (ref:
        # state.GetRefund / HasSuicided); both roll back frame-wise on
        # revert via the per-task marks, like the reference's journal
        self.refund = 0
        self.suicides: set[bytes] = set()

    # -- precompiles (ref: core/vm/contracts.go) ------------------------

    def _precompile(self, addr_int: int, data: bytes, gas: int):
        if addr_int == 1:
            cost = 3000
            if gas < cost:
                raise EvmError("oog:precompile")
            out = self._ecrecover(data)
            return out, gas - cost
        if addr_int == 2:
            cost = 60 + 12 * _words(len(data))
            if gas < cost:
                raise EvmError("oog:precompile")
            return _sha256(data), gas - cost
        if addr_int == 3:
            cost = 600 + 120 * _words(len(data))
            if gas < cost:
                raise EvmError("oog:precompile")
            return _ripemd160(data), gas - cost
        if addr_int == 4:
            cost = 15 + 3 * _words(len(data))
            if gas < cost:
                raise EvmError("oog:precompile")
            return data, gas - cost
        if addr_int == 5:
            return self._modexp(data, gas)
        if addr_int in (6, 7, 8):
            return self._bn256(addr_int, data, gas)
        return None

    @staticmethod
    def _modexp(data: bytes, gas: int):
        """0x05 bigModExp (EIP-198; ref: core/vm/contracts.go bigModExp)."""
        d = data.ljust(96, b"\0")
        bl = int.from_bytes(d[:32], "big")
        el = int.from_bytes(d[32:64], "big")
        ml = int.from_bytes(d[64:96], "big")
        if max(bl, el, ml) > 1 << 20:  # 1 MiB operand cap
            raise EvmError("modexp: operand too large")
        body = data[96:].ljust(bl + el + ml, b"\0")
        base = int.from_bytes(body[:bl], "big")
        exp = int.from_bytes(body[bl : bl + el], "big")
        mod = int.from_bytes(body[bl + el : bl + el + ml], "big")
        # EIP-198 gas: mult_complexity(max(bl, ml)) * max(adj_exp_len, 1) / 20
        w = max(bl, ml)
        if w <= 64:
            mult = w * w
        elif w <= 1024:
            mult = w * w // 4 + 96 * w - 3072
        else:
            mult = w * w // 16 + 480 * w - 199_680
        if el <= 32:
            adj = max(exp.bit_length() - 1, 0)
        else:
            head = int.from_bytes(body[bl : bl + 32], "big")
            adj = 8 * (el - 32) + max(head.bit_length() - 1, 0)
        cost = max(mult * max(adj, 1) // 20, 200)
        if gas < cost:
            raise EvmError("oog:precompile")
        out = (b"" if ml == 0
               else (0 if mod == 0 else pow(base, exp, mod)
                     ).to_bytes(ml, "big"))
        return out, gas - cost

    # -- alt_bn128 precompiles (EIP-196/197; ref: core/vm/contracts.go
    # bn256Add/bn256ScalarMul/bn256Pairing over crypto/bn256) ------------

    @staticmethod
    def _bn_g1(data: bytes):
        from eges_tpu_torch.crypto import bn254 as bn

        x = int.from_bytes(data[:32], "big")
        y = int.from_bytes(data[32:64], "big")
        if x == 0 and y == 0:
            return None
        pt = (x, y)
        if not bn.g1_is_on_curve(pt):
            raise EvmError("bn256: point not on curve")
        return pt

    @staticmethod
    def _bn_g2(data: bytes):
        from eges_tpu_torch.crypto import bn254 as bn

        # EIP-197 encodes F_p2 elements imaginary-part first
        xi = int.from_bytes(data[:32], "big")
        xr = int.from_bytes(data[32:64], "big")
        yi = int.from_bytes(data[64:96], "big")
        yr = int.from_bytes(data[96:128], "big")
        if xi == xr == yi == yr == 0:
            return None
        if max(xi, xr, yi, yr) >= bn.P:
            raise EvmError("bn256: coordinate out of field")
        pt = ((xr, xi), (yr, yi))
        if not bn.g2_in_subgroup(pt):
            raise EvmError("bn256: G2 point not in subgroup")
        return pt

    def _bn256(self, addr_int: int, data: bytes, gas: int):
        from eges_tpu_torch.crypto import bn254 as bn

        if addr_int == 6:  # ECADD
            cost = 500
            if gas < cost:
                raise EvmError("oog:precompile")
            d = data.ljust(128, b"\0")[:128]
            s = bn.g1_add(self._bn_g1(d[:64]), self._bn_g1(d[64:128]))
            out = (bytes(64) if s is None
                   else s[0].to_bytes(32, "big") + s[1].to_bytes(32, "big"))
            return out, gas - cost
        if addr_int == 7:  # ECMUL
            cost = 40_000
            if gas < cost:
                raise EvmError("oog:precompile")
            d = data.ljust(96, b"\0")[:96]
            k = int.from_bytes(d[64:96], "big")
            s = bn.g1_mul(k, self._bn_g1(d[:64]))
            out = (bytes(64) if s is None
                   else s[0].to_bytes(32, "big") + s[1].to_bytes(32, "big"))
            return out, gas - cost
        # ECPAIRING.  Priced WELL above mainnet (100k + 80k/pair): the
        # pairing here is pure Python (~0.1 s/pair incl. the G2 subgroup
        # check), and the gas schedule must make an adversarial
        # pairing-stuffed block expensive enough that the block gas cap
        # bounds validation time (this chain's schedule only needs to be
        # deterministic, not mainnet-equal)
        if len(data) % 192 != 0:
            raise EvmError("bn256: pairing input not a multiple of 192")
        k = len(data) // 192
        cost = 300_000 + 600_000 * k
        if gas < cost:
            raise EvmError("oog:precompile")
        pairs = []
        for i in range(k):
            chunk = data[192 * i : 192 * (i + 1)]
            pairs.append((self._bn_g1(chunk[:64]), self._bn_g2(chunk[64:])))
        ok = bn.pairing_check(pairs)
        return (1 if ok else 0).to_bytes(32, "big"), gas - cost

    def _ecrecover(self, data: bytes) -> bytes:
        """The 0x01 precompile, routed through the device batch verifier
        when attached (a 1-row batch; the pool pads it into a bucket) —
        in-contract signature checks take the same TPU path as txn
        senders (ref: core/vm/contracts.go ecrecover -> crypto.Ecrecover)."""
        d = data.ljust(128, b"\0")[:128]
        h, v, r, s = d[:32], d[32:64], d[64:96], d[96:128]
        if v[:31] != bytes(31) or v[31] not in (27, 28):
            return b""
        sig65 = r + s + bytes([v[31] - 27])
        if self.verifier is not None:
            import numpy as np

            sigs = np.frombuffer(sig65, np.uint8).reshape(1, 65)
            hs = np.frombuffer(h, np.uint8).reshape(1, 32)
            addrs, ok = self.verifier.recover_addresses(sigs, hs)
            if not ok[0]:
                return b""
            return bytes(12) + bytes(addrs[0])
        from eges_tpu_torch.crypto import secp256k1 as host

        try:
            return bytes(12) + host.recover_address(h, sig65)
        except Exception:
            return b""

    # -- entry points ----------------------------------------------------
    #
    # call()/create() build a root request and hand it to the frame
    # trampoline.  All nesting happens on an EXPLICIT task stack — a
    # CALL opcode yields a request instead of recursing, so EVM depth
    # 1024 costs 1024 suspended generators, not 1024 * k Python stack
    # frames (the reference runs frames on goroutine stacks,
    # core/vm/evm.go Call -> interpreter.Run; goroutines grow, CPython
    # frames don't — hence this redesign rather than a recursion bump).

    def call(self, caller: bytes, to: bytes, value: int, data: bytes,
             gas: int, *, depth: int = 0, static: bool = False,
             origin: bytes | None = None) -> ExecResult:
        """Message call against ``to`` (ref: evm.Call, core/vm/evm.go)."""
        origin = origin if origin is not None else caller
        return self._drive(
            "call", (caller, to, value, data, gas, static, origin), depth,
            "CALL")

    def create(self, caller: bytes, value: int, init_code: bytes,
               gas: int, nonce: int, *, depth: int = 0,
               origin: bytes | None = None) -> ExecResult:
        """Contract creation (ref: evm.Create)."""
        origin = origin if origin is not None else caller
        return self._drive(
            "create", (caller, value, init_code, gas, nonce, origin), depth,
            "CREATE")

    # -- frame trampoline -------------------------------------------------

    def _trace_enter(self, kind: str, typ: str, args: tuple,
                     depth: int) -> None:
        """Frame-boundary tracer hook (ref: vm.EVMLogger CaptureEnter) —
        the call-tree tracers (callTracer/prestateTracer/4byteTracer)
        build on these rather than on per-opcode steps."""
        t = self.tracer
        if t is None or not hasattr(t, "on_enter"):
            return
        if kind == "create":
            from eges_tpu_torch.core.state import contract_address

            caller, value, init_code, gas, nonce, _origin = args
            new_addr = contract_address(caller, nonce)
            # context = the address the init code's SSTOREs land on,
            # so prestate attribution is correct for creations too
            t.on_enter(dict(type=typ, frm=caller, to=None,
                            context=new_addr, value=value,
                            input=init_code, gas=gas, depth=depth))
        elif kind == "call":
            caller, to, value, data, gas, _st, _or = args
            t.on_enter(dict(type=typ, frm=caller, to=to, context=to,
                            value=value, input=data, gas=gas, depth=depth))
        else:  # codecall: callee code in the caller's storage context
            code_addr, storage_addr, value, data, gas, caller, _or, \
                _st = args
            t.on_enter(dict(type=typ, frm=caller, to=code_addr,
                            context=storage_addr, value=value, input=data,
                            gas=gas, depth=depth))

    def _trace_exit(self, res: ExecResult, depth: int) -> None:
        t = self.tracer
        if t is not None and hasattr(t, "on_exit"):
            t.on_exit(res, depth)

    def _drive(self, kind: str, args: tuple, depth: int,
               typ: str = "CALL") -> ExecResult:
        """Run the frame machine to completion.

        ``result`` carries a finished child's ExecResult into its
        suspended parent generator; ``None`` starts a fresh one (the
        two cases are exactly ``gen.send``'s contract)."""
        self._trace_enter(kind, typ, args, depth)
        first = self._begin(kind, args, depth)
        if isinstance(first, ExecResult):
            self._trace_exit(first, depth)
            return first
        stack: list[_Task] = [first]
        result = None
        while stack:
            task = stack[-1]
            try:
                req = task.gen.send(result)
                result = None
            except StopIteration as si:
                res = self._finish_ok(
                    task, si.value if si.value is not None else b"")
            except Revert as r:
                res = self._finish_revert(task, r)
            except (EvmError, StateError) as e:
                res = self._finish_err(task, e)
            else:
                self._trace_enter(req[0], req[2], req[1], task.depth + 1)
                sub = self._begin(req[0], req[1], task.depth + 1)
                if isinstance(sub, ExecResult):
                    self._trace_exit(sub, task.depth + 1)
                    result = sub       # fast path: deliver immediately
                else:
                    stack.append(sub)  # result stays None: start child
                continue
            stack.pop()
            self._trace_exit(res, task.depth)
            result = res
        return result

    def _begin(self, kind: str, args: tuple, depth: int):
        """Entry checks + frame setup for one call/create/codecall.

        Returns an ExecResult for the fast/failure paths (depth, balance,
        precompiles, empty code) or a :class:`_Task` to push.  Mirrors
        evm.Call / evm.CallCode / evm.DelegateCall / evm.Create.  Depth
        and balance failures RETURN the gas (gas_used = 0), per the
        reference's ErrDepth/ErrInsufficientBalance handling — the old
        depth path here consumed it, a parity bug."""
        if kind == "create":
            return self._begin_create(args, depth)
        if kind == "call":
            caller, to, value, data, gas, static, origin = args
            code_addr = storage_addr = to
        else:  # codecall: callee code in the caller's storage context
            code_addr, storage_addr, value, data, gas, caller, origin, \
                static = args
        if depth > CALL_DEPTH_LIMIT:
            return ExecResult(False, 0)
        if kind == "call" and value \
                and self.state.balance(caller) < value:
            return ExecResult(False, 0)
        snapshot = self.state
        frame_state = snapshot.copy()
        to_int = int.from_bytes(code_addr, "big")
        try:
            if kind == "call" and value:
                if static:
                    raise EvmError("static value transfer")
                frame_state.sub_balance(caller, value)
                frame_state.add_balance(to, value)
            if 1 <= to_int <= 8:
                out, gas_left = self._precompile(to_int, data, gas)
                snapshot.absorb(frame_state)
                return ExecResult(True, gas - gas_left, out)
        except (EvmError, StateError):
            return ExecResult(False, gas)
        code = frame_state.code(code_addr)
        if not code:
            snapshot.absorb(frame_state)
            return ExecResult(True, 0, b"")
        frame = _Frame(code=code, addr=storage_addr, caller=caller,
                       origin=origin, value=value, data=data, gas=gas,
                       static=static)
        self.state = frame_state
        return _Task(kind, self._run(frame, depth), frame, depth, snapshot,
                     frame_state, len(self.logs), self.refund,
                     frozenset(self.suicides), gas, storage_addr)

    def _begin_create(self, args: tuple, depth: int):
        from eges_tpu_torch.core.state import contract_address

        caller, value, init_code, gas, nonce, origin = args
        if depth > CALL_DEPTH_LIMIT:
            return ExecResult(False, 0)
        if value and self.state.balance(caller) < value:
            return ExecResult(False, 0)
        new_addr = contract_address(caller, nonce)
        snapshot = self.state
        if snapshot.code(new_addr) or snapshot.nonce(new_addr):
            # collision consumes all gas (evm.Create
            # ErrContractAddressCollision)
            return ExecResult(False, gas)
        frame_state = snapshot.copy()
        if value:
            frame_state.sub_balance(caller, value)
            frame_state.add_balance(new_addr, value)
        frame_state.bump_nonce(new_addr)
        frame = _Frame(code=init_code, addr=new_addr, caller=caller,
                       origin=origin, value=value, data=b"", gas=gas,
                       static=False)
        self.state = frame_state
        return _Task("create", self._run(frame, depth), frame, depth,
                     snapshot, frame_state, len(self.logs), self.refund,
                     frozenset(self.suicides), gas, new_addr, new_addr)

    def _finish_ok(self, task: "_Task", out: bytes) -> ExecResult:
        f = task.frame
        if self.tracer is not None:
            self.tracer.on_frame_end(task.depth, f.gas)
        if task.kind == "create":
            deposit = G_CODE_DEPOSIT_BYTE * len(out)
            if f.gas < deposit:
                return self._finish_err(task, EvmError("oog:code deposit"))
            f.gas -= deposit
            task.frame_state.set_storage_many(task.to, f.swrites)
            task.frame_state.set_code(task.to, bytes(out))
            task.snapshot.absorb(task.frame_state)
            self.state = task.snapshot
            return ExecResult(True, task.gas - f.gas, b"",
                              created=task.new_addr)
        task.frame_state.set_storage_many(task.to, f.swrites)
        task.snapshot.absorb(task.frame_state)
        self.state = task.snapshot
        return ExecResult(True, task.gas - f.gas, out)

    def _finish_revert(self, task: "_Task", r: Revert) -> ExecResult:
        del self.logs[task.log_mark:]
        self.refund = task.refund_mark
        self.suicides = set(task.suicide_mark)
        gas_left = getattr(r, "gas_left", 0)
        if self.tracer is not None:
            self.tracer.on_fault(task.depth, gas_left, "execution reverted")
            if task.depth == 0:  # only the txn-level frame's revert data
                self.tracer.output = r.data  # is the trace's output
        self.state = task.snapshot
        return ExecResult(False, task.gas - gas_left, r.data,
                          reverted=True)

    def _finish_err(self, task: "_Task", e: Exception) -> ExecResult:
        del self.logs[task.log_mark:]
        self.refund = task.refund_mark
        self.suicides = set(task.suicide_mark)
        if self.tracer is not None:
            self.tracer.on_fault(task.depth, 0, str(e) or "evm error")
        self.state = task.snapshot
        return ExecResult(False, task.gas)  # all gas consumed

    def _flush_storage(self, f: "_Frame") -> None:
        """Push the frame's SSTORE cache into the live state before a
        sub-call, so reentrant frames observe and may overwrite it; the
        cache restarts empty (reads fall through to state)."""
        if f.swrites:
            self.state.set_storage_many(f.addr, dict(f.swrites))
            f.swrites.clear()

    # -- interpreter loop (ref: core/vm/interpreter.go Run) --------------

    def _run(self, f: _Frame, depth: int) -> bytes:
        jumpdests = None  # computed lazily on first JUMP
        code = f.code

        def use(n: int) -> None:
            if f.gas < n:
                raise EvmError("out of gas")
            f.gas -= n

        def grow(end: int) -> None:
            if end <= len(f.mem):
                return
            new_w = _words(end)
            use(_mem_gas(new_w) - _mem_gas(_words(len(f.mem))))
            f.mem.extend(bytes(new_w * 32 - len(f.mem)))

        def push(v: int) -> None:
            if len(f.stack) >= STACK_LIMIT:
                raise EvmError("stack overflow")
            f.stack.append(v & MAXU)

        def pop() -> int:
            if not f.stack:
                raise EvmError("stack underflow")
            return f.stack.pop()

        def mload(off: int, n: int) -> bytes:
            if n == 0:
                return b""
            grow(off + n)
            return bytes(f.mem[off : off + n])

        def mstore(off: int, data: bytes) -> None:
            if not data:
                return
            grow(off + len(data))
            f.mem[off : off + len(data)] = data

        def sgn(x: int) -> int:
            return x - U256 if x >> 255 else x

        while True:
            if f.pc >= len(code):
                return b""
            op = code[f.pc]
            if self.tracer is not None:
                self.tracer.on_step(f.pc, op, f.gas, depth, f.stack)
            f.pc += 1

            # PUSH1..PUSH32
            if 0x60 <= op <= 0x7F:
                n = op - 0x5F
                use(G_VERYLOW)
                push(int.from_bytes(code[f.pc : f.pc + n], "big"))
                f.pc += n
                continue
            # DUP1..DUP16
            if 0x80 <= op <= 0x8F:
                use(G_VERYLOW)
                i = op - 0x7F
                if len(f.stack) < i:
                    raise EvmError("stack underflow")
                push(f.stack[-i])
                continue
            # SWAP1..SWAP16
            if 0x90 <= op <= 0x9F:
                use(G_VERYLOW)
                i = op - 0x8F
                if len(f.stack) < i + 1:
                    raise EvmError("stack underflow")
                f.stack[-1], f.stack[-i - 1] = f.stack[-i - 1], f.stack[-1]
                continue

            if op == 0x00:  # STOP
                return b""
            elif op == 0x01:  # ADD
                use(G_VERYLOW); push(pop() + pop())
            elif op == 0x02:  # MUL
                use(G_LOW); push(pop() * pop())
            elif op == 0x03:  # SUB
                use(G_VERYLOW); a, b = pop(), pop(); push(a - b)
            elif op == 0x04:  # DIV
                use(G_LOW); a, b = pop(), pop(); push(a // b if b else 0)
            elif op == 0x05:  # SDIV
                use(G_LOW); a, b = sgn(pop()), sgn(pop())
                push(0 if b == 0 else abs(a) // abs(b) * (1 if a * b >= 0 else -1))
            elif op == 0x06:  # MOD
                use(G_LOW); a, b = pop(), pop(); push(a % b if b else 0)
            elif op == 0x07:  # SMOD
                use(G_LOW); a, b = sgn(pop()), sgn(pop())
                push(0 if b == 0 else (abs(a) % abs(b)) * (1 if a >= 0 else -1))
            elif op == 0x08:  # ADDMOD
                use(G_MID); a, b, m = pop(), pop(), pop()
                push((a + b) % m if m else 0)
            elif op == 0x09:  # MULMOD
                use(G_MID); a, b, m = pop(), pop(), pop()
                push((a * b) % m if m else 0)
            elif op == 0x0A:  # EXP
                a, e = pop(), pop()
                use(G_EXP + G_EXP_BYTE * ((e.bit_length() + 7) // 8))
                push(pow(a, e, U256))
            elif op == 0x0B:  # SIGNEXTEND
                use(G_LOW); k, x = pop(), pop()
                if k < 31:
                    bit = 8 * (k + 1) - 1
                    if x >> bit & 1:
                        x |= MAXU ^ ((1 << (bit + 1)) - 1)
                    else:
                        x &= (1 << (bit + 1)) - 1
                push(x)
            elif op == 0x10:  # LT
                use(G_VERYLOW); push(1 if pop() < pop() else 0)
            elif op == 0x11:  # GT
                use(G_VERYLOW); push(1 if pop() > pop() else 0)
            elif op == 0x12:  # SLT
                use(G_VERYLOW); push(1 if sgn(pop()) < sgn(pop()) else 0)
            elif op == 0x13:  # SGT
                use(G_VERYLOW); push(1 if sgn(pop()) > sgn(pop()) else 0)
            elif op == 0x14:  # EQ
                use(G_VERYLOW); push(1 if pop() == pop() else 0)
            elif op == 0x15:  # ISZERO
                use(G_VERYLOW); push(1 if pop() == 0 else 0)
            elif op == 0x16:  # AND
                use(G_VERYLOW); push(pop() & pop())
            elif op == 0x17:  # OR
                use(G_VERYLOW); push(pop() | pop())
            elif op == 0x18:  # XOR
                use(G_VERYLOW); push(pop() ^ pop())
            elif op == 0x19:  # NOT
                use(G_VERYLOW); push(MAXU ^ pop())
            elif op == 0x1A:  # BYTE
                use(G_VERYLOW); i, x = pop(), pop()
                push((x >> (8 * (31 - i))) & 0xFF if i < 32 else 0)
            elif op == 0x1B:  # SHL
                use(G_VERYLOW); s, x = pop(), pop()
                push(x << s if s < 256 else 0)
            elif op == 0x1C:  # SHR
                use(G_VERYLOW); s, x = pop(), pop()
                push(x >> s if s < 256 else 0)
            elif op == 0x1D:  # SAR
                use(G_VERYLOW); s, x = pop(), sgn(pop())
                push((x >> s if s < 256 else (0 if x >= 0 else MAXU)))
            elif op == 0x20:  # SHA3
                off, n = pop(), pop()
                use(G_SHA3 + G_SHA3_WORD * _words(n))
                push(int.from_bytes(keccak256(mload(off, n)), "big"))
            elif op == 0x30:  # ADDRESS
                use(G_BASE); push(int.from_bytes(f.addr, "big"))
            elif op == 0x31:  # BALANCE
                use(G_BALANCE)
                push(self.state.balance(pop().to_bytes(32, "big")[12:]))
            elif op == 0x32:  # ORIGIN
                use(G_BASE); push(int.from_bytes(f.origin, "big"))
            elif op == 0x33:  # CALLER
                use(G_BASE); push(int.from_bytes(f.caller, "big"))
            elif op == 0x34:  # CALLVALUE
                use(G_BASE); push(f.value)
            elif op == 0x35:  # CALLDATALOAD
                use(G_VERYLOW); off = pop()
                push(int.from_bytes(f.data[off : off + 32].ljust(32, b"\0"),
                                    "big") if off < len(f.data) else 0)
            elif op == 0x36:  # CALLDATASIZE
                use(G_BASE); push(len(f.data))
            elif op == 0x37:  # CALLDATACOPY
                dst, src, n = pop(), pop(), pop()
                use(G_VERYLOW + G_COPY_WORD * _words(n))
                chunk = f.data[src : src + n] if src < len(f.data) else b""
                mstore(dst, chunk.ljust(n, b"\0"))
            elif op == 0x38:  # CODESIZE
                use(G_BASE); push(len(code))
            elif op == 0x39:  # CODECOPY
                dst, src, n = pop(), pop(), pop()
                use(G_VERYLOW + G_COPY_WORD * _words(n))
                chunk = code[src : src + n] if src < len(code) else b""
                mstore(dst, chunk.ljust(n, b"\0"))
            elif op == 0x3A:  # GASPRICE
                use(G_BASE); push(0)
            elif op == 0x3B:  # EXTCODESIZE
                use(G_EXTCODE)
                push(len(self.state.code(pop().to_bytes(32, "big")[12:])))
            elif op == 0x3C:  # EXTCODECOPY
                addr = pop().to_bytes(32, "big")[12:]
                dst, src, n = pop(), pop(), pop()
                use(G_EXTCODE + G_COPY_WORD * _words(n))
                c = self.state.code(addr)
                chunk = c[src : src + n] if src < len(c) else b""
                mstore(dst, chunk.ljust(n, b"\0"))
            elif op == 0x3D:  # RETURNDATASIZE
                use(G_BASE); push(len(f.ret))
            elif op == 0x3E:  # RETURNDATACOPY
                dst, src, n = pop(), pop(), pop()
                use(G_VERYLOW + G_COPY_WORD * _words(n))
                if src + n > len(f.ret):
                    raise EvmError("returndata out of bounds")
                mstore(dst, f.ret[src : src + n])
            elif op == 0x40:  # BLOCKHASH
                use(G_HIGH + 10); n = pop()
                bh = self.ctx.blockhash
                # only the previous 256 ancestors — never the block
                # being executed, whose hash is not yet sealed
                # (ref core/vm/instructions.go opBlockhash: distance
                # 1..256, else zero)
                push(int.from_bytes(bh(n), "big")
                     if bh is not None and 1 <= self.ctx.number - n <= 256
                     else 0)
            elif op == 0x41:  # COINBASE
                use(G_BASE); push(int.from_bytes(self.ctx.coinbase, "big"))
            elif op == 0x42:  # TIMESTAMP
                use(G_BASE); push(self.ctx.time)
            elif op == 0x43:  # NUMBER
                use(G_BASE); push(self.ctx.number)
            elif op == 0x44:  # DIFFICULTY
                use(G_BASE); push(self.ctx.difficulty)
            elif op == 0x45:  # GASLIMIT
                use(G_BASE); push(self.ctx.gas_limit)
            elif op == 0x50:  # POP
                use(G_BASE); pop()
            elif op == 0x51:  # MLOAD
                use(G_VERYLOW); off = pop()
                push(int.from_bytes(mload(off, 32), "big"))
            elif op == 0x52:  # MSTORE
                use(G_VERYLOW); off, v = pop(), pop()
                mstore(off, v.to_bytes(32, "big"))
            elif op == 0x53:  # MSTORE8
                use(G_VERYLOW); off, v = pop(), pop()
                mstore(off, bytes([v & 0xFF]))
            elif op == 0x54:  # SLOAD
                use(G_SLOAD); slot = pop()
                v = f.swrites.get(slot)
                push(v if v is not None
                     else self.state.storage_at(f.addr, slot))
            elif op == 0x55:  # SSTORE
                if f.static:
                    raise EvmError("static sstore")
                slot, v = pop(), pop()
                cur = f.swrites.get(slot)
                if cur is None:
                    cur = self.state.storage_at(f.addr, slot)
                # pre-Constantinople rules (gas_table.go:117 gasSStore):
                # 0->nonzero SET, else RESET; nonzero->0 earns the
                # 15 000 clear refund
                if cur == 0 and v != 0:
                    use(G_SSTORE_SET)
                else:
                    use(G_SSTORE_RESET)
                    if cur != 0 and v == 0:
                        self.refund += R_SCLEAR
                f.swrites[slot] = v
            elif op == 0x56:  # JUMP
                use(G_MID); dst = pop()
                if jumpdests is None:
                    jumpdests = _jumpdests(code)
                if dst not in jumpdests:
                    raise EvmError("bad jump")
                f.pc = dst
            elif op == 0x57:  # JUMPI
                use(G_HIGH); dst, cond = pop(), pop()
                if cond:
                    if jumpdests is None:
                        jumpdests = _jumpdests(code)
                    if dst not in jumpdests:
                        raise EvmError("bad jump")
                    f.pc = dst
            elif op == 0x58:  # PC
                use(G_BASE); push(f.pc - 1)
            elif op == 0x59:  # MSIZE
                use(G_BASE); push(len(f.mem))
            elif op == 0x5A:  # GAS
                use(G_BASE); push(f.gas)
            elif op == 0x5B:  # JUMPDEST
                use(G_JUMPDEST)
            elif 0xA0 <= op <= 0xA4:  # LOG0..LOG4
                if f.static:
                    raise EvmError("static log")
                n_topics = op - 0xA0
                off, n = pop(), pop()
                topics = tuple(pop().to_bytes(32, "big")
                               for _ in range(n_topics))
                use(G_LOG + G_LOG_TOPIC * n_topics + G_LOG_BYTE * n)
                self.logs.append((f.addr, topics, mload(off, n)))
            elif op == 0xF0:  # CREATE
                if f.static:
                    raise EvmError("static create")
                value, off, n = pop(), pop(), pop()
                use(G_CREATE)
                init = mload(off, n)
                gas_for = f.gas - f.gas // 64
                f.gas -= gas_for
                self._flush_storage(f)
                self.state.bump_nonce(f.addr)
                res = yield ("create", (f.addr, value, init, gas_for,
                                        self.state.nonce(f.addr) - 1,
                                        f.origin), "CREATE")
                f.gas += gas_for - res.gas_used
                f.ret = res.output if not res.success else b""
                push(int.from_bytes(res.created, "big")
                     if res.success and res.created else 0)
            elif op in (0xF1, 0xF2, 0xF4, 0xFA):  # CALL/CALLCODE/DELEGATECALL/STATICCALL
                gas_req = pop()
                to = pop().to_bytes(32, "big")[12:]
                if op in (0xF1, 0xF2):
                    value = pop()
                else:
                    value = 0
                in_off, in_n, out_off, out_n = pop(), pop(), pop(), pop()
                if op == 0xF1 and f.static and value:
                    raise EvmError("static call with value")
                base = G_CALL + (G_CALL_VALUE if value else 0)
                to_int = int.from_bytes(to, "big")
                if (op == 0xF1 and value
                        and self.state.account(to).balance == 0
                        and self.state.nonce(to) == 0
                        and not self.state.code(to)
                        and not (1 <= to_int <= 8)):
                    base += G_NEW_ACCOUNT
                use(base)
                data = mload(in_off, in_n)
                if out_n:
                    grow(out_off + out_n)
                avail = f.gas - f.gas // 64
                gas_for = min(gas_req, avail)
                f.gas -= gas_for
                stipend = G_CALL_STIPEND if value else 0
                # reentrancy: nested frames must see this frame's storage
                # writes, and may write our storage themselves — flush
                # the cache down and re-read from state afterwards
                self._flush_storage(f)
                if op == 0xF2 and value > self.state.balance(f.addr):
                    # CALLCODE checks but does not move the balance
                    # (ref: evm.CallCode CanTransfer); gas is returned
                    res = ExecResult(False, 0)
                elif op == 0xF1:  # CALL
                    res = yield ("call", (f.addr, to, value, data,
                                          gas_for + stipend, f.static,
                                          f.origin), "CALL")
                elif op == 0xF2:  # CALLCODE: callee code, our storage
                    res = yield ("codecall", (to, f.addr, value, data,
                                              gas_for + stipend, f.addr,
                                              f.origin, f.static),
                                 "CALLCODE")
                elif op == 0xF4:  # DELEGATECALL: keep caller+value
                    res = yield ("codecall", (to, f.addr, f.value, data,
                                              gas_for, f.caller,
                                              f.origin, f.static),
                                 "DELEGATECALL")
                else:  # STATICCALL
                    res = yield ("call", (f.addr, to, 0, data, gas_for,
                                          True, f.origin), "STATICCALL")
                # leftover callee gas (incl. unused stipend) returns to
                # the caller, matching the reference's accounting
                # (contract.Gas += returnGas, core/vm/evm.go Call)
                used = min(res.gas_used, gas_for + stipend)
                f.gas += (gas_for + stipend) - used
                f.ret = res.output
                if out_n:
                    # write only what the callee returned; the rest of
                    # the reserved region keeps its prior contents
                    # (ref: memory.Set in opCall — no zero-fill)
                    mstore(out_off, res.output[:out_n])
                push(1 if res.success else 0)
            elif op == 0xF3:  # RETURN
                off, n = pop(), pop()
                return mload(off, n)
            elif op == 0xFD:  # REVERT
                off, n = pop(), pop()
                r = Revert(mload(off, n))
                r.gas_left = f.gas
                raise r
            elif op == 0xFE:  # INVALID
                raise EvmError("invalid opcode 0xfe")
            elif op == 0xFF:  # SELFDESTRUCT
                if f.static:
                    raise EvmError("static selfdestruct")
                heir = pop().to_bytes(32, "big")[12:]
                bal = self.state.balance(f.addr)
                cost = G_SELF_DESTRUCT
                if bal and not self.state.nonce(heir) \
                        and not self.state.balance(heir) \
                        and not self.state.code(heir):
                    # sweeping into a non-existent account pays the
                    # account-creation surcharge (gas_table.go
                    # gasSelfdestruct, EIP-150 rules)
                    cost += G_NEW_ACCOUNT
                use(cost)
                if f.addr not in self.suicides:
                    # 24 000 once per address per txn
                    # (params.SuicideRefundGas via HasSuicided)
                    self.refund += R_SELFDESTRUCT
                    self.suicides.add(f.addr)
                if bal:
                    self.state.sub_balance(f.addr, bal)
                    self.state.add_balance(heir, bal)
                # the account itself is deleted at txn finalization
                # (state.apply_txn), matching Finalise-time deletion
                return b""
            else:
                raise EvmError(f"unknown opcode {op:#x}")

def _jumpdests(code: bytes) -> set[int]:
    """Valid JUMPDEST offsets (PUSH data bytes excluded)."""
    out = set()
    i = 0
    n = len(code)
    while i < n:
        op = code[i]
        if op == 0x5B:
            out.add(i)
        i += (op - 0x5E) if 0x60 <= op <= 0x7F else 1
    return out


def intrinsic_gas(data: bytes, is_create: bool) -> int:
    """(ref: core/state_transition.go IntrinsicGas)"""
    g = G_TX_CREATE if is_create else G_TX
    for b in data:
        g += G_NONZERO_BYTE if b else G_ZERO_BYTE
    return g
