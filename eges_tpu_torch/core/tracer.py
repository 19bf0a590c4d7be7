"""EVM execution tracing (the eth/tracers + vm.Config.Tracer role).

The port's copy of ``eges_tpu/core/tracer.py``, unchanged.

The reference hooks a ``Tracer`` into the interpreter loop
(core/vm/interpreter.go calls tracer.CaptureState per opcode;
eth/tracers/tracer.go + internal/ethapi expose it as
``debug_traceTransaction``).  Same seam here: :class:`StructLogTracer`
receives one callback per executed opcode from ``EVM._run`` and
produces geth-shaped struct logs — pc, op name, remaining gas, gas cost,
call depth, stack — so a failing contract call can be debugged from the
RPC instead of by reading the interpreter.

Gas cost per step is derived retroactively: a step's cost is its gas
minus the gas at the NEXT step observed at the same depth (for CALL-family
ops that spans the whole sub-call, which is what gas attribution at the
call site means); the final pending step of each depth settles against
the frame's end-of-run gas.
"""

from __future__ import annotations

OPNAMES: dict[int, str] = {
    0x00: "STOP", 0x01: "ADD", 0x02: "MUL", 0x03: "SUB", 0x04: "DIV",
    0x05: "SDIV", 0x06: "MOD", 0x07: "SMOD", 0x08: "ADDMOD",
    0x09: "MULMOD", 0x0A: "EXP", 0x0B: "SIGNEXTEND",
    0x10: "LT", 0x11: "GT", 0x12: "SLT", 0x13: "SGT", 0x14: "EQ",
    0x15: "ISZERO", 0x16: "AND", 0x17: "OR", 0x18: "XOR", 0x19: "NOT",
    0x1A: "BYTE",
    0x20: "SHA3",
    0x30: "ADDRESS", 0x31: "BALANCE", 0x32: "ORIGIN", 0x33: "CALLER",
    0x34: "CALLVALUE", 0x35: "CALLDATALOAD", 0x36: "CALLDATASIZE",
    0x37: "CALLDATACOPY", 0x38: "CODESIZE", 0x39: "CODECOPY",
    0x3A: "GASPRICE", 0x3B: "EXTCODESIZE", 0x3C: "EXTCODECOPY",
    0x3D: "RETURNDATASIZE", 0x3E: "RETURNDATACOPY",
    0x40: "BLOCKHASH", 0x41: "COINBASE", 0x42: "TIMESTAMP",
    0x43: "NUMBER", 0x44: "DIFFICULTY", 0x45: "GASLIMIT",
    0x50: "POP", 0x51: "MLOAD", 0x52: "MSTORE", 0x53: "MSTORE8",
    0x54: "SLOAD", 0x55: "SSTORE", 0x56: "JUMP", 0x57: "JUMPI",
    0x58: "PC", 0x59: "MSIZE", 0x5A: "GAS", 0x5B: "JUMPDEST",
    0xF0: "CREATE", 0xF1: "CALL", 0xF2: "CALLCODE", 0xF3: "RETURN",
    0xF4: "DELEGATECALL", 0xFA: "STATICCALL", 0xFD: "REVERT",
    0xFE: "INVALID", 0xFF: "SELFDESTRUCT",
}
for _i in range(32):
    OPNAMES[0x60 + _i] = f"PUSH{_i + 1}"
for _i in range(16):
    OPNAMES[0x80 + _i] = f"DUP{_i + 1}"
    OPNAMES[0x90 + _i] = f"SWAP{_i + 1}"
for _i in range(5):
    OPNAMES[0xA0 + _i] = f"LOG{_i}"


def op_name(op: int) -> str:
    return OPNAMES.get(op, f"opcode {op:#x}")


class StructLogTracer:
    """Per-opcode struct logger (ref: core/vm/logger.go StructLogger).

    ``on_step`` fires from the interpreter before each opcode executes;
    ``on_fault`` tags the most recent step with the error that unwound
    the frame; ``result`` settles pending gas costs and returns the
    RPC-shaped trace."""

    MAX_STEPS = 200_000  # bound adversarial traces (geth caps via timeout)

    def __init__(self, with_stack: bool = True):
        self.logs: list[dict] = []
        self.with_stack = with_stack
        self._pending: dict[int, dict] = {}  # depth -> unsettled entry
        self.truncated = False
        self.output = b""  # revert data / return data when the EVM has it

    def on_step(self, pc: int, op: int, gas: int, depth: int,
                stack: list) -> None:
        if len(self.logs) >= self.MAX_STEPS:
            self.truncated = True
            return
        # settle the previous entry at this depth: its cost is the gas
        # drop to now (spans the sub-call for CALL-family ops); a depth
        # we returned from deeper than this one settles on frame end
        prev = self._pending.get(depth)
        if prev is not None:
            prev["gasCost"] = prev["gas"] - gas
        for d in [d for d in self._pending if d > depth]:
            del self._pending[d]
        entry = {"pc": pc, "op": op_name(op), "gas": gas, "gasCost": 0,
                 "depth": depth + 1}  # geth depth is 1-based
        if self.with_stack:
            entry["stack"] = [hex(v) for v in stack]  # bottom -> top
        self.logs.append(entry)
        self._pending[depth] = entry

    def on_fault(self, depth: int, gas_left: int, error: str) -> None:
        prev = self._pending.pop(depth, None)
        if prev is not None:
            prev["gasCost"] = prev["gas"] - gas_left
            prev["error"] = error
        elif self.logs:
            self.logs[-1].setdefault("error", error)

    def on_frame_end(self, depth: int, gas_left: int) -> None:
        """Settle the frame's terminal opcode (RETURN/STOP/implicit end)
        against the gas the frame finished with — on_step can only
        settle a step once a LATER step at the same depth arrives."""
        prev = self._pending.pop(depth, None)
        if prev is not None:
            prev["gasCost"] = prev["gas"] - gas_left

    def result(self, *, gas_used: int, failed: bool,
               output: bytes) -> dict:
        self._pending.clear()
        out = {
            "gas": gas_used,
            "failed": failed,
            "returnValue": (output or self.output).hex(),
            "structLogs": self.logs,
        }
        if self.truncated:
            out["truncated"] = True
        return out


# ---------------------------------------------------------------------------
# Named tracers — the bundled-tracer role of the reference
# (eth/tracers/internal/tracers/{call_tracer,prestate_tracer,
# 4byte_tracer}.js, selected by name through debug_traceTransaction's
# ``tracer`` config).  DESIGN DECISION vs the reference: geth embeds a
# JS VM (otto) so operators can ship arbitrary tracer scripts; this
# build implements the tracers operators actually use as native Python
# classes on the same frame-boundary hooks (EVM._trace_enter/_trace_exit
# = CaptureEnter/CaptureExit).  A custom tracer here is a ~30-line
# Python class instead of a JS snippet — the extension POINT has parity,
# the extension LANGUAGE is the host language.
# ---------------------------------------------------------------------------

def _hx(b: bytes | None) -> str | None:
    return None if b is None else "0x" + b.hex()


class FrameTracer:
    """No-op base implementing the full tracer surface: per-opcode
    (on_step/on_fault/on_frame_end) and frame-boundary
    (on_enter/on_exit) hooks plus the ``output`` attr the EVM sets on a
    top-level revert."""

    def __init__(self):
        self.output = b""

    def on_step(self, pc, op, gas, depth, stack):  # noqa: D102
        pass

    def on_fault(self, depth, gas_left, error):
        pass

    def on_frame_end(self, depth, gas_left):
        pass

    def on_enter(self, frame: dict):
        pass

    def on_exit(self, res, depth: int):
        pass


class CallTracer(FrameTracer):
    """Nested call tree (ref: call_tracer.js): one node per frame with
    type/from/to/value/gas/gasUsed/input/output/error and ``calls``."""

    def __init__(self):
        super().__init__()
        self._stack: list[dict] = []
        self.root: dict | None = None

    def on_enter(self, frame: dict) -> None:
        node = {
            "type": frame["type"],
            "from": _hx(frame["frm"]),
            "to": _hx(frame["to"]),
            "gas": hex(frame["gas"]),
            "input": _hx(frame["input"]) or "0x",
        }
        # no value field on frames that cannot transfer one (the
        # reference's callTracer omits it for DELEGATECALL/STATICCALL)
        if frame["type"] not in ("DELEGATECALL", "STATICCALL"):
            node["value"] = hex(frame["value"])
        self._stack.append(node)

    def on_exit(self, res, depth: int) -> None:
        node = self._stack.pop()
        node["gasUsed"] = hex(res.gas_used)
        if res.output:
            node["output"] = _hx(res.output)
        if getattr(res, "created", None):
            node["to"] = _hx(res.created)   # CREATE: address known now
        if not res.success:
            node["error"] = ("execution reverted"
                             if getattr(res, "reverted", False)
                             else "execution failed")
        if self._stack:
            self._stack[-1].setdefault("calls", []).append(node)
        else:
            self.root = node

    def result(self, *, gas_used: int, failed: bool, output: bytes) -> dict:
        root = self.root or {}
        root["gasUsed"] = hex(gas_used)
        return root


class PrestateTracer(FrameTracer):
    """Pre-transaction state of every account the txn touches (ref:
    prestate_tracer.js): balance/nonce/code plus the PRE values of every
    storage slot read or written.  Needs a handle to the untouched
    pre-state — the RPC layer runs the traced txn on a copy."""

    def __init__(self, pre_state, coinbase: bytes | None = None):
        super().__init__()
        self._pre = pre_state
        self._ctx: list[bytes] = []     # storage-context per live frame
        self._accounts: dict[bytes, dict] = {}
        if coinbase:
            self._touch(coinbase)

    def _touch(self, addr: bytes) -> None:
        if addr in self._accounts:
            return
        a = self._pre.account(addr)
        code = self._pre.code(addr)
        entry: dict = {"balance": hex(a.balance), "nonce": a.nonce}
        if code:
            entry["code"] = "0x" + code.hex()
        self._accounts[addr] = entry

    def _touch_slot(self, addr: bytes, slot: int) -> None:
        self._touch(addr)
        store = self._accounts[addr].setdefault("storage", {})
        key = "0x" + slot.to_bytes(32, "big").hex()
        if key not in store:
            store[key] = "0x" + self._pre.storage_at(
                addr, slot).to_bytes(32, "big").hex()

    def on_enter(self, frame: dict) -> None:
        self._ctx.append(frame["context"] or b"")
        self._touch(frame["frm"])
        if frame["to"] is not None:
            self._touch(frame["to"])

    def on_exit(self, res, depth: int) -> None:
        self._ctx.pop()

    def on_step(self, pc, op, gas, depth, stack) -> None:
        if not stack or not self._ctx:
            return
        if op in (0x54, 0x55):                      # SLOAD / SSTORE
            self._touch_slot(self._ctx[-1], stack[-1])
        elif op in (0x31, 0x3B, 0x3C, 0x3F, 0xFF):  # BALANCE/EXTCODE*/SD
            self._touch(stack[-1].to_bytes(32, "big")[12:])

    def result(self, *, gas_used: int, failed: bool, output: bytes) -> dict:
        return {_hx(a): v for a, v in sorted(self._accounts.items())}


class FourByteTracer(FrameTracer):
    """Selector histogram (ref: 4byte_tracer.js): counts
    ``selector-calldatasize`` of every frame carrying >= 4 input bytes."""

    def __init__(self):
        super().__init__()
        self.counts: dict[str, int] = {}

    def on_enter(self, frame: dict) -> None:
        data = frame["input"] or b""
        if frame["type"] != "CREATE" and len(data) >= 4:
            key = f"0x{data[:4].hex()}-{len(data) - 4}"
            self.counts[key] = self.counts.get(key, 0) + 1

    def result(self, *, gas_used: int, failed: bool, output: bytes) -> dict:
        return dict(sorted(self.counts.items()))
