"""Error registry — typed exceptions with the reference's error NUMBERING
(flow/Error.h + fdbclient error_definitions.h: every error has a stable
numeric code bindings and tools key off; `fdb_error_t` in the C API).

The numeric codes below ARE the reference's: 1007 transaction_too_old,
1009 future_version, 1020 not_committed, 1021 commit_unknown_result,
1004 timed_out, 1100 broken_promise, 1101 operation_cancelled — so a user
coming from the reference reads the same numbers in traces and tooling.

Copy of the reference package's module, over the port's own exception
classes (roles/types.py, runtime/core.py): the same codes and names.
"""

from __future__ import annotations

from .types import (
    CommitUnknownResult,
    DatabaseLocked,
    FutureVersion,
    NotCommitted,
    TransactionTooOld,
)
from ..runtime.core import ActorCancelled, BrokenPromise, TimedOut

# exception type -> (code, name) — reference error_definitions.h numbering
ERROR_REGISTRY: dict[type, tuple[int, str]] = {
    TimedOut: (1004, "timed_out"),
    TransactionTooOld: (1007, "transaction_too_old"),
    FutureVersion: (1009, "future_version"),
    NotCommitted: (1020, "not_committed"),
    CommitUnknownResult: (1021, "commit_unknown_result"),
    DatabaseLocked: (1038, "database_locked"),
    BrokenPromise: (1100, "broken_promise"),
    ActorCancelled: (1101, "operation_cancelled"),
}

_BY_CODE = {code: (ty, name) for ty, (code, name) in ERROR_REGISTRY.items()}


def error_code(exc: BaseException) -> int:
    """Stable numeric code for an exception; anything unregistered reports
    4100 internal_error (fdb_error_t semantics: 0 is reserved for success
    and is never produced for an exception)."""
    for ty, (code, _name) in ERROR_REGISTRY.items():
        if isinstance(exc, ty):
            return code
    return 4100


def error_name(code: int) -> str:
    if code == 4100:
        return "internal_error"
    if code in _BY_CODE:
        return _BY_CODE[code][1]
    return f"unknown_error_{code}"


def error_for_code(code: int) -> BaseException:
    """Reconstruct a typed exception from its wire code (bindings)."""
    if code in _BY_CODE:
        return _BY_CODE[code][0]()
    return RuntimeError(error_name(code))
