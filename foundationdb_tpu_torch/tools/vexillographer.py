"""Options/knobs surface generator — the vexillographer analog
(fdbclient/vexillographer: the reference generates every language binding's
option enums from one fdb.options spec so surfaces can never drift).

Here the single source of truth is the code itself: CoreKnobs' registered
definitions, the MutationType atomic-op enum, the gateway's C ABI status
codes, and the client's retryable-error set.  `generate()` renders them
into KNOBS.md; the test regenerates and diffs, so a knob added without
regenerating the doc fails CI — the same can-never-drift discipline.

Copy of the reference package's module on this package's modules.  It
renders the knob tables only: this package reads no environment, so it
has no `ENV_KNOBS` table of environment switches.  `main()` prints the
document; KNOBS.md is the reference package's and is not written here."""

from __future__ import annotations


def generate() -> str:
    from ..client.transaction import RETRYABLE_ERRORS
    from ..roles.types import MutationType
    from ..runtime.knobs import ClientKnobs, CoreKnobs
    from ..tools import gateway as gw

    k = CoreKnobs()
    lines = [
        "# Knobs, options, and error codes",
        "",
        "GENERATED by `python -m foundationdb_tpu_torch.tools.vexillographer` — do",
        "not edit by hand (tests diff this file against a regeneration).",
        "",
        "## Core knobs (`runtime/knobs.py`)",
        "",
        "| knob | default | type |",
        "|---|---|---|",
    ]
    for name in k.names():
        v = getattr(k, name)
        lines.append(f"| `{name}` | `{v!r}` | {type(v).__name__} |")
    ck = ClientKnobs()
    lines += [
        "",
        "## Client knobs (`runtime/knobs.py ClientKnobs`)",
        "",
        "| knob | default | type |",
        "|---|---|---|",
    ]
    for name in ck.names():
        v = getattr(ck, name)
        lines.append(f"| `{name}` | `{v!r}` | {type(v).__name__} |")
    lines += [
        "",
        "## Atomic operations (`roles/types.py MutationType`)",
        "",
        "| op | code |",
        "|---|---|",
    ]
    for m in MutationType:
        lines.append(f"| `{m.name}` | {int(m)} |")
    lines += [
        "",
        "## C ABI / gateway status codes (`tools/gateway.py`)",
        "",
        "| code | meaning | retryable |",
        "|---|---|---|",
    ]
    for meaning, code in sorted(gw.STATUS_CODES.items(), key=lambda kv: kv[1]):
        retry = "yes" if code in gw.RETRYABLE_CODES else "no"
        lines.append(f"| {code} | `{meaning}` | {retry} |")
    lines += [
        "",
        "## Client retryable errors (`client/transaction.py`)",
        "",
    ]
    for e in RETRYABLE_ERRORS:
        lines.append(f"- `{e.__name__}`")
    lines.append("")
    return "\n".join(lines)


def main() -> None:
    print(generate(), end="")


if __name__ == "__main__":
    main()
