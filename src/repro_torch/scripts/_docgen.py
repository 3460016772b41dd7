"""What the doc generators share: run the ``reproc`` driver in-process
and show a command beside its output as two fenced blocks."""

from __future__ import annotations

import io

from repro_torch.core import reproc


def run_reproc(*argv: str) -> str:
    """Run the reproc driver in-process and capture its stdout."""
    buf = io.StringIO()
    rc = reproc.main(list(argv), out=buf)
    if rc != 0:
        raise RuntimeError(f"reproc {' '.join(argv)} exited {rc}")
    return buf.getvalue().rstrip("\n")


def block(cmd_args: list, lang: str = "") -> str:
    shown = ("PYTHONPATH=src python -m repro_torch.core.reproc "
             + " ".join(cmd_args))
    out = run_reproc(*cmd_args)
    return (f"```sh\n{shown}\n```\n\n"
            f"```{lang}\n{out}\n```")
