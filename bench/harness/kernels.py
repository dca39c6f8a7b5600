"""Which device kernels belong to which kernel of the port: one directory a
group under ``bench/kernels`` (``bq``: K1 and K2, ``k3``: K3), each file in it
one kernel name a line (``#`` starts a comment).  A kernel that takes over a
group's work adds a file to its directory."""
from __future__ import annotations

from bench.harness.cells import BENCH


def names(group: str) -> tuple:
    out = []
    for f in sorted((BENCH / "kernels" / group).glob("*.txt")):
        for line in f.read_text().splitlines():
            line = line.split("#", 1)[0].strip()
            if line:
                out.append(line)
    return tuple(out)
