#!/usr/bin/env python3
"""Compare what ``ptxas`` reported for two builds of the CUDA kernels:
registers, spills and stack of every kernel entry, from the ``build.log``
that ``ops/_build.py`` keeps (``optimization_solvers_tpu_torch/_build/
build.log`` after a build on a machine with ``nvcc``).  Entry names are
matched with the hashes of anonymous namespaces taken out, so two builds
of the same sources in different directories compare equal.  Prints the
count of identical entries, every entry that differs or that the second
build lacks, and the second build's new entries with their counts; exits
1 if an entry of the first build differs or is missing in the second (new
entries alone exit 0).

    python3 tools/ptxas_compare.py PARENT_BUILD_LOG NEW_BUILD_LOG
"""

import re
import sys

ANON = re.compile(r"N\d+_GLOBAL__N__[0-9a-f]{8}_\d+_(\w+?)_cu_[0-9a-f]{8}"
                  r"(?:_\d+)?\d+(?=[A-Za-z_])")


def entries(path):
    """{entry name without namespace hashes: [ptxas's lines for it]}."""
    out, name = {}, None
    with open(path) as fh:
        for line in fh:
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                name = ANON.sub(r"_ANON_\1_", m.group(1))
                continue
            if name and ("registers" in line or "spill" in line):
                text = line.split(":", 1)[-1] if "ptxas" in line else line
                out.setdefault(name, []).append(" ".join(text.split()))
    return out


def main(argv):
    if len(argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    a, b = entries(argv[1]), entries(argv[2])
    same = sum(1 for k in a if b.get(k) == a[k])
    print(f"ptxas: {len(a)} entries in {argv[1]}, {len(b)} in {argv[2]}, "
          f"{same} identical")
    differ = sorted(k for k in a if b.get(k) != a[k])
    for k in differ:
        print(f"differs: {k}\n   first:  {a.get(k)}\n   second: {b.get(k)}")
    for k in sorted(set(b) - set(a)):
        print(f"new: {k}\n   {b[k]}")
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
