#!/usr/bin/env python3
"""Compare the ``-Xptxas -v`` report of two source trees' kernel libraries,
instantiation by instantiation, on a machine with nvcc:

    python3 compare_ptxas.py --src proof/parent/src [--libs flash_decode_paged ...]

Builds the named libraries of ``--src`` (another tree's ``src``, e.g. a
parent commit unpacked with ``git archive``) and of this tree, demangles
each kernel's name with ``c++filt`` and reads its registers, spill stores
and loads, stack frame and static shared memory. A template parameter list
that names one element type twice (``<float, float, ...>``, a query and a
cache of one dtype) is compared with the other tree's single-type one. Prints
each kernel of the other tree as ``same`` or ``DIFF``, then this tree's new
instantiations; exits non-zero when a kernel of the other tree is missing
or differs.
"""
from __future__ import annotations

import argparse
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
FIELDS = (("registers", r"Used (\d+) registers"),
          ("spill_stores", r"(\d+) bytes spill stores"),
          ("spill_loads", r"(\d+) bytes spill loads"),
          ("stack", r"(\d+) bytes stack frame"),
          ("smem", r"(\d+) bytes smem"))


def report(log: str) -> dict:
    """{normalised kernel name: {field: value}} of one library's log."""
    text = subprocess.run(["c++filt"], input=log, capture_output=True,
                          text=True, check=True).stdout
    out, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function properties for (.*)$", line) or \
            re.search(r"Compiling entry function '(.*)' for", line)
        if m:
            cur = re.sub(r"\b(__nv_bfloat16|float), \1\b", r"\1", m.group(1).strip())
            out.setdefault(cur, {})
            continue
        for key, pat in FIELDS:
            m = re.search(pat, line)
            if m and cur is not None:
                out[cur][key] = int(m.group(1))
    return {k: v for k, v in out.items() if v}


def library_logs(src: Path, libs) -> dict:
    """Build ``libs`` of the tree whose ``src`` is ``src`` (in a child
    process, so that its ``repro_torch`` is the one imported) and return
    their logs."""
    code = ("import sys; sys.path.insert(0, sys.argv[1]);"
            "from repro_torch.kernels import backend;"
            "names = sys.argv[2:]; backend.build_libraries(names);"
            "print('\\n'.join(str(backend.library_path(n).with_suffix('.log')) for n in names))")
    out = subprocess.run([sys.executable, "-c", code, str(src), *libs],
                         capture_output=True, text=True, check=True).stdout
    return {n: Path(p).read_text() for n, p in zip(libs, out.split())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", required=True, help="the other tree's src directory")
    ap.add_argument("--libs", nargs="+", default=["flash_decode_paged", "flash_decode_spec"])
    args = ap.parse_args(argv)
    theirs = library_logs(Path(args.src).resolve(), args.libs)
    ours = library_logs(ROOT / "src", args.libs)
    ok = True
    for lib in args.libs:
        want, got = report(theirs[lib]), report(ours[lib])
        print(f"[ptxas] {lib}: {len(want)} kernels in {args.src}, {len(got)} here")
        for name, fields in sorted(want.items()):
            same = got.get(name) == fields
            ok &= same
            print(f"[ptxas]   {'same' if same else 'DIFF'} {name}: {fields} -> {got.get(name)}")
        for name in sorted(set(got) - set(want)):
            print(f"[ptxas]   new {name}: {got[name]}")
    print(f"[ptxas] every kernel of {args.src} unchanged here: {ok}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
