"""What nvcc makes of the kernels: registers, shared memory, spills and SASS.

    python -m diner_tpu_torch.kernels.sass [--csrc DIR] [--out DIR] [NAME ...]

Compiles each `csrc/<NAME>.cu` (every source by default; `--csrc` reads them
from another directory, e.g. an earlier commit's) to a cubin with the flags
of `build.py` and `-Xptxas -v`, and disassembles it with `cuobjdump -sass`.
For every kernel it prints ptxas's registers, shared memory and spills, the
number of SASS instructions, and each loop (a backward branch) with the
address range and the instruction count of its body. `--out` also writes the
full SASS and a JSON summary there. Needs the CUDA toolkit (nvcc and
cuobjdump; Triton's package carries a cuobjdump too), not a card.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, List

from diner_tpu_torch.kernels.build import CSRC, NVCC_FLAGS, _nvcc

_PTXAS_ENTRY = re.compile(r"Compiling entry function '(\S+)'")
_PTXAS_PROPS = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores,"
                          r" (\d+) bytes spill loads")
_PTXAS_USED = re.compile(r"Used (\d+) registers(?:, used \d+ barriers)?"
                         r"(?:, (\d+) bytes smem)?")
_SASS_FUNC = re.compile(r"^\s*Function : (\S+)")
_SASS_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_BRANCH = re.compile(r"\bBRA\b[^;]*?(0x[0-9a-f]+)")


def _cuobjdump() -> str:
    found = shutil.which("cuobjdump")
    if found:
        return found
    nvcc_dir = Path(_nvcc()).parent
    if (nvcc_dir / "cuobjdump").exists():
        return str(nvcc_dir / "cuobjdump")
    import triton  # its package carries the toolkit's binary utilities
    path = Path(triton.__file__).parent / "backends" / "nvidia" / "bin"
    return str(path / "cuobjdump")


def parse_ptxas(log: str) -> Dict[str, dict]:
    """ptxas -v output -> {mangled kernel: {registers, smem, stack,
    spill_stores, spill_loads}}."""
    out, name = {}, None
    for line in log.splitlines():
        m = _PTXAS_ENTRY.search(line)
        if m:
            name = m.group(1)
            out[name] = {}
            continue
        if name is None:
            continue
        m = _PTXAS_PROPS.search(line)
        if m:
            out[name].update(stack=int(m.group(1)),
                             spill_stores=int(m.group(2)),
                             spill_loads=int(m.group(3)))
        m = _PTXAS_USED.search(line)
        if m:
            out[name].update(registers=int(m.group(1)),
                             smem=int(m.group(2) or 0))
    return out


def parse_sass(text: str) -> Dict[str, List[tuple]]:
    """cuobjdump -sass output -> {mangled kernel: [(address, instruction)]}."""
    funcs, cur = {}, None
    for line in text.splitlines():
        m = _SASS_FUNC.match(line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = _SASS_INSTR.search(line)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), m.group(2)))
    return funcs


def loops(instrs: List[tuple]) -> List[dict]:
    """Each backward branch as a loop: its body's address range and size."""
    found = []
    for addr, ins in instrs:
        m = _BRANCH.search(ins)
        if m and int(m.group(1), 16) <= addr:
            start = int(m.group(1), 16)
            body = [i for a, i in instrs if start <= a <= addr]
            found.append(dict(start=hex(start), end=hex(addr),
                              instructions=len(body),
                              mufu=sum(i.split()[0].startswith("MUFU")
                                       or " MUFU" in i for i in body)))
    return sorted(found, key=lambda d: d["instructions"])


def report(name: str, csrc: Path, workdir: Path) -> dict:
    cubin = workdir / f"{name}.cubin"
    flags = [f for f in NVCC_FLAGS if f not in ("-shared", "-Xcompiler",
                                                "-fPIC")]
    build = subprocess.run(
        [_nvcc(), *flags, "-cubin", "-Xptxas", "-v", "-o", str(cubin),
         str(csrc / f"{name}.cu")], capture_output=True, text=True)
    if build.returncode != 0:
        raise RuntimeError(f"nvcc failed for {csrc / name}.cu:\n"
                           f"{build.stderr}")
    sass = subprocess.run([_cuobjdump(), "-sass", str(cubin)],
                          capture_output=True, text=True, check=True).stdout
    ptxas = parse_ptxas(build.stdout + build.stderr)
    kernels = {}
    for func, instrs in parse_sass(sass).items():
        real = [i for _, i in instrs if not i.startswith("NOP")]
        kernels[func] = dict(ptxas.get(func, {}), instructions=len(real),
                             loops=loops(instrs))
    return dict(source=str(csrc / f"{name}.cu"), kernels=kernels, sass=sass)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("names", nargs="*")
    ap.add_argument("--csrc", default=str(CSRC))
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    csrc = Path(args.csrc)
    names = args.names or sorted(p.stem for p in csrc.glob("*.cu"))
    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name in names:
            results[name] = report(name, csrc, Path(tmp))
    for name, res in results.items():
        print(f"{res['source']}:")
        for func, k in res["kernels"].items():
            print(f"  {func}: {k.get('registers')} registers, "
                  f"{k.get('smem')} B static smem, {k.get('stack')} B stack, "
                  f"spills {k.get('spill_stores')}/{k.get('spill_loads')} B, "
                  f"{k['instructions']} SASS instructions")
            for lp in k["loops"]:
                print(f"    loop {lp['start']}-{lp['end']}: "
                      f"{lp['instructions']} instructions, {lp['mufu']} MUFU")
    if args.out:
        out = Path(args.out)
        out.mkdir(parents=True, exist_ok=True)
        for name, res in results.items():
            (out / f"{name}.sass").write_text(res.pop("sass"))
        (out / "sass.json").write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
