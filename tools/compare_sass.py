#!/usr/bin/env python3
"""Hold the SASS of each CUDA kernel of this checkout against another checkout's, on a machine with nvcc.

    python tools/compare_sass.py --repo DIR [--sources scl_decode.cu,pac_decode.cu]

Builds each source of this checkout's `csrc/` with this checkout's flags
and of DIR's `polar_code_tpu_torch/csrc/` with the `NVCC_FLAGS` of DIR's
own `_build.py`, as each checkout builds them (into this checkout's build
directory), dumps both libraries' SASS with
`cuobjdump -sass`, and prints, for every kernel function, "same" or the
count of SASS lines that differ position by position (each line carries
its address, so an instruction added early moves every line after it),
with its demangled name (a last template argument `float` dropped: the
float32 instantiations of the kernels templated on their float type keep
their untemplated names).  A kernel
whose SASS is the same in both runs the same instructions: a time that
differs between the two is the card's, not the code's.  Exits 1 when a
source fails to build or `cuobjdump` fails.
"""

import argparse
import ast
import re
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
ANON = re.compile(r"_GLOBAL__N__\w+")  # the anonymous namespace of one build
FLOAT_ARG = re.compile(r", float>$")


def functions(lib: Path) -> dict:
    """Demangled kernel name -> its SASS lines, from `cuobjdump -sass`; the
    anonymous namespace's name, which differs between two builds of one
    source, is taken out of every line, and each run of blanks is one
    blank (`cuobjdump` pads every line of a library to its longest
    instruction, so a kernel added to a source moves the others' columns)."""

    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True, check=True).stdout
    funcs, name = {}, None
    for line in out.splitlines():
        if "Function : " in line:
            name = line.split("Function : ", 1)[1].strip()
            funcs[name] = []
        elif name is not None and line.strip():
            funcs[name].append(" ".join(ANON.sub("_GLOBAL__N_", line).split()))
    # a template kernel by its name and arguments, without its parameters;
    # a float type argument `float` last is dropped, so that a kernel that
    # gained it (the float32 instantiation of a kernel templated on its
    # float type) is held against its checkout's untemplated twin
    return {FLOAT_ARG.sub(">", re.sub(r">\(.*\)$", ">", name)): body
            for name, body in zip(demangle(list(funcs)), funcs.values())}


def demangle(names):
    cxxfilt = shutil.which("cu++filt") or shutil.which("c++filt") or "/usr/local/cuda/bin/cu++filt"
    out = subprocess.run([cxxfilt], input="\n".join(names), capture_output=True, text=True, check=True)
    shown = out.stdout.splitlines()
    if len(shown) != len(names):
        raise RuntimeError(f"{cxxfilt} gave {len(shown)} names for {len(names)}")
    return shown


def their_flags(repo: Path) -> tuple:
    """The `NVCC_FLAGS` tuple of `repo`'s `polar_code_tpu_torch/_build.py`."""

    tree = ast.parse((repo / "polar_code_tpu_torch" / "_build.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(getattr(t, "id", None) == "NVCC_FLAGS" for t in node.targets):
            return tuple(ast.literal_eval(node.value))
    raise RuntimeError(f"no NVCC_FLAGS in {repo}'s _build.py")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repo", required=True, help="the other checkout")
    ap.add_argument("--sources", default="scl_decode.cu,pac_decode.cu")
    args = ap.parse_args()
    sys.path.insert(0, str(HERE))
    from polar_code_tpu_torch import _build

    repo = Path(args.repo).resolve()
    other = repo / "polar_code_tpu_torch" / "csrc"
    sources = args.sources.split(",")
    flags = their_flags(repo)
    print(f"{args.repo} built with {' '.join(flags)}", flush=True)
    jobs = [(s, c) for s in sources for c in (_build.CSRC, other)]

    def build(job):
        source, csrc = job
        if csrc == other and flags != _build.NVCC_FLAGS:
            lib = Path(_build.BUILD_DIR) / f"theirs_{Path(source).stem}.so"
            lib.parent.mkdir(parents=True, exist_ok=True)
            subprocess.run([_build._nvcc(), *flags, "-o", str(lib), str(csrc / source)], capture_output=True,
                           text=True, check=True)
            return lib
        return _build.build(source, csrc=csrc).path

    with ThreadPoolExecutor(max_workers=len(jobs)) as pool:  # every nvcc at once
        libs = dict(zip(jobs, pool.map(build, jobs)))
    for source in sources:
        mine = functions(libs[source, _build.CSRC])
        theirs = functions(libs[source, other])
        names = sorted(set(mine) | set(theirs))
        same = 0
        for name in names:
            if name not in mine or name not in theirs:
                print(f"  {source} {name}: only in {'this checkout' if name in mine else args.repo}")
                continue
            a, b = theirs[name], mine[name]
            diff = sum(x != y for x, y in zip(a, b)) + abs(len(a) - len(b))
            same += not diff
            print(f"  {source} {name}: {'same' if not diff else f'{diff} SASS lines differ'}")
        print(f"{source}: {same} of {len(names)} kernels with the same SASS as {args.repo}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
