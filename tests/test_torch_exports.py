"""The port's package surface against the JAX package's.

* Every JAX package `__init__` export has its counterpart in the port's
  twin package, under the renames below, and the modules given a scalar
  surface export every name their JAX twins export.
* Every module of `polar_code_tpu/` has a twin path in the port, apart
  from the Pallas kernels' wrappers, whose twins wrap the CUDA kernels.
* `import polar_code_tpu_torch` (its sub-packages and lazy exports
  included) builds and loads no kernel library.
"""

import importlib
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
# JAX name → the port's name
RENAMES = {
    "decode_scl_pallas": "decode_scl_cuda",  # the CUDA kernel K1 takes the Pallas kernel's place
    "make_key": "make_generator",  # jax.random keys → torch.Generator seeds
    "fold_key": "fold_seed",
}
# JAX exports with no twin, by design (ROADMAP §3): one process drives one
# card, so there is no device list to build a mesh over
ABSENT = {
    "polar_code_tpu.parallel": {"frames_mesh", "local_mesh_devices"},
}
# JAX modules whose twin has another path: the Pallas TPU kernels' wrappers
# are replaced by the wrappers of the hand-written CUDA kernels
TWIN_PATHS = {
    "ops/scl_pallas.py": "ops/scl_cuda.py",
    "nr/ldpc/nms_pallas.py": "nr/ldpc/nms_cuda.py",
    "legacy/pac_pallas.py": "legacy/pac_cuda.py",
}
SCALAR_MODULES = ["ops.crc", "ops.sc", "polar.api", "dlscl.flip", "nr.ldpc.encode",
                  "nr.ldpc.decode_nms", "nr.polar.scl_nr", "legacy.polar_code",
                  "legacy.functions", "legacy.exceptions"]


def jax_packages():
    root = REPO / "polar_code_tpu"
    return sorted(".".join(("polar_code_tpu",) + p.parent.relative_to(root).parts)
                  for p in root.rglob("__init__.py"))


@pytest.mark.parametrize("package", jax_packages())
def test_package_exports_have_their_counterparts(package):
    theirs = importlib.import_module(package)
    ours = importlib.import_module(package.replace("polar_code_tpu", "polar_code_tpu_torch", 1))
    want = [RENAMES.get(name, name) for name in getattr(theirs, "__all__", [])
            if name not in ABSENT.get(package, set())]
    missing = [name for name in want if name not in getattr(ours, "__all__", [])
               or not hasattr(ours, name)]
    assert not missing, f"{ours.__name__} lacks {missing}"


@pytest.mark.parametrize("module", SCALAR_MODULES)
def test_scalar_modules_export_the_jax_names(module):
    theirs = importlib.import_module(f"polar_code_tpu.{module}")
    ours = importlib.import_module(f"polar_code_tpu_torch.{module}")
    assert set(theirs.__all__) <= set(ours.__all__), sorted(set(theirs.__all__) - set(ours.__all__))
    for name in theirs.__all__:
        assert hasattr(ours, name), name


def test_every_jax_module_has_a_twin_path():
    root, port = REPO / "polar_code_tpu", REPO / "polar_code_tpu_torch"
    for path in sorted(root.rglob("*.py")):
        rel = path.relative_to(root).as_posix()
        twin = TWIN_PATHS.get(rel, rel)
        assert (port / twin).is_file(), f"{rel} has no twin ({twin})"
    for rel, twin in TWIN_PATHS.items():
        assert (root / rel).is_file() and rel.endswith("_pallas.py") and twin.endswith("_cuda.py")


def test_import_loads_no_kernel_library():
    code = (
        "import ctypes, importlib, pkgutil, sys\n"
        "import torch\n"  # torch's own libraries load first
        "loaded = []\n"
        "init = ctypes.CDLL.__init__\n"
        "def record(self, name, *args, **kwargs):\n"
        "    loaded.append(str(name))\n"
        "    init(self, name, *args, **kwargs)\n"
        "ctypes.CDLL.__init__ = record\n"
        "import polar_code_tpu_torch as p\n"
        "for name in p.__all__:\n"
        "    getattr(p, name)\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "print(p.__version__, loaded)\n"
        "sys.exit(1 if loaded else 0)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
                         cwd=REPO)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.strip() == "0.1.0 []"
