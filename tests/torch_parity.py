"""Shared helpers of the parity tests between the JAX package and its
PyTorch port (tests/test_torch_*.py): the same seeded numpy inputs go to
both, and outputs are compared as numpy arrays."""

import ctypes
import functools
import importlib.util
import re
from pathlib import Path

import numpy as np
import torch

# The tier-1 run uses several xdist workers; keep each one's torch pool small.
torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]


@functools.cache
def jax_script(name):
    """experiments/<name>.py as a module (experiments/ is not a package)."""
    spec = importlib.util.spec_from_file_location(
        f"jax_experiment_{name}", REPO / "experiments" / f"{name}.py"
    )
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def interpreted(monkeypatch, name):
    """The JAX script ``name`` with its Pallas kernels in interpret mode for
    the rest of the test."""
    jm = jax_script(name)
    monkeypatch.setattr(jm.pl, "pallas_call",
                        functools.partial(jm.pl.pallas_call, interpret=True))
    return jm


def t(a) -> torch.Tensor:
    """A numpy (or JAX) array as a CPU torch tensor."""
    return torch.from_numpy(np.array(a))


def n(a) -> np.ndarray:
    """A torch tensor or JAX array as numpy."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def assert_close(got, want, rtol, atol=0.0):
    np.testing.assert_allclose(n(got), n(want), rtol=rtol, atol=atol)


def tsdf_like(shape, seed, warp_scale=0.8):
    """(canonical, live, warp) as numpy float32: TSDF-like fields in (-1, 1)
    and a ``(*shape, D)`` warp, as the JAX package's fused tests build them."""
    rng = np.random.default_rng(seed)
    base = rng.standard_normal(shape).astype(np.float32)
    canonical = np.tanh(base * 0.4)
    live = np.tanh(np.roll(base, 1, axis=0) * 0.4)
    warp = (rng.standard_normal(shape + (len(shape),)) * warp_scale).astype(np.float32)
    return canonical, live, warp


def c_prototype(source, name):
    """Kinds of the parameters of ``extern "C" ... name(...)`` in
    ``levelsetfusion_tpu_torch/csrc/<source>``: "pointer", "int" or "float"."""
    src = (REPO / "levelsetfusion_tpu_torch" / "csrc" / source).read_text()
    m = re.search(r'extern "C" [\w ]+\b' + name + r"\(([^)]*)\)", src)
    assert m, f"no prototype of {name} in {source}"
    kinds = []
    for param in m.group(1).split(","):
        words = param.split()
        kinds.append("pointer" if "*" in param else {"int": "int", "float": "float"}[words[0]])
    return kinds


def c_enum(source, name):
    """The enumerators of ``enum name { kA = 0, kB = 1, ... }`` in
    ``levelsetfusion_tpu_torch/csrc/<source>``, in value order, without
    their ``k``."""
    src = (REPO / "levelsetfusion_tpu_torch" / "csrc" / source).read_text()
    m = re.search(r"enum " + name + r" \{([^}]*)\}", src)
    assert m, f"no enum {name} in {source}"
    found = re.findall(r"\bk(\w+) = (\d+)", m.group(1))
    return [e for e, _ in sorted(found, key=lambda ev: int(ev[1]))]


def ctypes_kind(argtype):
    """The kind (as ``c_prototype`` names it) of a ctypes argument type."""
    if argtype is ctypes.c_void_p or issubclass(argtype, ctypes._Pointer):
        return "pointer"
    return {ctypes.c_int: "int", ctypes.c_float: "float"}[argtype]
