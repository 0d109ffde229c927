"""Frozen float64 outputs of the JAX references of the port's tests, and the
script that writes them.

The port's tests (``tests/test_torch_*.py``) hold ``trajopt_torch`` to
``trajopt_tpu`` on seeded inputs.  Compiling and tracing the JAX references
(interpret-mode Pallas kernels, compiled solvers) is most of their time, and
the references cannot change: ``trajopt_tpu`` is frozen and the inputs come
from fixed seeds.  So each test computes its references through
:func:`frozen` (or the :func:`reference` decorator on the function that
computes them), which reads them from ``tests/torch_refs/<test file>.npz``:

    python tests/make_torch_refs.py [tests/test_torch_x.py ...]

recomputes every reference of the named port test files (all of them by
default) and stores it (``TORCH_REFS=write``); ``TORCH_REFS=check`` recomputes
each reference and requires it to equal the stored one to rounding, which
``tests/test_torch_refs.py`` (marked slow, outside tier-1) runs over every
file.  A key missing from the store is computed on the spot.

A reference is any nest of tuples, lists, dicts and named tuples of arrays;
it comes back with numpy leaves and named tuples of the same field names.
"""

from __future__ import annotations

import collections
import functools
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np

REFS = Path(__file__).resolve().parent / "torch_refs"
# recomputed references must equal the stored ones to rounding: the same
# code on the same inputs, compiled by another XLA build or on another CPU
CHECK_TOL = dict(rtol=1e-9, atol=1e-12)

_stores: dict[str, dict] = {}
_types: dict[tuple, type] = {}


def _mode() -> str:
    mode = os.environ.get("TORCH_REFS", "read")
    if mode not in ("read", "write", "check"):
        raise ValueError(f"TORCH_REFS={mode!r}: expected read, write or check")
    return mode


def _encode(obj, arrays: list):
    if hasattr(obj, "_fields"):
        return {"nt": type(obj).__name__, "f": list(obj._fields),
                "v": [_encode(x, arrays) for x in obj]}
    if isinstance(obj, (tuple, list)):
        return {"t" if isinstance(obj, tuple) else "l": [_encode(x, arrays) for x in obj]}
    if isinstance(obj, dict):
        return {"d": {str(k): _encode(v, arrays) for k, v in obj.items()}}
    if obj is None:
        return {"n": 0}
    arrays.append(np.asarray(obj))
    return {"a": len(arrays) - 1}


def _decode(tree, arrays):
    if "nt" in tree:
        key = (tree["nt"], tuple(tree["f"]))
        cls = _types.get(key)
        if cls is None:
            cls = _types[key] = collections.namedtuple(tree["nt"], tree["f"])
        return cls(*(_decode(x, arrays) for x in tree["v"]))
    if "t" in tree:
        return tuple(_decode(x, arrays) for x in tree["t"])
    if "l" in tree:
        return [_decode(x, arrays) for x in tree["l"]]
    if "d" in tree:
        return {k: _decode(v, arrays) for k, v in tree["d"].items()}
    if "n" in tree:
        return None
    return arrays[tree["a"]]


def _store(name: str) -> dict:
    """key -> (tree, arrays) of one test file's stored references."""
    if name not in _stores:
        store = {}
        path = REFS / f"{name}.npz"
        if path.exists():
            with np.load(path) as z:
                for k in z.files:
                    if k.startswith("tree:"):
                        key = k[len("tree:"):]
                        tree = json.loads(str(z[k]))
                        arrays = [z[f"a:{key}:{i}"] for i in range(tree["count"])]
                        store[key] = (tree["tree"], arrays)
        _stores[name] = store
    return _stores[name]


def _write(name: str) -> None:
    REFS.mkdir(exist_ok=True)
    out = {}
    for key, (tree, arrays) in sorted(_store(name).items()):
        out[f"tree:{key}"] = np.array(json.dumps({"tree": tree, "count": len(arrays)}))
        for i, a in enumerate(arrays):
            out[f"a:{key}:{i}"] = a
    np.savez_compressed(REFS / f"{name}.npz", **out)


def _compare(key: str, tree, arrays, want_tree, want_arrays) -> None:
    if tree != want_tree or len(arrays) != len(want_arrays):
        raise AssertionError(f"{key}: the recomputed reference has another structure")
    for i, (a, b) in enumerate(zip(arrays, want_arrays)):
        if a.dtype.kind in "biu" or b.dtype.kind in "biu":
            np.testing.assert_array_equal(a, b, err_msg=f"{key}: leaf {i}")
        else:
            np.testing.assert_allclose(a, b, err_msg=f"{key}: leaf {i}", equal_nan=True,
                                       **CHECK_TOL)


def frozen(test_file: str, key: str, compute):
    """The reference ``compute()`` of ``test_file`` under ``key``: stored, or
    recomputed as ``TORCH_REFS`` says."""
    name = Path(test_file).stem
    key = re.sub(r"[^A-Za-z0-9_.=+-]", "_", key)
    store = _store(name)
    mode = _mode()
    if mode == "read" and key in store:
        return _decode(*store[key])
    arrays: list = []
    tree = _encode(compute(), arrays)
    if mode == "check":
        if key not in store:
            raise AssertionError(f"{name}: no stored reference {key!r}")
        _compare(key, tree, arrays, *store[key])
    elif mode == "write":
        store[key] = (tree, arrays)
        _write(name)
    return _decode(tree, arrays)


def reference(test_file: str):
    """Decorate a function of hashable arguments that computes a reference:
    its result is :func:`frozen` under the function's name and arguments."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args):
            key = "-".join([fn.__name__, *(str(a) for a in args)])
            return frozen(test_file, key, lambda: fn(*args))
        return wrapper
    return deco


def main(argv: list[str]) -> int:
    """Recompute and store every reference of the named test files (default:
    every ``tests/test_torch_*.py``) by running them with ``TORCH_REFS=write``."""
    here = Path(__file__).resolve().parent
    files = argv or sorted(str(p) for p in here.glob("test_torch_*.py")
                           if p.name != "test_torch_refs.py")
    for f in files:
        (REFS / f"{Path(f).stem}.npz").unlink(missing_ok=True)
    env = dict(os.environ, TORCH_REFS="write", JAX_PLATFORMS="cpu")
    cmd = [sys.executable, "-m", "pytest", "-q", "-p", "no:xdist", "-p", "no:cacheprovider",
           "-m", "not slow", *files]
    return subprocess.call(cmd, env=env, cwd=here.parent)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
