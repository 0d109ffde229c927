"""The frozen JAX references of the port's tests (``tests/make_torch_refs.py``).

``test_frozen_round_trip`` holds the store's encoding (named tuples, dicts,
lists, None, integer and float leaves) and its three modes on a scratch
store.  ``test_frozen_references_match_trajopt_tpu`` (marked slow: it
compiles every JAX reference, minutes on a CPU) reruns every port test file
with ``TORCH_REFS=check``, which recomputes each reference from
``trajopt_tpu`` and requires it to equal the stored one to rounding."""

import collections
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import make_torch_refs as refs


def test_frozen_round_trip(tmp_path, monkeypatch):
    monkeypatch.setattr(refs, "REFS", tmp_path)
    monkeypatch.setattr(refs, "_stores", {})
    Pair = collections.namedtuple("Pair", ["a", "b"])
    value = {"p": Pair(np.arange(3.0), [np.int32(4), None]), "t": (np.eye(2), 1.5)}
    calls = []

    def compute():
        calls.append(1)
        return value

    monkeypatch.setenv("TORCH_REFS", "write")
    first = refs.frozen("test_x.py", "k/1", compute)
    assert (tmp_path / "test_x.npz").exists() and len(calls) == 1
    monkeypatch.setattr(refs, "_stores", {})
    monkeypatch.setenv("TORCH_REFS", "read")
    got = refs.frozen("test_x.py", "k/1", compute)
    assert len(calls) == 1                       # read from the store, not recomputed
    assert type(got["p"]).__name__ == "Pair" and got["p"]._fields == ("a", "b")
    np.testing.assert_array_equal(got["p"].a, np.arange(3.0))
    assert got["p"].b[1] is None and int(got["p"].b[0]) == 4 and float(got["t"][1]) == 1.5
    np.testing.assert_array_equal(got["t"][0], first["t"][0])
    monkeypatch.setenv("TORCH_REFS", "check")
    refs.frozen("test_x.py", "k/1", compute)
    with pytest.raises(AssertionError):
        refs.frozen("test_x.py", "k/1", lambda: {"p": Pair(np.arange(3.0) + 1e-6, [4, None]),
                                                 "t": (np.eye(2), 1.5)})
    with pytest.raises(AssertionError, match="no stored reference"):
        refs.frozen("test_x.py", "other", compute)


@pytest.mark.slow
def test_frozen_references_match_trajopt_tpu():
    here = Path(__file__).resolve().parent
    files = sorted(str(p) for p in here.glob("test_torch_*.py") if p.name != Path(__file__).name)
    env = dict(os.environ, TORCH_REFS="check", JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-m", "pytest", "-q", "-p", "no:xdist",
                          "-p", "no:cacheprovider", "-m", "not slow", *files],
                         env=env, cwd=here.parent, capture_output=True, text=True)
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-2000:]
