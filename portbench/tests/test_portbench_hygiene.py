"""A run writes only inside the checkout, its TMPDIR, HOME and
XDG_CACHE_HOME: every file or directory the Python side opens for writing,
makes or renames is held to those roots, with each of them a fresh
directory here. (Compilers started as processes write into the checkout's
``build/``, which the program's loaders fix.)"""

import builtins
import os
import tempfile
from pathlib import Path

import pytest

from tiny import cell, run

ROOT = Path(__file__).resolve().parents[2]
WORKLOADS = ("config3-pairs", "config4-disk", "config4-memory", "config5_512-4chip")


@pytest.mark.parametrize("workload", WORKLOADS)
@pytest.mark.parametrize("trace", [0, 1])
def test_run_writes_only_where_allowed(workload, trace, tmp_path, monkeypatch):
    roots = {name: tmp_path / name for name in ("tmp", "home", "cache")}
    for path in roots.values():
        path.mkdir()
    monkeypatch.setenv("TMPDIR", str(roots["tmp"]))
    monkeypatch.setenv("HOME", str(roots["home"]))
    monkeypatch.setenv("XDG_CACHE_HOME", str(roots["cache"]))
    monkeypatch.setattr(tempfile, "tempdir", None)
    written = []
    real_open, real_os_open = builtins.open, os.open
    real_mkdir, real_replace, real_rename = os.mkdir, os.replace, os.rename

    def spy_open(file, mode="r", *args, **kw):
        if isinstance(file, (str, bytes, os.PathLike)) and set(mode) & set("wax+"):
            written.append(file)
        return real_open(file, mode, *args, **kw)

    def spy_os_open(path, flags, *args, **kw):
        if flags & (os.O_WRONLY | os.O_RDWR | os.O_CREAT):
            written.append(path)
        return real_os_open(path, flags, *args, **kw)

    def spy_mkdir(path, *args, **kw):
        written.append(path)
        return real_mkdir(path, *args, **kw)

    def spy_move(real):
        def move(src, dst, *args, **kw):
            written.append(dst)
            return real(src, dst, *args, **kw)
        return move

    monkeypatch.setattr(builtins, "open", spy_open)
    monkeypatch.setattr(os, "open", spy_os_open)
    monkeypatch.setattr(os, "mkdir", spy_mkdir)
    monkeypatch.setattr(os, "replace", spy_move(real_replace))
    monkeypatch.setattr(os, "rename", spy_move(real_rename))
    line = run(cell(workload), trace=trace)
    assert line["correct"]
    allowed = [ROOT, *roots.values()]
    for path in written:
        p = Path(os.fsdecode(path)).resolve()
        if p == Path(os.devnull):
            continue
        assert any(p == a or a in p.parents for a in allowed), f"wrote {p}"
    if workload == "config4-disk":
        assert any(roots["tmp"] in Path(os.fsdecode(p)).resolve().parents for p in written)
