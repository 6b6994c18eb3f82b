"""Finds the benchmark's files by name.

Every configuration, cell, traffic mix, per-layer metric and kernel family
is a file of its own under ``portbench/<kind>/``, found by the name that
``BENCHMARK.json`` or a cell gives it. A later change adds a file and edits
none. ``extra`` roots are searched first; the tests use them to drop
throwaway files beside the real ones.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import Iterable, List, Sequence

ROOT = Path(__file__).resolve().parents[1]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def roots(extra: Sequence[Path] = ()) -> List[Path]:
    return [Path(p) for p in extra] + [ROOT]


def find(kind: str, name: str, suffix: str, extra: Sequence[Path] = ()) -> Path:
    if not NAME.match(name):
        raise ValueError(f"bad {kind} name {name!r}")
    for root in roots(extra):
        path = root / kind / f"{name}{suffix}"
        if path.is_file():
            return path
    raise FileNotFoundError(f"no {kind} named {name!r} (looked for {kind}/{name}{suffix})")


def load_json(kind: str, name: str, extra: Sequence[Path] = ()) -> dict:
    return json.loads(find(kind, name, ".json", extra).read_text())


def load_module(kind: str, name: str, extra: Sequence[Path] = ()) -> ModuleType:
    """The Python file ``<kind>/<name>.py`` as a module of its own (names may
    hold dots, so it is loaded by path)."""
    path = find(kind, name, ".py", extra)
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_{re.sub(r'[^A-Za-z0-9_]', '_', name)}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def names(kind: str, suffix: str, extra: Sequence[Path] = ()) -> List[str]:
    """Every name of ``kind`` with files ending in ``suffix``, the extra
    roots' first where two roots hold one name."""
    found = {}
    for root in roots(extra):
        for path in sorted((root / kind).glob(f"*{suffix}")):
            found.setdefault(path.name[: -len(suffix)], path)
    return sorted(n for n in found if NAME.match(n))


def iter_modules(kind: str, extra: Sequence[Path] = ()) -> Iterable[tuple]:
    for n in names(kind, ".py", extra):
        yield n, load_module(kind, n, extra)
