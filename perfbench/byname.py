"""Find a part of the benchmark by its name: ``<root>/perfbench/<folder>/<name>.py``.

Everything that belongs to one cell, mix, operation, action or metric is a
file of its own, so a new one is added as a file, never by an edit."""

from __future__ import annotations

import importlib.util
import pathlib

_LOADED: dict[pathlib.Path, object] = {}


def path(root: pathlib.Path, folder: str, name: str) -> pathlib.Path:
    return root / "perfbench" / folder / f"{name}.py"


def load(root: pathlib.Path, folder: str, name: str):
    """The module at ``path(root, folder, name)``, loaded once."""
    file = path(root, folder, name).resolve()
    if file not in _LOADED:
        if not file.is_file():
            raise LookupError(f"no {folder} named {name!r} (looked for {file})")
        spec = importlib.util.spec_from_file_location(f"perfbench_{folder}_{name}".replace(".", "_"), file)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        _LOADED[file] = module
    return _LOADED[file]
