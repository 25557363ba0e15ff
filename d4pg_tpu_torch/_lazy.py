"""PEP 562 lazy re-exports, shared by the package ``__init__``s (the port's
own copy of ``d4pg_tpu/_lazy.py``).

Keeps ``import d4pg_tpu_torch.envs`` free of torch until a name is touched:
spawned actor-pool workers import only the host env adapters and must
never pay for torch or the torch envs (``runtime/actor_pool.py``).
"""

from __future__ import annotations

import importlib
from typing import Callable, Mapping


def lazy_exports(
    module_name: str, exports: Mapping[str, str]
) -> tuple[Callable[[str], object], Callable[[], list[str]]]:
    """Build (``__getattr__``, ``__dir__``) for a module whose public names
    live in submodules. ``exports`` maps exported name → defining module."""

    def __getattr__(name: str):
        target = exports.get(name)
        if target is None:
            raise AttributeError(f"module {module_name!r} has no attribute {name!r}")
        return getattr(importlib.import_module(target), name)

    def __dir__() -> list[str]:
        return sorted(exports)

    return __getattr__, __dir__
