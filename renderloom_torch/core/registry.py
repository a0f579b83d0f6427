"""Name → factory registry.

Port of the JAX package's ``renderloom/core/registry.py``, which
replaces the reference's importlib-based dataset lookup
(``Human_Motion_Modelling/datasets/__init__.py:22-42``, duplicated in the
renderer package) and its ``"module::function"`` crop-function strings
(``Pose_Guided_Neural_Rendering/models/discriminator.py:88-91``) with one
explicit registry: no dynamic imports, every registered name is
greppable.  ``data/hsm.py:HsmReader`` registers as ``"hsm"`` and
``data/amass.py:AmassReader`` as ``"amass"`` in :data:`DATASETS`.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterator, Optional


class Registry:
    """A string → callable registry with decorator registration."""

    def __init__(self, name: str):
        self.name = name
        self._entries: Dict[str, Callable] = {}

    def register(self, name: Optional[str] = None) -> Callable:
        def wrapper(fn: Callable) -> Callable:
            key = name or fn.__name__
            if key in self._entries:
                raise KeyError(
                    f"{key!r} already registered in {self.name!r}")
            self._entries[key] = fn
            return fn

        return wrapper

    def get(self, name: str) -> Callable:
        try:
            return self._entries[name]
        except KeyError:
            known = ", ".join(sorted(self._entries))
            raise KeyError(
                f"{name!r} not found in registry {self.name!r}; "
                f"known: {known}") from None

    def __contains__(self, name: str) -> bool:
        return name in self._entries

    def __iter__(self) -> Iterator[str]:
        return iter(self._entries)


DATASETS = Registry("datasets")
MODELS = Registry("models")
CROP_FUNCS = Registry("crop_funcs")
