"""String-keyed registries for trainers and datasets.

The counterpart of ``mvlpt_tpu/utils/registry.py``: the registry
pattern of the reference's Dassl engine (trainers/mvlpt.py:9 via
TRAINER_REGISTRY, datasets/oxford_pets.py:11 via DATASET_REGISTRY), so
that ``--trainer MVLPT`` / ``DATASET.NAME OxfordPets`` dispatch works in
the port's CLI.
"""

from __future__ import annotations


class Registry:
    """A name -> class mapping with decorator-based registration."""

    def __init__(self, name: str):
        self._name = name
        self._obj_map: dict[str, type] = {}

    def register(self, obj=None, *, name: str | None = None):
        if obj is None:
            def deco(cls):
                return self.register(cls, name=name)
            return deco
        key = name or obj.__name__
        if key in self._obj_map:
            raise KeyError(f"{key!r} already registered in {self._name}")
        self._obj_map[key] = obj
        return obj

    def get(self, name: str):
        if name not in self._obj_map:
            known = ", ".join(sorted(self._obj_map))
            raise KeyError(f"{name!r} not found in registry {self._name}. Known: {known}")
        return self._obj_map[name]

    def registered_names(self):
        return sorted(self._obj_map)

    def __contains__(self, name: str) -> bool:
        return name in self._obj_map


TRAINER_REGISTRY = Registry("TRAINER")
DATASET_REGISTRY = Registry("DATASET")
