"""Component registry (port of oatx/config/registry.py): components register
under the names the JSON configs use, and a lookup of an unknown name raises a
KeyError that lists the registered ones."""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional


class Registry:
    def __init__(self, kind: str):
        self.kind = kind
        self._items: Dict[str, Any] = {}

    def register(self, name: Optional[str] = None) -> Callable:
        def deco(obj):
            key = name or obj.__name__
            if key in self._items:
                raise ValueError(f"{self.kind} {key!r} already registered")
            self._items[key] = obj
            return obj
        return deco

    def add(self, name: str, obj: Any) -> None:
        self._items[name] = obj

    def get(self, name: str) -> Any:
        try:
            return self._items[name]
        except KeyError:
            known = ", ".join(sorted(self._items)) or "<none>"
            raise KeyError(f"unknown {self.kind} {name!r}; registered: {known}") from None

    def __contains__(self, name: str) -> bool:
        return name in self._items

    def names(self):
        return sorted(self._items)


DATASETS = Registry("dataset")
METRICS = Registry("metric")
LOSSES = Registry("loss")


def _register_builtin_metrics():
    from oatx_torch.metrics import retrieval as R

    for fn in (R.t2v_metrics, R.v2t_metrics, R.retrieval_as_classification,
               R.mean_average_precision):
        if fn.__name__ not in METRICS:
            METRICS.add(fn.__name__, fn)


_register_builtin_metrics()
