"""String-keyed plugin registries of the port: ``EXECUTORS``,
``MODELS``, ``EVICT_POLICIES`` (store victim selection) and
``ADMISSIONS`` (store heat admission).

A copy of ``repro.api.registry.Registry``.  The port's registries are
its own: nothing here registers into ``repro``'s, so the two packages
can live in one process.  Built-in entries register where they are
defined (``core.ops``, ``core.gnn_models``, ``gnnserve.store``); this
module stays a leaf.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional


class Registry:
    """A named string -> object table with decorator registration."""

    def __init__(self, kind: str):
        self.kind = kind
        self._items: Dict[str, Any] = {}

    def register(self, name: str, obj: Optional[Any] = None,
                 *, overwrite: bool = False):
        """``register("name", obj)`` or ``@register("name")`` decorator.
        Re-registering an existing name requires ``overwrite=True``."""
        def _put(o):
            if not overwrite and name in self._items \
                    and self._items[name] is not o:
                raise ValueError(
                    f"{self.kind} {name!r} is already registered "
                    f"(pass overwrite=True to replace it)")
            self._items[name] = o
            return o
        if obj is None:
            return _put                     # decorator form
        return _put(obj)

    def unregister(self, name: str) -> None:
        self._items.pop(name, None)

    def get(self, name: str) -> Any:
        try:
            return self._items[name]
        except KeyError:
            raise KeyError(
                f"unknown {self.kind} {name!r}; registered: "
                f"{', '.join(self.names()) or '(none)'}") from None

    def names(self) -> List[str]:
        return sorted(self._items)

    def __contains__(self, name: str) -> bool:
        return name in self._items

    def __iter__(self):
        return iter(sorted(self._items))

    def __len__(self) -> int:
        return len(self._items)


EXECUTORS = Registry("executor")
MODELS = Registry("model")
EVICT_POLICIES = Registry("evict_policy")
ADMISSIONS = Registry("admission")


def register_executor(name: str, factory: Optional[Callable] = None, **kw):
    """Register an executor factory ``factory(device, **options) ->
    executor instance``."""
    return EXECUTORS.register(name, factory, **kw)


def register_model(name: str, plugin: Optional[Any] = None, **kw):
    """Register a model plugin: an object with ``init(gen, dims, heads)
    -> params`` and ``spec(params) -> core.gnn_models.ModelSpec``."""
    return MODELS.register(name, plugin, **kw)


def register_evict_policy(name: str, policy: Optional[Callable] = None,
                          **kw):
    """Register a store eviction policy ``policy(store, level) ->
    key_fn(shard) -> sortable``: the shard minimizing the key is
    evicted first when the level is over budget."""
    return EVICT_POLICIES.register(name, policy, **kw)


def register_admission(name: str, policy: Optional[Callable] = None, **kw):
    """Register a store admission policy ``policy(local_ids, admitted)
    -> heat weight``: how much heat a gather adds to a shard
    (``admitted`` is the recompute-admitted subset, or None)."""
    return ADMISSIONS.register(name, policy, **kw)
