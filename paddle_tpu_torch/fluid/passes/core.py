"""Pass framework core: Pass base class, registry, pipeline.

Counterpart of ``paddle_tpu/fluid/passes/core.py``.  Passes rewrite the
Program/Block IR in place through the version-bumping Block mutators, so
the executor's run plan (keyed on the program version) can never serve a
stale op list; the pipeline enforces this.  Every pass run adds its
integer stats to ``pass.<name>.<stat>`` counters.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Type

from .. import trace

__all__ = ["Pass", "PassContext", "PassRegistry", "register_pass",
           "create_pass", "get_pass_names", "PassPipeline"]

IR_ASPECTS = frozenset({"ops", "attrs", "vars"})


class PassContext:
    """Per-application state shared by the passes of one pipeline run.
    ``targets`` are the fetch var names: the DCE seed and the protection
    set (a pass must never remove or re-alias a target's producer)."""

    def __init__(self, program, targets: Sequence[str] = ()):
        self.program = program
        self.targets = [str(t) for t in (targets or ())]
        self.stats: Dict[str, Dict[str, int]] = {}

    def is_protected(self, block, name: str) -> bool:
        """Vars a rewrite must keep producing under their own name:
        fetch targets, persistables (scope state), and data feeds."""
        if name in self.targets:
            return True
        v = block._find_var_recursive(name)
        return v is not None and (v.persistable or v.is_data)


class Pass:
    """Subclass, set ``name``, declare read/write sets, implement
    ``apply_block`` (or override ``apply``); return integer stats."""

    name: str = "pass"
    reads: frozenset = frozenset({"ops"})
    writes: frozenset = frozenset({"ops"})

    def __init__(self, **options):
        self.options = options
        bad = (set(self.reads) | set(self.writes)) - IR_ASPECTS
        if bad:
            raise ValueError(
                f"pass '{self.name}' declares unknown IR aspects {bad}; "
                f"valid: {sorted(IR_ASPECTS)}")

    def apply(self, program, ctx: PassContext) -> Dict[str, int]:
        stats: Dict[str, int] = {}
        for block in program.blocks:
            for k, v in (self.apply_block(block, ctx) or {}).items():
                stats[k] = stats.get(k, 0) + int(v)
        return stats

    def apply_block(self, block, ctx: PassContext) -> Dict[str, int]:
        return {}

    def __repr__(self):
        return f"{type(self).__name__}(name={self.name!r})"


class PassRegistry:
    """name -> Pass subclass map."""

    def __init__(self):
        self._passes: Dict[str, Type[Pass]] = {}

    def register(self, cls: Type[Pass]) -> Type[Pass]:
        name = cls.name
        if not name or name == "pass":
            raise ValueError(f"{cls.__name__} must set a unique `name`")
        if name in self._passes:
            raise ValueError(f"pass '{name}' already registered "
                             f"({self._passes[name].__name__})")
        self._passes[name] = cls
        return cls

    def get(self, name: str) -> Type[Pass]:
        if name not in self._passes:
            raise KeyError(
                f"no pass named '{name}' registered "
                f"(available: {sorted(self._passes)})")
        return self._passes[name]

    def create(self, name: str, **options) -> Pass:
        return self.get(name)(**options)

    def names(self) -> List[str]:
        return sorted(self._passes)


_registry = PassRegistry()


def register_pass(cls: Type[Pass]) -> Type[Pass]:
    """Class decorator: ``@register_pass`` above a Pass subclass."""
    return _registry.register(cls)


def create_pass(name: str, **options) -> Pass:
    return _registry.create(name, **options)


def get_pass_names() -> List[str]:
    return _registry.names()


def _n_ops(program) -> int:
    return sum(len(b.ops) for b in program.blocks)


class PassPipeline:
    """Ordered pass application with version enforcement and optional
    per-stage Graphviz dumps (``BuildStrategy.debug_graphviz_path``):
    ``NN_<label>.dot``, ``00_input`` then one a pass."""

    def __init__(self, passes: Sequence[Pass] = (),
                 graphviz_path: Optional[str] = None):
        self.passes: List[Pass] = list(passes)
        self.graphviz_path = graphviz_path or None

    def append(self, p: Pass) -> "PassPipeline":
        self.passes.append(p)
        return self

    def _dump(self, program, stage: int, label: str) -> None:
        if not self.graphviz_path:
            return
        from .graphviz import dump_program
        os.makedirs(self.graphviz_path, exist_ok=True)
        dump_program(program, os.path.join(
            self.graphviz_path, f"{stage:02d}_{label}.dot"))

    def apply(self, program, targets: Sequence[str] = ()
              ) -> Dict[str, Dict[str, int]]:
        """Run every pass over ``program``; returns {pass: stats}."""
        ctx = PassContext(program, targets=targets)
        self._dump(program, 0, "input")
        for i, p in enumerate(self.passes):
            v0, n0 = program._version, _n_ops(program)
            stats = dict(p.apply(program, ctx) or {})
            n1 = _n_ops(program)
            if not p.writes and program._version != v0:
                raise RuntimeError(
                    f"pass '{p.name}' declares an empty write set but "
                    f"bumped the program version ({v0} -> "
                    f"{program._version})")
            if n1 != n0 and program._version == v0:
                raise RuntimeError(
                    f"pass '{p.name}' changed the op count ({n0} -> {n1}) "
                    f"without bumping the program version; rewrites must "
                    f"go through the Block mutators")
            stats.setdefault("ops_removed", max(n0 - n1, 0))
            ctx.stats[p.name] = stats
            m = trace.metrics()
            for k, v in stats.items():
                if v:
                    m.counter(f"pass.{p.name}.{k}").inc(int(v))
            self._dump(program, i + 1, p.name)
        return ctx.stats
