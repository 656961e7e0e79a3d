"""Strategy / reducer registry: names → plan functions & reducer factories.

The paper's design variable — WHICH dependency structure the scheduler
sees — used to live as ``if/elif`` control flow inside ``sync_grads``.
Here it becomes data: a strategy is a pure

    plan(bucket_plan: BucketPlan, *, skip_names=frozenset()) -> CommSchedule

function registered under a name, and a reducer is a factory

    factory(mesh_shape: dict[str, int], *, mean_axes=()) -> Reducer

returning the per-bucket collective.  Everything that used to hardcode
``("funnel", "concom", "depcha")`` — CLI ``choices=``, benchmark sweeps,
``GradSync`` dispatch — now derives from this registry, so adding a
strategy is one decorated function (see ``priority``/``rsag`` in
``repro_torch.core.strategies``), not an edit to core control flow.
This is ``repro/core/registry.py`` unchanged: it is pure Python, and the
port keeps its own copy rather than import the reference.

Per-strategy behavior that used to be name-string special cases is
declared as metadata on registration:

  uses_in_scan  — leaves already reduced inside the backward scan
                  (the reference's ``core/overlap.py``) are dropped from
                  the schedule (depcha).
  deferred_pull — KVStore semantics: ``push`` only stages the buffer,
                  ``pull`` performs the reduction (depcha's decoupled
                  batches, paper Fig 10).
  two_phase     — KVStore semantics: ``push`` emits the reduce-scatter,
                  ``pull`` the all-gather (rsag).
  single_chain  — all keys share ONE dependency chain (funnel).
  meta          — the plan delegates to other registered strategies
                  (``auto``: picks by simulation).  Meta plans accept an
                  extra ``context`` mapping (mesh_shape / reducer / …)
                  that GradSync supplies, and are excluded from candidate
                  enumeration (``fixed_strategy_names``) so they can
                  never delegate to themselves.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable


@dataclasses.dataclass(frozen=True)
class StrategyInfo:
    name: str
    plan: Callable[..., Any]     # (BucketPlan, *, skip_names) -> CommSchedule
    uses_in_scan: bool = False
    deferred_pull: bool = False
    two_phase: bool = False
    single_chain: bool = False
    meta: bool = False
    doc: str = ""


_STRATEGIES: dict[str, StrategyInfo] = {}
_REDUCERS: dict[str, Callable[..., Any]] = {}


def register_strategy(
    name: str,
    *,
    uses_in_scan: bool = False,
    deferred_pull: bool = False,
    two_phase: bool = False,
    single_chain: bool = False,
    meta: bool = False,
    doc: str = "",
    override: bool = False,
) -> Callable:
    """Decorator: register ``plan`` under ``name`` with its metadata."""

    def deco(plan: Callable) -> Callable:
        if name in _STRATEGIES and not override:
            raise ValueError(f"strategy {name!r} already registered")
        _STRATEGIES[name] = StrategyInfo(
            name=name, plan=plan, uses_in_scan=uses_in_scan,
            deferred_pull=deferred_pull, two_phase=two_phase,
            single_chain=single_chain, meta=meta,
            doc=doc or (plan.__doc__ or "").strip().split("\n")[0])
        return plan

    return deco


def register_reducer(name: str, *, override: bool = False) -> Callable:
    """Decorator: register a reducer factory under ``name``."""

    def deco(factory: Callable) -> Callable:
        if name in _REDUCERS and not override:
            raise ValueError(f"reducer {name!r} already registered")
        _REDUCERS[name] = factory
        return factory

    return deco


def get_strategy(name: str) -> StrategyInfo:
    try:
        return _STRATEGIES[name]
    except KeyError:
        raise ValueError(
            f"unknown strategy {name!r}, want one of {strategy_names()}"
        ) from None


def get_reducer(name: str) -> Callable[..., Any]:
    try:
        return _REDUCERS[name]
    except KeyError:
        raise ValueError(
            f"unknown reducer {name!r}, want one of {reducer_names()}"
        ) from None


def strategy_names() -> tuple[str, ...]:
    """Registered strategy names, in registration order (builtins first)."""
    return tuple(_STRATEGIES)


def fixed_strategy_names() -> tuple[str, ...]:
    """Strategies that plan a concrete schedule themselves — the candidate
    set meta strategies (``auto``) choose from."""
    return tuple(n for n, s in _STRATEGIES.items() if not s.meta)


def reducer_names() -> tuple[str, ...]:
    return tuple(_REDUCERS)
