"""ConfigurationSpace: structured parameter spaces for the autotuner.

This is the ConfigSpace analog the paper builds its ``input_space`` from
(Sec. 4.1): categorical hyperparameters (pragma on/off choices), ordinal
hyperparameters (tile-size sequences), and algebraic conditions between them
(``CS.InCondition`` — e.g. "pack array B only when array A is packed").

Configurations are plain ``dict``s mapping parameter name -> value. Parameters
deactivated by an unsatisfied condition are *absent* from the dict; feature
encoding maps them to a dedicated "inactive" slot so surrogate models can learn
across the hierarchy.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Iterable, Mapping, Sequence

import numpy as np

__all__ = [
    "Categorical",
    "Ordinal",
    "Integer",
    "Float",
    "Constant",
    "EqualsCondition",
    "InCondition",
    "ForbiddenClause",
    "ConfigurationSpace",
    "config_key",
]


# ---------------------------------------------------------------------------
# Hyperparameter kinds
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Categorical:
    """Unordered finite choice (the paper's pragma-or-nothing parameters)."""

    name: str
    choices: tuple
    default: Any = None

    def __post_init__(self):
        object.__setattr__(self, "choices", tuple(self.choices))
        if len(set(self.choices)) != len(self.choices):
            raise ValueError(f"{self.name}: duplicate choices")
        if self.default is None:
            object.__setattr__(self, "default", self.choices[0])
        if self.default not in self.choices:
            raise ValueError(f"{self.name}: default {self.default!r} not a choice")

    @property
    def size(self) -> int:
        return len(self.choices)

    def sample(self, rng: np.random.Generator):
        return self.choices[int(rng.integers(len(self.choices)))]

    def sample_quantile(self, q: float):
        idx = min(int(q * len(self.choices)), len(self.choices) - 1)
        return self.choices[idx]

    def validate(self, value) -> bool:
        return value in self.choices

    # feature encoding: one-hot over choices (+1 inactive slot added by space)
    def n_features(self) -> int:
        return len(self.choices)

    def encode(self, value) -> np.ndarray:
        out = np.zeros(len(self.choices))
        out[self.choices.index(value)] = 1.0
        return out


@dataclasses.dataclass(frozen=True)
class Ordinal:
    """Ordered finite sequence (the paper's 11-entry tile-size lists)."""

    name: str
    sequence: tuple
    default: Any = None

    def __post_init__(self):
        object.__setattr__(self, "sequence", tuple(self.sequence))
        if len(set(self.sequence)) != len(self.sequence):
            raise ValueError(f"{self.name}: duplicate sequence entries")
        if self.default is None:
            object.__setattr__(self, "default", self.sequence[0])
        if self.default not in self.sequence:
            raise ValueError(f"{self.name}: default {self.default!r} not in sequence")

    @property
    def size(self) -> int:
        return len(self.sequence)

    def sample(self, rng: np.random.Generator):
        return self.sequence[int(rng.integers(len(self.sequence)))]

    def sample_quantile(self, q: float):
        idx = min(int(q * len(self.sequence)), len(self.sequence) - 1)
        return self.sequence[idx]

    def validate(self, value) -> bool:
        return value in self.sequence

    def n_features(self) -> int:
        return 1

    def encode(self, value) -> np.ndarray:
        # normalized rank keeps the *order* information (tile sizes are ordered)
        rank = self.sequence.index(value)
        return np.array([rank / max(len(self.sequence) - 1, 1)])


@dataclasses.dataclass(frozen=True)
class Integer:
    """Uniform (optionally log-uniform) integer range, inclusive bounds."""

    name: str
    low: int
    high: int
    default: int | None = None
    log: bool = False

    def __post_init__(self):
        if self.low > self.high:
            raise ValueError(f"{self.name}: low > high")
        if self.log and self.low <= 0:
            raise ValueError(f"{self.name}: log scale requires low > 0")
        if self.default is None:
            object.__setattr__(self, "default", self.low)
        if not (self.low <= self.default <= self.high):
            raise ValueError(f"{self.name}: default outside range")

    @property
    def size(self) -> int:
        return self.high - self.low + 1

    def sample(self, rng: np.random.Generator):
        if self.log:
            lo, hi = math.log(self.low), math.log(self.high + 1)
            return int(min(self.high, math.floor(math.exp(rng.uniform(lo, hi)))))
        return int(rng.integers(self.low, self.high + 1))

    def sample_quantile(self, q: float):
        if self.log:
            lo, hi = math.log(self.low), math.log(self.high + 1)
            return int(min(self.high, math.floor(math.exp(lo + q * (hi - lo)))))
        return int(min(self.high, self.low + math.floor(q * (self.high - self.low + 1))))

    def validate(self, value) -> bool:
        return isinstance(value, (int, np.integer)) and self.low <= value <= self.high

    def n_features(self) -> int:
        return 1

    def encode(self, value) -> np.ndarray:
        if self.log:
            lo, hi = math.log(self.low), math.log(self.high)
            x = (math.log(max(value, self.low)) - lo) / max(hi - lo, 1e-12)
        else:
            x = (value - self.low) / max(self.high - self.low, 1e-12)
        return np.array([x])


@dataclasses.dataclass(frozen=True)
class Float:
    """Uniform (optionally log-uniform) float range."""

    name: str
    low: float
    high: float
    default: float | None = None
    log: bool = False

    def __post_init__(self):
        if self.low > self.high:
            raise ValueError(f"{self.name}: low > high")
        if self.default is None:
            object.__setattr__(self, "default", self.low)

    @property
    def size(self) -> float:
        return math.inf

    def sample(self, rng: np.random.Generator):
        if self.log:
            return float(math.exp(rng.uniform(math.log(self.low), math.log(self.high))))
        return float(rng.uniform(self.low, self.high))

    def sample_quantile(self, q: float):
        if self.log:
            lo, hi = math.log(self.low), math.log(self.high)
            return float(math.exp(lo + q * (hi - lo)))
        return float(self.low + q * (self.high - self.low))

    def validate(self, value) -> bool:
        return self.low <= value <= self.high

    def n_features(self) -> int:
        return 1

    def encode(self, value) -> np.ndarray:
        if self.log:
            lo, hi = math.log(self.low), math.log(self.high)
            return np.array([(math.log(value) - lo) / max(hi - lo, 1e-12)])
        return np.array([(value - self.low) / max(self.high - self.low, 1e-12)])


@dataclasses.dataclass(frozen=True)
class Constant:
    name: str
    value: Any

    @property
    def default(self):
        return self.value

    @property
    def size(self) -> int:
        return 1

    def sample(self, rng):
        return self.value

    def sample_quantile(self, q):
        return self.value

    def validate(self, value) -> bool:
        return value == self.value

    def n_features(self) -> int:
        return 0

    def encode(self, value) -> np.ndarray:
        return np.zeros(0)


Hyperparameter = Categorical | Ordinal | Integer | Float | Constant


# ---------------------------------------------------------------------------
# Conditions & forbidden clauses
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class InCondition:
    """``child`` is active only when ``parent``'s value is in ``values``.

    Mirrors ``CS.InCondition`` from the paper's syr2k space: packing B is only
    considered when A is packed.
    """

    child: str
    parent: str
    values: tuple

    def __post_init__(self):
        object.__setattr__(self, "values", tuple(self.values))

    def satisfied(self, config: Mapping[str, Any]) -> bool:
        return config.get(self.parent) in self.values


def EqualsCondition(child: str, parent: str, value) -> InCondition:
    return InCondition(child, parent, (value,))


@dataclasses.dataclass(frozen=True)
class ForbiddenClause:
    """Reject configurations for which ``predicate(config)`` is True."""

    predicate: Callable[[Mapping[str, Any]], bool]
    description: str = ""

    def violated(self, config: Mapping[str, Any]) -> bool:
        return bool(self.predicate(config))


# ---------------------------------------------------------------------------
# ConfigurationSpace
# ---------------------------------------------------------------------------


def config_key(config: Mapping[str, Any]) -> tuple:
    """Canonical hashable identity of a configuration (for the perf DB)."""
    return tuple(sorted((k, repr(v)) for k, v in config.items()))


class ConfigurationSpace:
    """A structured space with conditional activation, seeded like the paper's
    ``CS.ConfigurationSpace(seed=1234)``."""

    def __init__(self, seed: int = 1234):
        self._params: dict[str, Hyperparameter] = {}
        self._conditions: list[InCondition] = []
        self._forbidden: list[ForbiddenClause] = []
        self._rng = np.random.default_rng(seed)
        self.seed = seed
        # structure caches (the sampler/encoder hot path walks these per
        # config): invalidated whenever a parameter or condition is added
        self._topo_cache: list[str] | None = None
        self._conds_for_cache: dict[str, list[InCondition]] | None = None
        self._sorted_names_cache: list[str] | None = None
        self._sample_plan_cache: list | None = None
        self._decl_sorted_cache: bool | None = None

    def _invalidate_structure_caches(self) -> None:
        self._topo_cache = None
        self._conds_for_cache = None
        self._sorted_names_cache = None
        self._sample_plan_cache = None
        self._decl_sorted_cache = None

    def _sorted_names(self) -> list[str]:
        if self._sorted_names_cache is None:
            self._sorted_names_cache = sorted(self._params)
        return self._sorted_names_cache

    def _decl_sorted(self) -> bool:
        if self._decl_sorted_cache is None:
            self._decl_sorted_cache = list(self._params) == self._sorted_names()
        return self._decl_sorted_cache

    def _sample_plan(self):
        """Per-parameter draw plan for the sampling hot path: finite choice
        sets (Categorical/Ordinal) inline to ``choices[int(rng.integers(n))]``
        — the identical call on the identical stream, minus the method
        dispatch — Constants skip the rng entirely (as their ``sample``
        does), and everything else keeps its ``sample`` method."""
        plan = self._sample_plan_cache
        if plan is None:
            plan = []
            for name, hp in self._params.items():
                if isinstance(hp, Categorical):
                    plan.append((name, 0, hp.choices))
                elif isinstance(hp, Ordinal):
                    plan.append((name, 0, hp.sequence))
                elif isinstance(hp, Constant):
                    plan.append((name, 1, hp.value))
                else:
                    plan.append((name, 2, hp.sample))
            self._sample_plan_cache = plan
        return plan

    def _draw_raw(self, rng: np.random.Generator) -> dict:
        """One full raw assignment, drawn parameter-by-parameter in
        declaration order — the exact RNG consumption of
        ``{n: hp.sample(rng) for n, hp in self._params.items()}``."""
        ri = rng.integers
        draws = {}
        for name, kind, data in self._sample_plan():
            if kind == 0:
                draws[name] = data[int(ri(len(data)))]
            elif kind == 1:
                draws[name] = data
            else:
                draws[name] = data(rng)
        return draws

    # -- construction -------------------------------------------------------

    def add_hyperparameter(self, hp: Hyperparameter) -> Hyperparameter:
        if hp.name in self._params:
            raise ValueError(f"duplicate hyperparameter {hp.name!r}")
        self._params[hp.name] = hp
        self._invalidate_structure_caches()
        return hp

    def add_hyperparameters(self, hps: Iterable[Hyperparameter]) -> None:
        for hp in hps:
            self.add_hyperparameter(hp)

    def add_condition(self, cond: InCondition) -> None:
        for ref in (cond.child, cond.parent):
            if ref not in self._params:
                raise ValueError(f"condition references unknown parameter {ref!r}")
        if cond.child == cond.parent:
            raise ValueError("self-condition")
        self._conditions.append(cond)
        self._invalidate_structure_caches()

    def add_forbidden(self, clause: ForbiddenClause) -> None:
        self._forbidden.append(clause)

    # -- introspection -------------------------------------------------------

    @property
    def param_names(self) -> list[str]:
        return list(self._params)

    def __getitem__(self, name: str) -> Hyperparameter:
        return self._params[name]

    def __len__(self) -> int:
        return len(self._params)

    def cardinality(self) -> float:
        """Total number of raw grid points (ignoring conditions), as the paper
        reports space sizes (e.g. 2*2*2*11*11*11 = 10,648 for syr2k)."""
        total = 1.0
        for hp in self._params.values():
            total *= hp.size
        return total

    def _conditions_for(self, name: str) -> list[InCondition]:
        cache = self._conds_for_cache
        if cache is None:
            cache = {n: [] for n in self._params}
            for c in self._conditions:
                cache[c.child].append(c)
            self._conds_for_cache = cache
        return cache[name]

    def _topo_order(self) -> list[str]:
        # parents before children so activation can be decided in one pass;
        # memoized — the sampler calls this once per drawn configuration
        if self._topo_cache is not None:
            return self._topo_cache
        order, seen = [], set()

        def visit(name: str, stack: tuple = ()):  # DFS over condition parents
            if name in seen:
                return
            if name in stack:
                raise ValueError(f"condition cycle at {name!r}")
            for c in self._conditions_for(name):
                visit(c.parent, stack + (name,))
            seen.add(name)
            order.append(name)

        for name in self._params:
            visit(name)
        self._topo_cache = order
        return order

    def active_params(self, config: Mapping[str, Any]) -> list[str]:
        """Names of parameters active under ``config``'s parent assignments."""
        active = []
        for name in self._topo_order():
            conds = self._conditions_for(name)
            if all(c.satisfied(config) for c in conds):
                active.append(name)
        return active

    def is_valid(self, config: Mapping[str, Any]) -> bool:
        try:
            self.validate(config)
            return True
        except ValueError:
            return False

    def validate(self, config: Mapping[str, Any]) -> None:
        active = set(self.active_params(config))
        for name in config:
            if name not in self._params:
                raise ValueError(f"unknown parameter {name!r}")
            if name not in active:
                raise ValueError(f"inactive parameter {name!r} present")
        for name in active:
            if name not in config:
                raise ValueError(f"active parameter {name!r} missing")
            if not self._params[name].validate(config[name]):
                raise ValueError(f"invalid value for {name!r}: {config[name]!r}")
        for clause in self._forbidden:
            if clause.violated(config):
                raise ValueError(f"forbidden: {clause.description or clause}")

    # -- sampling ------------------------------------------------------------

    def default_configuration(self) -> dict:
        cfg: dict[str, Any] = {}
        for name in self._topo_order():
            if all(c.satisfied(cfg) for c in self._conditions_for(name)):
                cfg[name] = self._params[name].default
        return dict(sorted(cfg.items()))

    def _finish(self, draws: Mapping[str, Any]) -> dict:
        """Apply conditional activation to a full raw assignment."""
        if not self._conditions:  # unconditional space: every draw is active
            if self._decl_sorted():
                # declaration order is already sorted: the draw dict IS the
                # finished config (same keys, same order)
                return draws if isinstance(draws, dict) else dict(draws)
            return {name: draws[name] for name in self._sorted_names()}
        cfg: dict[str, Any] = {}
        conds_for = self._conditions_for
        for name in self._topo_order():
            if all(c.satisfied(cfg) for c in conds_for(name)):
                cfg[name] = draws[name]
        return dict(sorted(cfg.items()))

    def sample_configuration(self, rng: np.random.Generator | None = None) -> dict:
        rng = rng or self._rng
        forbidden = self._forbidden
        for _ in range(1000):
            cfg = self._finish(self._draw_raw(rng))
            if not forbidden or not any(f.violated(cfg) for f in forbidden):
                return cfg
        raise RuntimeError("forbidden clauses reject every sampled configuration")

    def sample_configurations(self, n: int, rng: np.random.Generator | None = None) -> list[dict]:
        return [self.sample_configuration(rng) for _ in range(n)]

    def latin_hypercube(self, n: int, rng: np.random.Generator | None = None) -> list[dict]:
        """LHS initialization (the paper's alternative init sampler): one
        stratified quantile per parameter per sample, shuffled independently."""
        rng = rng or self._rng
        names = list(self._params)
        # stratified quantiles, independently permuted per dimension
        grid = {}
        for name in names:
            q = (np.arange(n) + rng.uniform(0.0, 1.0, size=n)) / n
            rng.shuffle(q)
            grid[name] = q
        out = []
        for i in range(n):
            draws = {n_: self._params[n_].sample_quantile(float(grid[n_][i])) for n_ in names}
            cfg = self._finish(draws)
            if any(f.violated(cfg) for f in self._forbidden):
                cfg = self.sample_configuration(rng)  # fall back for rare rejects
            out.append(cfg)
        return out

    # -- feature encoding (for surrogate models) ------------------------------

    def n_features(self) -> int:
        total = 0
        for name, hp in self._params.items():
            total += hp.n_features()
            if self._conditions_for(name):
                total += 1  # "inactive" indicator slot
        return total

    def encode(self, config: Mapping[str, Any]) -> np.ndarray:
        """Fixed-length numeric vector; inactive conditionals get a zero block
        plus an inactive-indicator 1."""
        parts = []
        for name, hp in self._params.items():
            conditional = bool(self._conditions_for(name))
            if name in config:
                parts.append(hp.encode(config[name]))
                if conditional:
                    parts.append(np.zeros(1))
            else:
                parts.append(np.zeros(hp.n_features()))
                if conditional:
                    parts.append(np.ones(1))
        return np.concatenate(parts) if parts else np.zeros(0)

    def encode_many(self, configs: Sequence[Mapping[str, Any]]) -> np.ndarray:
        """Batch feature encoding: one (n, n_features) array filled
        column-block by column-block per parameter, instead of n per-config
        ``encode`` calls each concatenating a dozen small arrays. Row values
        are identical to ``encode`` — the same per-element arithmetic, just
        applied across the batch (log-scaled parameters keep their scalar
        ``math.log`` path so not even the last ulp moves)."""
        n = len(configs)
        if not n:
            return np.zeros((0, self.n_features()))
        out = np.zeros((n, self.n_features()))
        col = 0
        for name, hp in self._params.items():
            w = hp.n_features()
            if w:
                present = np.fromiter((name in c for c in configs), bool, count=n)
                rows = np.flatnonzero(present)
                if len(rows):
                    vals = [configs[i][name] for i in rows]
                    if isinstance(hp, Categorical):
                        ch = hp.choices.index
                        out[rows, col + np.fromiter((ch(v) for v in vals),
                                                    np.int64, count=len(rows))] = 1.0
                    elif isinstance(hp, Ordinal):
                        sq = hp.sequence.index
                        ranks = np.fromiter((sq(v) for v in vals),
                                            np.float64, count=len(rows))
                        out[rows, col] = ranks / max(len(hp.sequence) - 1, 1)
                    elif isinstance(hp, (Integer, Float)) and not hp.log:
                        arr = np.fromiter(vals, np.float64, count=len(rows))
                        out[rows, col] = (arr - hp.low) / max(hp.high - hp.low, 1e-12)
                    else:  # log-scaled (math.log semantics) or exotic kinds
                        for i, v in zip(rows, vals):
                            out[i, col:col + w] = hp.encode(v)
            col += w
            if self._conditions_for(name):
                # inactive conditionals get their indicator slot set
                for i, c in enumerate(configs):
                    if name not in c:
                        out[i, col] = 1.0
                col += 1
        return out

    # -- neighborhood (for local perturbation in the search) ------------------

    def mutate(self, config: Mapping[str, Any], rng: np.random.Generator | None = None) -> dict:
        """Perturb one active parameter; re-resolve activation."""
        rng = rng or self._rng
        draws = self._draw_raw(rng)
        draws.update({k: v for k, v in config.items()})
        active = [n for n in config if self._params[n].size > 1]
        if active:
            victim = active[int(rng.integers(len(active)))]
            hp = self._params[victim]
            for _ in range(20):
                new = hp.sample(rng)
                if new != config.get(victim):
                    break
            draws[victim] = new
        cfg = self._finish(draws)
        if any(f.violated(cfg) for f in self._forbidden):
            return self.sample_configuration(rng)
        return cfg
