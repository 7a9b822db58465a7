"""The paper's four supervised learners, implemented from scratch on numpy.

ytopt (via scikit-optimize) offers Random Forests (RF, the default), Extra
Trees (ET), Gradient-Boosted Regression Trees (GBRT), and Gaussian Processes
(GP) as Bayesian-optimization surrogates. No sklearn is used in this repo,
so we implement the four models directly; each exposes

    fit(X, y)                      X: (n, d) float array, y: (n,)
    predict(X) -> (mu, sigma)      per-point mean and uncertainty

Uncertainty sources mirror scikit-optimize's choices:
  * RF / ET  — spread across ensemble members,
  * GBRT     — three quantile-loss ensembles (0.16 / 0.50 / 0.84),
  * GP       — exact posterior variance (RBF kernel + noise, Cholesky).

The fit/predict hot path is vectorized — CART splits are found with a
per-feature argsort + prefix-sum SSE scan, fitted trees flatten into
``(feature, threshold, left, right, value)`` arrays so whole candidate pools
route through iterative level-wise gathers, and the GP supports incremental
Cholesky extension across ``tell``s — while staying bit-identical (trees) or
within fp tolerance (GP) to the straightforward recursive reference (see
tests/test_surrogate_parity.py).
"""

from __future__ import annotations

import dataclasses

import numpy as np

try:  # scipy ships with jax; fall back to dense solves without it
    from scipy.linalg import solve_triangular as _scipy_solve_triangular

    def _solve_lower(L, b):
        return _scipy_solve_triangular(L, b, lower=True, check_finite=False)

    def _solve_lower_t(L, b):
        return _scipy_solve_triangular(L, b, lower=True, trans="T",
                                       check_finite=False)
except ImportError:  # pragma: no cover - scipy is a jax dependency
    def _solve_lower(L, b):
        return np.linalg.solve(L, b)

    def _solve_lower_t(L, b):
        return np.linalg.solve(L.T, b)

__all__ = [
    "RegressionTree",
    "RandomForest",
    "ExtraTrees",
    "GradientBoostedTrees",
    "GaussianProcess",
    "make_learner",
    "LEARNERS",
]


# ---------------------------------------------------------------------------
# CART regression tree (variance-reduction splits)
# ---------------------------------------------------------------------------


_LINSPACE32_CACHE: dict[int, np.ndarray] = {}


def _linspace32(m: int) -> np.ndarray:
    """Memoized ``np.linspace(0, m-1, 32).astype(int)`` (the threshold-scan
    cap): identical indices, no per-node linspace allocation."""
    sel = _LINSPACE32_CACHE.get(m)
    if sel is None:
        sel = _LINSPACE32_CACHE[m] = np.linspace(0, m - 1, 32).astype(int)
    return sel


def _is_const_target(y: np.ndarray) -> bool:
    """``np.allclose(y, y[0])`` with the isclose machinery stripped: the
    identical |y - y0| <= atol + rtol*|y0| test for finite pivots (every BO
    objective — failures are capped upstream), falling back to allclose on a
    non-finite pivot."""
    y0 = y[0]
    if np.isfinite(y0):
        return bool((np.abs(y - y0) <= 1e-8 + 1e-5 * abs(y0)).all())
    return bool(np.allclose(y, y0))


@dataclasses.dataclass
class _Node:
    feature: int = -1
    threshold: float = 0.0
    left: "_Node | None" = None
    right: "_Node | None" = None
    value: float = 0.0
    is_leaf: bool = True


@dataclasses.dataclass
class _FlatTree:
    """A fitted tree as arrays: node ``i`` routes rows with
    ``x[feature[i]] <= threshold[i]`` to ``left[i]`` else ``right[i]``;
    ``feature[i] == -1`` marks a leaf holding ``value[i]``."""

    feature: np.ndarray    # (m,) int32, -1 at leaves
    threshold: np.ndarray  # (m,) float64
    left: np.ndarray       # (m,) int32
    right: np.ndarray      # (m,) int32
    value: np.ndarray      # (m,) float64
    depth: int             # deepest internal node + 1: bounds the gather loop


def _flatten_tree(root: _Node) -> _FlatTree:
    nodes: list[_Node] = []
    depths: list[int] = []

    def visit(node: _Node, depth: int) -> int:
        i = len(nodes)
        nodes.append(node)
        depths.append(depth)
        return i

    # preorder with explicit child back-patching
    feature, threshold, left, right, value = [], [], [], [], []
    stack = [(root, 0, -1, False)]  # (node, depth, parent index, is_right)
    while stack:
        node, depth, parent, is_right = stack.pop()
        i = visit(node, depth)
        if parent >= 0:
            (right if is_right else left)[parent] = i
        feature.append(-1 if node.is_leaf else node.feature)
        threshold.append(node.threshold)
        left.append(i)   # leaves self-loop, halting their rows' traversal
        right.append(i)
        value.append(node.value)
        if not node.is_leaf:
            stack.append((node.right, depth + 1, i, True))
            stack.append((node.left, depth + 1, i, False))
    return _FlatTree(
        feature=np.asarray(feature, np.int32),
        threshold=np.asarray(threshold, np.float64),
        left=np.asarray(left, np.int32),
        right=np.asarray(right, np.int32),
        value=np.asarray(value, np.float64),
        depth=max((d for d, f in zip(depths, feature) if f >= 0), default=-1) + 1,
    )


def _levelwise_gather(feature, threshold, left, right, value, depth, idx, X):
    """Iterative tree traversal shared by single-tree and ensemble predict:
    rows advance one level per step via masked gathers, applying the same
    ``x <= threshold`` comparison a recursive walk would (bit-identical
    routing; leaves self-loop so finished rows just hold position).
    ``idx`` carries the starting node per slot and is broadcast against the
    trailing row axis of ``X``."""
    rows = np.arange(len(X)).reshape((1,) * (idx.ndim - 1) + (-1,))
    for _ in range(depth):
        f = feature[idx]
        live = f >= 0
        if not live.any():
            break
        xv = X[rows, np.where(live, f, 0)]
        go_left = xv <= threshold[idx]
        idx = np.where(live, np.where(go_left, left[idx], right[idx]), idx)
    return value[idx]


class _FlatEnsemble:
    """All of an ensemble's trees concatenated into one flat node table, so
    ``predict_matrix`` routes every (tree, row) pair through one iterative
    level-wise gather loop instead of per-row Python recursion."""

    def __init__(self, trees: "list[RegressionTree]"):
        flats = [t.flat() for t in trees]
        sizes = np.array([len(f.feature) for f in flats])
        offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int32)
        self.roots = offsets
        self.feature = np.concatenate([f.feature for f in flats])
        self.threshold = np.concatenate([f.threshold for f in flats])
        self.left = np.concatenate([f.left + o for f, o in zip(flats, offsets)])
        self.right = np.concatenate([f.right + o for f, o in zip(flats, offsets)])
        self.value = np.concatenate([f.value for f in flats])
        self.depth = max((f.depth for f in flats), default=0)

    def predict_matrix(self, X: np.ndarray) -> np.ndarray:
        """(T, n) member predictions, bit-identical to stacking per-tree
        recursive descents."""
        X = np.asarray(X, dtype=np.float64)
        idx = np.repeat(self.roots[:, None], len(X), axis=1)  # (T, n)
        return _levelwise_gather(self.feature, self.threshold, self.left,
                                 self.right, self.value, self.depth, idx, X)


class RegressionTree:
    """CART with MSE (variance-reduction) splits.

    ``splitter='best'`` scans candidate thresholds per feature (RF / GBRT);
    ``splitter='random'`` draws one uniform threshold per feature (Extra Trees).

    The split search is one vectorized pass: per tried feature, an argsort +
    prefix-sum scan scores every candidate threshold at once. Prefix-sum SSE
    drifts from the reference ``nl*var(yl) + nr*var(yr)`` by a few ulps, so
    every candidate within a small tolerance of the scan minimum is re-scored
    with the exact reference arithmetic, in reference iteration order — the
    selected (feature, threshold) is bit-identical to the nested-loop
    implementation, including tie-breaking and RNG consumption order.
    """

    # rescore everything within this relative band of the scan minimum; the
    # actual prefix-sum drift is ~n*eps (<=1e-13 rel at tuning scale), so the
    # band is ~1e5x generous and usually holds 1-2 candidates
    _RESCORE_RTOL = 1e-8

    def __init__(
        self,
        max_depth: int = 12,
        min_samples_split: int = 2,
        min_samples_leaf: int = 1,
        max_features: float | str | None = None,
        splitter: str = "best",
        rng: np.random.Generator | None = None,
    ):
        self.max_depth = max_depth
        self.min_samples_split = min_samples_split
        self.min_samples_leaf = min_samples_leaf
        self.max_features = max_features
        self.splitter = splitter
        self.rng = rng or np.random.default_rng(0)
        self.root: _Node | None = None
        self._flat: _FlatTree | None = None

    # -- fitting --------------------------------------------------------------

    def _n_features_to_try(self, d: int) -> int:
        mf = self.max_features
        if mf is None or mf == 1.0:
            return d
        if mf == "sqrt":
            return max(1, int(np.sqrt(d)))
        if mf == "log2":
            return max(1, int(np.log2(d))) if d > 1 else 1
        if isinstance(mf, float):
            return max(1, int(mf * d))
        return d

    def fit(self, X: np.ndarray, y: np.ndarray) -> "RegressionTree":
        X = np.asarray(X, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        self.root = self._build(X, y, np.arange(len(y)), depth=0)
        self._flat = None
        return self

    def _find_best_split(self, Xf, y, feats):
        """Vectorized argmin over all (feature, threshold) candidates in the
        node-local feature matrix ``Xf`` (rows = node samples, columns =
        tried features in permuted order). Returns ``(feature, threshold,
        left-mask)`` or None.

        One argsort + prefix-sum pass scores every threshold of every tried
        feature — candidate midpoints, left-counts, and uniqueness all derive
        from the sorted matrix, and every (feature, threshold) pair is scored
        in one flat array expression (no per-feature Python loop). The
        'random' splitter's uniform draws are one vectorized call over the
        non-constant features — numpy Generators fill array draws in the same
        stream order as sequential scalar draws, so RNG consumption matches
        the reference loop exactly."""
        n = len(y)
        msl = self.min_samples_leaf
        F = Xf.shape[1]
        order = np.argsort(Xf, axis=0, kind="stable")
        cols = np.arange(F)
        Xs = Xf[order, cols]                                # per-column sorted
        ys = y[order]
        cs1 = np.cumsum(ys, axis=0)
        cs2 = np.cumsum(ys * ys, axis=0)
        t1 = cs1[-1]
        t2 = cs2[-1]

        if self.splitter == "random":
            nonconst = np.flatnonzero(Xs[0] != Xs[-1])
            if len(nonconst) == 0:
                return None
            # one draw per non-constant feature, in feature order — the same
            # values the reference's per-feature scalar draws produce
            th = self.rng.uniform(Xs[0, nonconst], Xs[-1, nonconst])
            cand_col = nonconst
            # |{x <= t}|, the exact semantics of the reference mask count
            nl = (Xs[:, nonconst] <= th).sum(axis=0)
        else:
            neq = Xs[1:] != Xs[:-1]                         # (n-1, F)
            # flat candidates in reference order: feature-major, ascending
            # threshold (nonzero on the transpose walks columns in order)
            cand_col, bnd = np.nonzero(neq.T)
            if len(bnd) == 0:
                return None  # all tried features constant
            th = (Xs[bnd + 1, cand_col] + Xs[bnd, cand_col]) / 2.0  # midpoints
            # left-count per candidate: the cumulative count of its lower
            # unique value — except when the fp midpoint rounds onto the
            # upper unique value, where ``col <= t`` swallows that group too
            # (same-column next boundary, or n at the column's last candidate)
            nxt = np.empty(len(bnd), np.int64)
            nxt[-1] = n
            same = cand_col[1:] == cand_col[:-1]
            nxt[:-1] = np.where(same, bnd[1:] + 1, n)
            nl = np.where(th == Xs[bnd + 1, cand_col], nxt, bnd + 1)
            per_col = np.bincount(cand_col, minlength=F)
            if per_col.max() > 32:  # cap threshold scan; plenty at tuning scale
                keep = np.ones(len(bnd), bool)
                start = 0
                for j, c in enumerate(per_col):
                    if c > 32:
                        keep[start:start + c] = False
                        keep[start + _linspace32(int(c))] = True
                    start += c
                cand_col, th, nl = cand_col[keep], th[keep], nl[keep]

        nr = n - nl
        last = nl - 1  # nl >= 1 always: the smallest value is a left row
        s1 = cs1[last, cand_col]
        s2 = cs2[last, cand_col]
        # nr == 0 (threshold at/above the max) is masked below; max(nr, 1)
        # only keeps the division from warning on those masked slots
        sse = (s2 - s1 * s1 / nl) + ((t2[cand_col] - s2)
                                     - (t1[cand_col] - s1) ** 2 / np.maximum(nr, 1))
        sse[(nl < msl) | (nr < msl)] = np.inf
        vmin = sse.min()
        if not np.isfinite(vmin):
            return None

        # prefix-sum SSE drifts from the reference ``nl*var(yl) + nr*var(yr)``
        # by a few ulps: gather every candidate within the tolerance band of
        # the scan minimum (the flat order IS reference iteration order) and,
        # only when there is more than one, re-score them with the exact
        # reference arithmetic so strict-< tie-breaking picks the identical
        # winner
        scale = abs(float(t2[0])) + float(t1[0]) ** 2 / n + 1.0
        near = np.flatnonzero(sse <= vmin + self._RESCORE_RTOL * scale)
        if len(near) == 1:
            j, t = int(cand_col[near[0]]), float(th[near[0]])
        else:
            # identical partitions score bitwise-identically and strict-<
            # keeps the first, so only the first candidate per distinct
            # left-mask needs the reference var-scoring
            seen: list[np.ndarray] = []
            best = None
            for ci in near:
                j_c = int(cand_col[ci])
                t_c = float(th[ci])
                mask = Xf[:, j_c] <= t_c
                if any(np.array_equal(mask, m) for m in seen):
                    continue
                seen.append(mask)
                nl_e = int(mask.sum())
                nr_e = n - nl_e
                if nl_e < msl or nr_e < msl:
                    continue
                yl, yr = y[mask], y[~mask]
                score = nl_e * yl.var() + nr_e * yr.var()  # SSE up to constants
                if best is None or score < best[0]:
                    best = (score, j_c, t_c)
            if best is None:
                return None
            _, j, t = best
        return int(feats[j]), t, Xf[:, j] <= t

    def _build(self, X: np.ndarray, y: np.ndarray, idx: np.ndarray,
               depth: int) -> _Node:
        """Recursive CART over the rows ``idx`` of the full (X, y): children
        partition the index array instead of copying full-width data slices.
        Row order inside ``idx`` matches what boolean-mask slicing would
        produce, so every reduction sees the reference element order."""
        yn = y[idx]
        node = _Node(value=float(yn.mean()), is_leaf=True)
        n = len(idx)
        if (
            depth >= self.max_depth
            or n < self.min_samples_split
            or n < 2 * self.min_samples_leaf
            or _is_const_target(yn)
        ):
            return node

        d = X.shape[1]
        feats = self.rng.permutation(d)[: self._n_features_to_try(d)]
        split = self._find_best_split(X[np.ix_(idx, feats)], yn, feats)
        if split is None:
            return node
        f, t, mask = split
        node.is_leaf = False
        node.feature = f
        node.threshold = t
        node.left = self._build(X, y, idx[mask], depth + 1)
        node.right = self._build(X, y, idx[~mask], depth + 1)
        return node

    # -- prediction -------------------------------------------------------------

    def flat(self) -> _FlatTree:
        if self._flat is None:
            self._flat = _flatten_tree(self.root)
        return self._flat

    def invalidate_flat(self) -> None:
        """Leaf values were mutated in place (GBRT requantile): drop the
        cached array form so the next predict re-flattens."""
        self._flat = None

    def predict(self, X: np.ndarray) -> np.ndarray:
        X = np.asarray(X, dtype=np.float64)
        flat = self.flat()
        return _levelwise_gather(flat.feature, flat.threshold, flat.left,
                                 flat.right, flat.value, flat.depth,
                                 np.zeros(len(X), np.int32), X)


# ---------------------------------------------------------------------------
# Lockstep forest fitting: many independent trees, one numpy stream
# ---------------------------------------------------------------------------
#
# A single CART build is a sequential chain — each node's RNG draw and split
# depend on its parent's outcome, in DFS order — so per-node work cannot be
# batched *within* a tree without changing RNG consumption. But ensemble
# members are mutually independent (each owns its Generator), so T trees can
# advance in lockstep: every round pops one DFS node per tree and fuses all
# popped nodes' split searches into flat segmented array ops (one lexsort,
# two cumsums, one SSE expression for every (node, feature, threshold)
# candidate of the round). Per-tree draws still happen at node-visit time in
# exact DFS order, and all result-bearing reductions (leaf means, rescores)
# run per node with the reference arithmetic, so every tree is bit-identical
# to RegressionTree.fit on the same data and rng — only wall-clock changes.


class _LockstepForest:
    def __init__(self, X, y, prototype: "RegressionTree"):
        self.X = np.asarray(X, dtype=np.float64)
        self.y = np.asarray(y, dtype=np.float64)
        p = prototype
        self.max_depth = p.max_depth
        self.mss = p.min_samples_split
        self.msl = p.min_samples_leaf
        self.splitter = p.splitter
        self.n_try = p._n_features_to_try(self.X.shape[1])
        self.rescore_rtol = p._RESCORE_RTOL

    def fit(self, roots: "list[np.ndarray]", rngs: "list") -> "list[_FlatTree]":
        """Fit one tree per (root row-index set, rng); returns the trees
        directly in array (:class:`_FlatTree`) form — no ``_Node`` objects or
        post-hoc flattening on this path. Row indices address the shared X/y
        (bootstrap duplicates are plain repeated indices)."""
        X, y = self.X, self.y
        d = X.shape[1]
        F = self.n_try
        msl, mss = self.msl, self.mss
        T = len(roots)
        # per-tree flat node tables, appended in creation order (traversal
        # does not care about node ordering, only about link indices)
        feat = [[] for _ in range(T)]
        thr = [[] for _ in range(T)]
        left = [[] for _ in range(T)]
        right = [[] for _ in range(T)]
        val = [[] for _ in range(T)]
        maxdep = [0] * T

        def leaf_value(vals: np.ndarray) -> float:
            # pairwise-summation mean is sequential below 3 elements: the
            # scalar path is bit-identical and skips the numpy dispatch
            k = len(vals)
            if k == 1:
                return float(vals[0])
            if k == 2:
                return (float(vals[0]) + float(vals[1])) / 2.0
            return float(vals.mean())

        def add_node(t, parent, is_right, f, tval, v) -> int:
            i = len(feat[t])
            feat[t].append(f)
            thr[t].append(tval)
            left[t].append(i)   # self-loop; split nodes are re-linked below
            right[t].append(i)
            val[t].append(v)
            if parent >= 0:
                (right[t] if is_right else left[t])[parent] = i
            return i

        # DFS stacks: (parent index, is_right, row-idx, depth); popping
        # left-first reproduces the recursive preorder, so per-tree rng
        # draws line up exactly with the reference recursion. Roots get the
        # same trivial-leaf screen children get at push time.
        stacks = [[] for _ in range(T)]
        for t, r in enumerate(roots):
            r = np.asarray(r)
            if self.max_depth <= 0 or len(r) < mss or len(r) < 2 * msl:
                add_node(t, -1, False, -1, 0.0, leaf_value(y[r]))
            else:
                stacks[t].append((-1, False, r, 0))
        live = list(range(T))
        while live:
            # -- phase A: one batch-needing node per tree; trivial leaves
            # (depth/size bounds) were resolved at push time, so each pop is
            # a node that at least needs the constant-target check
            cand = []  # [t, parent, is_right, idx, depth]
            next_live = []
            for t in live:
                stack = stacks[t]
                if stack:
                    cand.append(stack.pop())
                    ct = cand[-1]
                    cand[-1] = [t, ct[0], ct[1], ct[2], ct[3]]
                if stack or cand and cand[-1][0] == t:
                    next_live.append(t)
            live = next_live
            if not cand:
                continue

            # -- phase B: batched constant-target check (exact
            # _is_const_target semantics; reduceat of booleans is order-free)
            sizes = np.array([len(c[3]) for c in cand])
            starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
            rows = np.concatenate([c[3] for c in cand])
            yn = y[rows]
            y0 = yn[starts]
            if np.isfinite(y0).all():
                ok = np.abs(yn - np.repeat(y0, sizes)) <= \
                    1e-8 + 1e-5 * np.repeat(np.abs(y0), sizes)
                const = np.logical_and.reduceat(ok, starts)
            else:  # pragma: no cover - capped objectives are always finite
                const = np.array([_is_const_target(yn[s:s + z])
                                  for s, z in zip(starts, sizes)])
            keep = []
            for b, c in enumerate(cand):
                if const[b]:
                    t, parent, is_right, idx, _ = c
                    add_node(t, parent, is_right, -1, 0.0,
                             leaf_value(yn[starts[b]:starts[b] + sizes[b]]))
                else:
                    keep.append(c)
            if not keep:
                continue
            if len(keep) != len(cand):
                sizes = np.array([len(c[3]) for c in keep])
                starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
                rows = np.concatenate([c[3] for c in keep])
                yn = y[rows]

            # -- phase C: per-node feature draws, tree-local rng, DFS order
            feats = np.stack([rngs[c[0]].permutation(d)[:F] for c in keep])

            # -- phase D: one fused split search for every popped node
            splits = self._batched_split(rows, yn, sizes, starts, feats,
                                         [rngs[c[0]] for c in keep])

            # -- phase E: attach winners, push children (right below left);
            # children that are leaves by the depth/size bounds alone are
            # attached immediately instead of round-tripping the stack
            for b, c in enumerate(keep):
                t, parent, is_right, idx, depth = c
                win = splits[b]
                if win is None:
                    add_node(t, parent, is_right, -1, 0.0,
                             leaf_value(yn[starts[b]:starts[b] + sizes[b]]))
                    continue
                f_local, tval, mask = win
                i = add_node(t, parent, is_right, int(feats[b, f_local]),
                             float(tval), 0.0)
                cdep = depth + 1
                if cdep > maxdep[t]:
                    maxdep[t] = cdep
                for child_right, cidx in ((True, idx[~mask]), (False, idx[mask])):
                    n_c = len(cidx)
                    if cdep >= self.max_depth or n_c < mss or n_c < 2 * msl:
                        add_node(t, i, child_right, -1, 0.0, leaf_value(y[cidx]))
                    else:
                        stacks[t].append((i, child_right, cidx, cdep))
        return [
            _FlatTree(
                feature=np.asarray(feat[t], np.int32),
                threshold=np.asarray(thr[t], np.float64),
                left=np.asarray(left[t], np.int32),
                right=np.asarray(right[t], np.int32),
                value=np.asarray(val[t], np.float64),
                depth=maxdep[t],
            )
            for t in range(T)
        ]

    def _batched_split(self, rows, yn, sizes, starts, feats, node_rngs):
        """Flat segmented version of RegressionTree._find_best_split for B
        nodes at once. Returns per node ``(local feature, threshold, mask)``
        or None. SSE values are ranking-only (global cumsums drift a few more
        ulps than per-node ones); winners within the tolerance band are
        re-scored per node with the exact reference arithmetic.

        NOTE: this deliberately mirrors RegressionTree._find_best_split —
        the midpoint-collision left-count fix, 32-candidate cap, rescore
        band, and mask-dedup must stay bit-synchronized between the two (the
        single-tree path still exists because GBRT's leaf requantile needs
        the _Node form); tests/test_surrogate_parity.py pins both against
        the same reference."""
        X = self.X
        B, F = feats.shape
        msl = self.msl
        Xf = X[rows[:, None], np.repeat(feats, sizes, axis=0)]   # (R, F)

        if self.splitter == "random":
            cand = self._random_candidates(Xf, yn, sizes, starts, node_rngs)
        else:
            cand = self._best_candidates(Xf, yn, sizes)
        if cand is None:
            return [None] * B
        cand_b, cand_j, th, nl, s1, s2, t1c, t2c, nall, scale = cand

        nr = nall - nl
        sse = (s2 - s1 * s1 / nl) + ((t2c - s2)
                                     - (t1c - s1) ** 2
                                     / np.maximum(nr, 1))
        sse[(nl < msl) | (nr < msl)] = np.inf
        bounds = np.searchsorted(cand_b, np.arange(B + 1))
        out = []
        for b in range(B):
            lo_i, hi_i = int(bounds[b]), int(bounds[b + 1])
            if hi_i == lo_i:
                out.append(None)
                continue
            sse_b = sse[lo_i:hi_i]
            vmin = sse_b.min()
            if not np.isfinite(vmin):
                out.append(None)
                continue
            near = np.flatnonzero(sse_b <= vmin + self.rescore_rtol * scale[b])
            s0, n_b = starts[b], sizes[b]
            Xf_b = Xf[s0:s0 + n_b]
            if len(near) == 1:
                ci = lo_i + near[0]
                j = int(cand_j[ci])
                t = float(th[ci])
                out.append((j, t, Xf_b[:, j] <= t))
            else:
                y_b = yn[s0:s0 + n_b]
                # near-ties are usually the *same partition* reached through
                # different features (complementary one-hot columns): their
                # exact scores are bitwise equal, and strict-< keeps the
                # first, so only the first candidate per distinct left-mask
                # ever needs the reference var-scoring
                seen: list[np.ndarray] = []
                best = None
                for ci in lo_i + near:
                    j_c = int(cand_j[ci])
                    t_c = float(th[ci])
                    mask = Xf_b[:, j_c] <= t_c
                    if any(np.array_equal(mask, m) for m in seen):
                        continue
                    seen.append(mask)
                    nl_e = int(mask.sum())
                    nr_e = n_b - nl_e
                    if nl_e < msl or nr_e < msl:
                        continue
                    yl, yr = y_b[mask], y_b[~mask]
                    score = nl_e * yl.var() + nr_e * yr.var()
                    if best is None or score < best[0]:
                        best = (score, j_c, t_c)
                if best is None:
                    out.append(None)
                else:
                    _, j, t = best
                    out.append((j, t, Xf_b[:, j] <= t))
        return out

    def _best_candidates(self, Xf, yn, sizes):
        """Candidate arrays for the 'best' splitter: every (node, column)
        group is sorted and every unique-value boundary scored. Returns
        ``(cand_b, cand_j, th, nl, s1, s2, t1, t2, n, scale)`` per candidate
        (node totals broadcast per candidate; ``scale`` per node) or None."""
        B = len(sizes)
        F = Xf.shape[1]
        seg = np.repeat(np.arange(B), sizes)
        segcol = (seg[:, None] * F + np.arange(F)).ravel()       # C-order
        vals = Xf.ravel()
        yrep = np.repeat(yn, F)
        perm = np.lexsort((vals, segcol))  # stable: group, value, position
        vs = vals[perm]
        ysrt = yrep[perm]
        cs1 = np.cumsum(ysrt)
        cs2 = np.cumsum(ysrt * ysrt)
        gsizes = np.repeat(sizes, F)                 # per (node, col) group
        gstarts = np.concatenate([[0], np.cumsum(gsizes)[:-1]])
        gends = gstarts + gsizes - 1
        prev1 = np.where(gstarts > 0, cs1[gstarts - 1], 0.0)
        prev2 = np.where(gstarts > 0, cs2[gstarts - 1], 0.0)
        t1g = cs1[gends] - prev1
        t2g = cs2[gends] - prev2
        nseg = np.repeat(sizes, F)                   # node size per group

        bm = vs[1:] != vs[:-1]
        bm[gstarts[1:] - 1] = False              # kill cross-group edges
        cand_pos = np.nonzero(bm)[0]
        if len(cand_pos) == 0:
            return None
        cand_group = segcol[perm[cand_pos]]
        th = (vs[cand_pos + 1] + vs[cand_pos]) / 2.0
        base = cand_pos + 1 - gstarts[cand_group]
        nxt = np.empty(len(base), np.int64)
        nxt[-1] = nseg[cand_group[-1]]
        same = cand_group[1:] == cand_group[:-1]
        nxt[:-1] = np.where(same, base[1:], nseg[cand_group[:-1]])
        # fp midpoints that round onto the upper unique value swallow
        # that group too, exactly like the reference's ``col <= t`` mask
        nl = np.where(th == vs[cand_pos + 1], nxt, base)
        percol = np.bincount(cand_group, minlength=B * F)
        if percol.max() > 32:  # cap threshold scan per feature
            keepm = np.ones(len(th), bool)
            s = 0
            for g, c in enumerate(percol):
                if c > 32:
                    keepm[s:s + c] = False
                    keepm[s + _linspace32(int(c))] = True
                s += c
            cand_group, th, nl = cand_group[keepm], th[keepm], nl[keepm]

        s1 = cs1[gstarts[cand_group] + nl - 1] - prev1[cand_group]
        s2 = cs2[gstarts[cand_group] + nl - 1] - prev2[cand_group]
        cand_b = cand_group // F
        cand_j = cand_group - cand_b * F
        # per-node tolerance band from the node's first tried column
        scale = np.abs(t2g[::F]) + t1g[::F] ** 2 / sizes + 1.0
        return (cand_b, cand_j, th, nl, s1, s2,
                t1g[cand_group], t2g[cand_group], nseg[cand_group], scale)

    def _random_candidates(self, Xf, yn, sizes, starts, node_rngs):
        """Candidate arrays for the 'random' splitter (ET), with the
        nonsplittable-column prefilter: a column constant within its node can
        never split it, yet ET's all-features policy (max_features=1.0)
        previously dragged every such column through the segmented sort,
        keeping per-round arrays ~4x wider than RF's. Per-(node, column)
        min/max — the same values as the sorted first/last elements — screen
        dead columns out first, so only splittable groups are sorted and
        scanned. Draw values, draw order, and candidate order are unchanged:
        the reference draws one uniform per non-constant column in column
        order, and nonconst detection via min != max is exact."""
        B = len(sizes)
        F = Xf.shape[1]
        lo = np.minimum.reduceat(Xf, starts, axis=0)             # (B, F)
        hi = np.maximum.reduceat(Xf, starts, axis=0)
        live = lo != hi
        th_rows = []
        for b in range(B):
            nc = np.flatnonzero(live[b])
            if len(nc):
                # vectorized draw == the reference's sequential scalars
                th_rows.append(node_rngs[b].uniform(lo[b, nc], hi[b, nc]))
        kept = np.flatnonzero(live.ravel())          # live (node, col) groups
        if len(kept) == 0:
            return None
        th = np.concatenate(th_rows)
        cand_b = kept // F
        cand_j = kept - cand_b * F
        gsz = sizes[cand_b]
        gstarts = np.concatenate([[0], np.cumsum(gsz)[:-1]])
        gends = gstarts + gsz - 1
        srow = np.repeat(starts[cand_b], gsz) + \
            (np.arange(int(gsz.sum())) - np.repeat(gstarts, gsz))
        vals = Xf[srow, np.repeat(cand_j, gsz)]
        seg = np.repeat(np.arange(len(kept)), gsz)
        perm = np.lexsort((vals, seg))  # stable: group, value, position
        vs = vals[perm]
        ysrt = yn[srow][perm]
        cs1 = np.cumsum(ysrt)
        cs2 = np.cumsum(ysrt * ysrt)
        prev1 = np.where(gstarts > 0, cs1[gstarts - 1], 0.0)
        prev2 = np.where(gstarts > 0, cs2[gstarts - 1], 0.0)
        # |{x <= t}| per group: boolean reduceat is an exact count
        nl = np.add.reduceat(vs <= np.repeat(th, gsz), gstarts, dtype=np.int64)
        s1 = cs1[gstarts + nl - 1] - prev1
        s2 = cs2[gstarts + nl - 1] - prev2
        t1c = cs1[gends] - prev1
        t2c = cs2[gends] - prev2
        # per-node tolerance scale over the node's own rows (ranking-only,
        # like the sse values: the rescore band absorbs summation-order ulps)
        t1n = np.add.reduceat(yn, starts)
        t2n = np.add.reduceat(yn * yn, starts)
        scale = np.abs(t2n) + t1n * t1n / sizes + 1.0
        return cand_b, cand_j, th, nl, s1, s2, t1c, t2c, gsz, scale


# ---------------------------------------------------------------------------
# Random Forest / Extra Trees
# ---------------------------------------------------------------------------


class RandomForest:
    """Bagged CART ensemble; sigma = std across member predictions."""

    name = "RF"
    bootstrap = True
    splitter = "best"
    max_features: float | str = "sqrt"

    def __init__(self, n_estimators: int = 32, max_depth: int = 12, seed: int = 0,
                 min_samples_leaf: int = 1):
        self.n_estimators = n_estimators
        self.max_depth = max_depth
        self.min_samples_leaf = min_samples_leaf
        self.rng = np.random.default_rng(seed)
        self.trees: list[RegressionTree] = []
        self._ens: _FlatEnsemble | None = None

    def fit(self, X: np.ndarray, y: np.ndarray):
        X = np.asarray(X, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        n = len(X)
        self.trees = []
        self._ens = None
        # draw every tree's bootstrap rows and generator seed first, in the
        # exact order the sequential loop consumed the ensemble rng, then let
        # the lockstep engine advance all trees at once (each tree's own rng
        # is still consumed at node-visit time in DFS order)
        roots, rngs = [], []
        for _ in range(self.n_estimators):
            if self.bootstrap:
                idx = self.rng.integers(0, n, size=n)
            else:
                idx = np.arange(n)
            tree = RegressionTree(
                max_depth=self.max_depth,
                max_features=self.max_features,
                splitter=self.splitter,
                min_samples_leaf=self.min_samples_leaf,
                rng=np.random.default_rng(int(self.rng.integers(2**31))),
            )
            roots.append(idx)
            rngs.append(tree.rng)
            self.trees.append(tree)
        engine = _LockstepForest(X, y, self.trees[0])
        for tree, flat in zip(self.trees, engine.fit(roots, rngs)):
            tree.root = None  # array-form only on the ensemble path
            tree._flat = flat
        return self

    def _ensemble(self) -> _FlatEnsemble:
        if self._ens is None:
            self._ens = _FlatEnsemble(self.trees)
        return self._ens

    def predict(self, X: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        preds = self._ensemble().predict_matrix(X)  # (T, n)
        mu = preds.mean(axis=0)
        sigma = preds.std(axis=0) + 1e-9
        return mu, sigma


class ExtraTrees(RandomForest):
    """Extremely-randomized trees: no bootstrap, random split thresholds."""

    name = "ET"
    bootstrap = False
    splitter = "random"
    max_features = 1.0


# ---------------------------------------------------------------------------
# Gradient-boosted regression trees with quantile loss
# ---------------------------------------------------------------------------


class _QuantileGBT:
    """One boosted ensemble minimizing pinball loss at quantile ``alpha``."""

    def __init__(self, alpha: float, n_estimators: int, lr: float, max_depth: int, seed: int):
        self.alpha = alpha
        self.n_estimators = n_estimators
        self.lr = lr
        self.max_depth = max_depth
        self.rng = np.random.default_rng(seed)
        self.base = 0.0
        self.trees: list[RegressionTree] = []
        self._ens: _FlatEnsemble | None = None

    def fit(self, X, y):
        self.base = float(np.quantile(y, self.alpha))
        pred = np.full(len(y), self.base)
        self.trees = []
        self._ens = None
        for _ in range(self.n_estimators):
            resid = y - pred
            # negative gradient of pinball loss
            grad = np.where(resid > 0, self.alpha, self.alpha - 1.0)
            tree = RegressionTree(
                max_depth=self.max_depth,
                rng=np.random.default_rng(int(self.rng.integers(2**31))),
            )
            tree.fit(X, grad)
            # line-search-free step (standard GBM-with-quantile shortcut):
            # refit leaf values to the quantile of residuals they cover
            self._requantile_leaves(tree.root, X, resid, np.arange(len(y)))
            tree.invalidate_flat()
            step = tree.predict(X)
            pred = pred + self.lr * step
            self.trees.append(tree)
        return self

    def _requantile_leaves(self, node: _Node, X, resid, idx):
        if node.is_leaf:
            node.value = float(np.quantile(resid[idx], self.alpha)) if len(idx) else 0.0
            return
        mask = X[idx, node.feature] <= node.threshold
        self._requantile_leaves(node.left, X, resid, idx[mask])
        self._requantile_leaves(node.right, X, resid, idx[~mask])

    def predict(self, X):
        out = np.full(len(X), self.base)
        if not self.trees:
            return out
        if self._ens is None:
            self._ens = _FlatEnsemble(self.trees)
        preds = self._ens.predict_matrix(X)  # (T, n)
        # accumulate tree-by-tree: same summation order as sequential boosting
        for t in range(len(self.trees)):
            out = out + self.lr * preds[t]
        return out


class GradientBoostedTrees:
    """skopt-style GBRT surrogate: quantile ensembles at 0.16 / 0.50 / 0.84."""

    name = "GBRT"

    def __init__(self, n_estimators: int = 64, lr: float = 0.15, max_depth: int = 4, seed: int = 0):
        self.models = {
            a: _QuantileGBT(a, n_estimators, lr, max_depth, seed + i)
            for i, a in enumerate((0.16, 0.50, 0.84))
        }

    def fit(self, X, y):
        X = np.asarray(X, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        for m in self.models.values():
            m.fit(X, y)
        return self

    def predict(self, X):
        X = np.asarray(X, dtype=np.float64)
        lo = self.models[0.16].predict(X)
        mid = self.models[0.50].predict(X)
        hi = self.models[0.84].predict(X)
        sigma = np.maximum((hi - lo) / 2.0, 1e-9)
        return mid, sigma


# ---------------------------------------------------------------------------
# Gaussian process (RBF + white noise, exact Cholesky inference)
# ---------------------------------------------------------------------------


class GaussianProcess:
    """Exact GP regression; length-scale picked by marginal likelihood over a
    small log grid (no gradient optimizer needed at n<=500).

    ``partial_fit`` supports the BO loop's append-mostly refits: the Cholesky
    factor of the kernel matrix is cached across calls and extended one row at
    a time over the longest unchanged row-prefix of X (the factor of a leading
    principal submatrix is the matching prefix of L), so a ``tell`` costs
    O(n^2) instead of a full O(grid * n^3) refit. The length-scale grid only
    reruns — a full refactorization, which also bounds fp drift — every
    ``refit_every`` added rows, or when the incremental extension goes
    numerically degenerate.
    """

    name = "GP"

    def __init__(self, length_scales=(0.1, 0.2, 0.5, 1.0, 2.0, 5.0), noise: float = 1e-4,
                 seed: int = 0, refit_every: int = 16, full_fit_below: int = 32):
        self.length_scales = tuple(length_scales)
        self.noise = noise
        self.refit_every = refit_every
        # below this size a full grid fit is near-free and length-scale
        # selection is still volatile: always refit so early-campaign
        # behavior tracks the per-ask-grid reference closely
        self.full_fit_below = full_fit_below
        self._X = None
        self._alpha = None
        self._L = None
        self._Linv = None
        self._jitter = noise + 1e-10
        self._ls = 1.0
        self._amp = 1.0
        self._ymean = 0.0
        self._ystd = 1.0
        self._n_at_select = 0  # training size when the ls grid last ran

    @staticmethod
    def _sqdist(X1, X2):
        # gemm-based ||a-b||^2, accumulated in place (one (m, n) buffer
        # instead of four); clamped — cancellation can go ~-1e-14
        aa = np.einsum("ij,ij->i", X1, X1)
        bb = np.einsum("ij,ij->i", X2, X2)
        d2 = X1 @ X2.T
        d2 *= -2.0
        d2 += aa[:, None]
        d2 += bb[None, :]
        return np.maximum(d2, 0.0, out=d2)

    @classmethod
    def _k(cls, X1, X2, ls):
        d2 = cls._sqdist(X1, X2)
        d2 *= -0.5 / (ls * ls)
        return np.exp(d2, out=d2)

    def _normalize_targets(self, y):
        self._ymean = float(y.mean())
        self._ystd = float(y.std()) or 1.0
        return (y - self._ymean) / self._ystd

    def fit(self, X, y):
        """Full fit: length-scale model selection over the grid, one Cholesky
        per candidate scale (the squared-distance matrix is hoisted out)."""
        X = np.asarray(X, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        yn = self._normalize_targets(y)
        n = len(X)
        d2 = self._sqdist(X, X)
        self._jitter = self.noise + 1e-10
        jitter = self._jitter * np.eye(n)
        best = None
        for ls in self.length_scales:
            K = np.exp(-0.5 * d2 / (ls * ls)) + jitter
            try:
                L = np.linalg.cholesky(K)
            except np.linalg.LinAlgError:
                continue
            alpha = _solve_lower_t(L, _solve_lower(L, yn))
            # log marginal likelihood (up to constants)
            lml = -0.5 * yn @ alpha - np.log(np.diag(L)).sum()
            if best is None or lml > best[0]:
                best = (lml, ls, L, alpha)
        if best is None:  # fully degenerate data
            ls = self.length_scales[-1]
            self._jitter = 1e-2  # remembered so incremental rows extend the
            K = np.exp(-0.5 * d2 / (ls * ls)) + self._jitter * np.eye(n)
            L = np.linalg.cholesky(K)  # same (heavily jittered) kernel
            alpha = _solve_lower_t(L, _solve_lower(L, yn))
            best = (0.0, ls, L, alpha)
        _, self._ls, self._L, self._alpha = best
        self._Linv = _solve_lower(self._L, np.eye(n))
        self._X = X.copy()
        self._n_at_select = n
        return self

    def _common_prefix(self, X) -> int:
        m = min(len(X), len(self._X))
        if m == 0:
            return 0
        eq = (X[:m] == self._X[:m]).all(axis=1)
        return m if eq.all() else int(np.argmin(eq))

    def partial_fit(self, X, y):
        """Incremental refit for append-mostly training sets (the BO loop:
        real observations append; liar/pending rows churn only at the tail).
        Reuses ``L[:m, :m]`` for the longest unchanged prefix ``m`` and
        extends row-by-row; targets are re-normalized and alpha recomputed
        against the cached factor either way."""
        X = np.asarray(X, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        n = len(X)
        if (
            self._L is None
            or self._X is None
            or n < self.full_fit_below
            or n - self._n_at_select >= self.refit_every
        ):
            return self.fit(X, y)
        m = self._common_prefix(X)
        if m == 0:
            return self.fit(X, y)
        ls = self._ls
        diag = 1.0 + self._jitter  # k(x,x) + the jitter fit() actually used
        L = np.zeros((n, n))
        L[:m, :m] = self._L[:m, :m]
        Linv = np.zeros((n, n))
        Linv[:m, :m] = self._Linv[:m, :m]
        for i in range(m, n):
            k = self._k(X[:i], X[i:i + 1], ls)[:, 0]
            c = Linv[:i, :i] @ k           # == solve(L[:i,:i], k), O(i^2)
            d2 = diag - c @ c
            if d2 <= 1e-12:  # numerically degenerate: full refit reruns grid
                return self.fit(X, y)
            d = np.sqrt(d2)
            L[i, :i] = c
            L[i, i] = d
            # the matching inverse-factor row: [[L,0],[c^T,d]]^-1 appends
            # [-(c^T Linv)/d, 1/d], keeping predict() a pure gemm
            Linv[i, :i] = (c @ Linv[:i, :i]) / -d
            Linv[i, i] = 1.0 / d
        yn = self._normalize_targets(y)
        self._alpha = Linv.T @ (Linv @ yn)
        self._L = L
        self._Linv = Linv
        self._X = X.copy()
        return self

    def predict(self, X):
        X = np.asarray(X, dtype=np.float64)
        Ks = self._k(X, self._X, self._ls)  # (m, n)
        mu = Ks @ self._alpha
        v = self._Linv @ Ks.T  # == solve(L, Ks.T) as one gemm, (n, m)
        var = np.maximum(1.0 - (v**2).sum(axis=0), 1e-12)
        return mu * self._ystd + self._ymean, np.sqrt(var) * self._ystd + 1e-9


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

LEARNERS = ("RF", "ET", "GBRT", "GP")


def make_learner(name: str, seed: int = 0):
    name = name.upper()
    if name == "RF":
        return RandomForest(seed=seed)
    if name == "ET":
        return ExtraTrees(seed=seed)
    if name == "GBRT":
        return GradientBoostedTrees(seed=seed)
    if name == "GP":
        return GaussianProcess(seed=seed)
    raise ValueError(f"unknown learner {name!r}; options: {LEARNERS}")
