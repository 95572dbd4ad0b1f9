"""Dataset preprocessors: fit statistics once, transform anywhere.

Parity: ``python/ray/data/preprocessors/`` (Preprocessor base in
``preprocessor.py`` — fit/transform/fit_transform over Datasets plus
``transform_batch`` for serving-time reuse; scaler.py, encoder.py,
imputer.py, normalizer.py, concatenator.py, chain.py, batch_mapper.py,
discretizer.py, tokenizer.py, hasher.py, vectorizer.py).

TPU design: fit streams ``iter_batches`` once and reduces numpy statistics
on the host (fit is IO-bound, not a device job); transform is a pure
function of (stats, batch) applied through ``map_batches``, so it fuses
into the streaming executor and the SAME callable serves online inference
(``transform_batch``) — train/serve skew is structurally impossible.

The port's copy of ``ray_tpu/data/preprocessors.py``: the same behaviour, imports
renamed to ``ray_tpu_torch``.
"""

from __future__ import annotations

import collections
import functools
import hashlib
from typing import Any, Callable, Dict, List, Optional

import numpy as np

Batch = Dict[str, np.ndarray]


class PreprocessorNotFittedError(RuntimeError):
    pass


class Preprocessor:
    """Base: subclasses implement ``_fit(dataset)`` (populate ``self.stats_``)
    and ``_transform_numpy(batch)``."""

    # subclasses that need no fitting (BatchMapper, Concatenator, ...) flip this
    _is_fittable = True

    def __init__(self):
        self.stats_: Dict[str, Any] = {}
        self._fitted = not self._is_fittable

    def fit(self, dataset) -> "Preprocessor":
        if self._is_fittable:
            self._fit(dataset)
            self._fitted = True
        return self

    def fit_transform(self, dataset):
        return self.fit(dataset).transform(dataset)

    def transform(self, dataset):
        self._check_fitted()
        return dataset.map_batches(self._transform_numpy, batch_format="numpy")

    def transform_batch(self, batch: Batch) -> Batch:
        """Apply to one in-memory batch (online/serving path)."""
        self._check_fitted()
        return self._transform_numpy({k: np.asarray(v) for k, v in batch.items()})

    def _check_fitted(self) -> None:
        if not self._fitted:
            raise PreprocessorNotFittedError(
                f"{type(self).__name__} must be fit() on a dataset before transform"
            )

    # -- subclass hooks -------------------------------------------------
    def _fit(self, dataset) -> None:
        raise NotImplementedError

    def _transform_numpy(self, batch: Batch) -> Batch:
        raise NotImplementedError

    def __repr__(self):
        return f"{type(self).__name__}(fitted={self._fitted})"


def _column_stream(dataset, columns: List[str]):
    for batch in dataset.iter_batches(batch_format="numpy"):
        yield {c: np.asarray(batch[c]) for c in columns}


class StandardScaler(Preprocessor):
    """(x - mean) / std per column (parity: scaler.py:StandardScaler)."""

    def __init__(self, columns: List[str]):
        super().__init__()
        self.columns = columns

    def _fit(self, dataset) -> None:
        n = 0
        s = {c: 0.0 for c in self.columns}
        sq = {c: 0.0 for c in self.columns}
        for batch in _column_stream(dataset, self.columns):
            n += len(next(iter(batch.values())))
            for c, v in batch.items():
                s[c] += float(v.sum())
                sq[c] += float((v.astype(np.float64) ** 2).sum())
        for c in self.columns:
            mean = s[c] / max(1, n)
            var = max(0.0, sq[c] / max(1, n) - mean**2)
            self.stats_[f"mean({c})"] = mean
            self.stats_[f"std({c})"] = float(np.sqrt(var))

    def _transform_numpy(self, batch: Batch) -> Batch:
        out = dict(batch)
        for c in self.columns:
            std = self.stats_[f"std({c})"] or 1.0
            out[c] = (np.asarray(batch[c], np.float64) - self.stats_[f"mean({c})"]) / std
        return out


class MinMaxScaler(Preprocessor):
    """(x - min) / (max - min) per column (parity: scaler.py:MinMaxScaler)."""

    def __init__(self, columns: List[str]):
        super().__init__()
        self.columns = columns

    def _fit(self, dataset) -> None:
        lo = {c: np.inf for c in self.columns}
        hi = {c: -np.inf for c in self.columns}
        for batch in _column_stream(dataset, self.columns):
            for c, v in batch.items():
                lo[c] = min(lo[c], float(v.min()))
                hi[c] = max(hi[c], float(v.max()))
        for c in self.columns:
            self.stats_[f"min({c})"] = lo[c]
            self.stats_[f"max({c})"] = hi[c]

    def _transform_numpy(self, batch: Batch) -> Batch:
        out = dict(batch)
        for c in self.columns:
            lo, hi = self.stats_[f"min({c})"], self.stats_[f"max({c})"]
            span = (hi - lo) or 1.0
            out[c] = (np.asarray(batch[c], np.float64) - lo) / span
        return out


class OrdinalEncoder(Preprocessor):
    """Category -> dense int index, ordered by sorted unique value
    (parity: encoder.py:OrdinalEncoder). Unseen values -> -1."""

    def __init__(self, columns: List[str]):
        super().__init__()
        self.columns = columns

    def _fit(self, dataset) -> None:
        uniques = {c: set() for c in self.columns}
        for batch in _column_stream(dataset, self.columns):
            for c, v in batch.items():
                uniques[c].update(v.tolist())
        for c in self.columns:
            self.stats_[f"unique_values({c})"] = {
                v: i for i, v in enumerate(sorted(uniques[c]))
            }

    def _transform_numpy(self, batch: Batch) -> Batch:
        out = dict(batch)
        for c in self.columns:
            table = self.stats_[f"unique_values({c})"]
            out[c] = np.array([table.get(v, -1) for v in batch[c].tolist()], np.int64)
        return out


class LabelEncoder(OrdinalEncoder):
    """OrdinalEncoder for the single label column (parity: encoder.py)."""

    def __init__(self, label_column: str):
        super().__init__([label_column])
        self.label_column = label_column


class OneHotEncoder(Preprocessor):
    """Category -> one-hot vector column (parity: encoder.py:OneHotEncoder).
    Unseen values encode to all-zeros."""

    def __init__(self, columns: List[str]):
        super().__init__()
        self.columns = columns

    def _fit(self, dataset) -> None:
        enc = OrdinalEncoder(self.columns)
        enc._fit(dataset)
        self.stats_ = enc.stats_

    def _transform_numpy(self, batch: Batch) -> Batch:
        out = dict(batch)
        for c in self.columns:
            table = self.stats_[f"unique_values({c})"]
            vec = np.zeros((len(batch[c]), len(table)), np.float64)
            for i, v in enumerate(batch[c].tolist()):
                j = table.get(v)
                if j is not None:
                    vec[i, j] = 1.0
            out[c] = vec
        return out


class SimpleImputer(Preprocessor):
    """Fill missing values (NaN, or None in object columns) with the
    column mean / most_frequent / a constant (parity: imputer.py)."""

    def __init__(self, columns: List[str], strategy: str = "mean", fill_value=None):
        super().__init__()
        if strategy not in ("mean", "most_frequent", "constant"):
            raise ValueError(f"unknown strategy {strategy!r}")
        if strategy == "constant" and fill_value is None:
            raise ValueError("strategy='constant' needs fill_value")
        self.columns = columns
        self.strategy = strategy
        self.fill_value = fill_value
        if strategy == "constant":
            self._is_fittable = False
            self._fitted = True

    def _fit(self, dataset) -> None:
        if self.strategy == "mean":
            s = {c: 0.0 for c in self.columns}
            n = {c: 0 for c in self.columns}
            for batch in _column_stream(dataset, self.columns):
                for c, v in batch.items():
                    v = v.astype(np.float64)
                    mask = ~np.isnan(v)
                    s[c] += float(v[mask].sum())
                    n[c] += int(mask.sum())
            for c in self.columns:
                self.stats_[f"mean({c})"] = s[c] / max(1, n[c])
        else:  # most_frequent
            counts = {c: collections.Counter() for c in self.columns}
            for batch in _column_stream(dataset, self.columns):
                for c, v in batch.items():
                    counts[c].update(x for x in v.tolist() if x is not None and x == x)
            for c in self.columns:
                if not counts[c]:
                    raise ValueError(
                        f"SimpleImputer(strategy='most_frequent'): column {c!r} "
                        "has no non-missing values to fit on"
                    )
                self.stats_[f"most_frequent({c})"] = counts[c].most_common(1)[0][0]

    def _fill_for(self, c: str):
        if self.strategy == "constant":
            return self.fill_value
        if self.strategy == "mean":
            return self.stats_[f"mean({c})"]
        return self.stats_[f"most_frequent({c})"]

    def _transform_numpy(self, batch: Batch) -> Batch:
        out = dict(batch)
        for c in self.columns:
            v = batch[c]
            fill = self._fill_for(c)
            if v.dtype.kind == "f":
                out[c] = np.where(np.isnan(v), fill, v)
            else:
                out[c] = np.array(
                    [fill if (x is None or x != x) else x for x in v.tolist()]
                )
        return out


class Normalizer(Preprocessor):
    """Row-wise unit-norm over a set of numeric columns treated as one
    vector (parity: normalizer.py; norms l1/l2/max)."""

    _is_fittable = False

    def __init__(self, columns: List[str], norm: str = "l2"):
        super().__init__()
        if norm not in ("l1", "l2", "max"):
            raise ValueError(f"unknown norm {norm!r}")
        self.columns = columns
        self.norm = norm

    def _transform_numpy(self, batch: Batch) -> Batch:
        out = dict(batch)
        mat = np.stack([np.asarray(batch[c], np.float64) for c in self.columns], axis=1)
        if self.norm == "l1":
            denom = np.abs(mat).sum(axis=1)
        elif self.norm == "l2":
            denom = np.sqrt((mat**2).sum(axis=1))
        else:
            denom = np.abs(mat).max(axis=1)
        denom = np.where(denom == 0, 1.0, denom)
        for i, c in enumerate(self.columns):
            out[c] = mat[:, i] / denom
        return out


class Concatenator(Preprocessor):
    """Pack several numeric columns into one vector column, dropping the
    originals (parity: concatenator.py)."""

    _is_fittable = False

    def __init__(self, columns: List[str], output_column_name: str = "concat_out"):
        super().__init__()
        self.columns = columns
        self.output_column_name = output_column_name

    def _transform_numpy(self, batch: Batch) -> Batch:
        out = {k: v for k, v in batch.items() if k not in self.columns}
        parts = []
        for c in self.columns:
            v = np.asarray(batch[c], np.float64)
            parts.append(v[:, None] if v.ndim == 1 else v.reshape(len(v), -1))
        out[self.output_column_name] = np.concatenate(parts, axis=1)
        return out


class BatchMapper(Preprocessor):
    """Arbitrary user function over batches (parity: batch_mapper.py)."""

    _is_fittable = False

    def __init__(self, fn: Callable[[Batch], Batch]):
        super().__init__()
        self.fn = fn

    def _transform_numpy(self, batch: Batch) -> Batch:
        return self.fn(batch)


class Chain(Preprocessor):
    """Sequential composition; fit propagates each stage's OUTPUT to the
    next stage's fit (parity: chain.py)."""

    def __init__(self, *preprocessors: Preprocessor):
        super().__init__()
        self.preprocessors = list(preprocessors)
        self._is_fittable = any(p._is_fittable for p in self.preprocessors)
        self._fitted = not self._is_fittable

    def _fit(self, dataset) -> None:
        for i, p in enumerate(self.preprocessors):
            p.fit(dataset)
            if any(q._is_fittable for q in self.preprocessors[i + 1 :]):
                # materialize between stages: otherwise the next FIT lazily
                # re-executes the base read plus stages 0..i from scratch
                # (O(k^2) passes for k fittable stages). Skipped when no
                # later stage fits — transform-only tails don't need the
                # intermediate, and materializing it could dwarf the fit.
                dataset = p.transform(dataset).materialize()

    def transform(self, dataset):
        self._check_fitted()
        for p in self.preprocessors:
            dataset = p.transform(dataset)
        return dataset

    def transform_batch(self, batch: Batch) -> Batch:
        self._check_fitted()
        for p in self.preprocessors:
            batch = p.transform_batch(batch)
        return batch


class KBinsDiscretizer(Preprocessor):
    """Continuous -> bin index, uniform or quantile edges (parity:
    discretizer.py Uniform/CustomKBinsDiscretizer).

    ``strategy="uniform"`` fits in O(1) memory. ``strategy="quantile"``
    computes EXACT quantiles and therefore materializes the fitted columns
    on the host during fit — prefer uniform (or subsample first) for
    columns larger than RAM."""

    def __init__(self, columns: List[str], bins: int = 5, strategy: str = "uniform"):
        super().__init__()
        if strategy not in ("uniform", "quantile"):
            raise ValueError(f"unknown strategy {strategy!r}")
        self.columns = columns
        self.bins = bins
        self.strategy = strategy

    def _fit(self, dataset) -> None:
        if self.strategy == "uniform":
            mm = MinMaxScaler(self.columns)
            mm._fit(dataset)
            for c in self.columns:
                lo, hi = mm.stats_[f"min({c})"], mm.stats_[f"max({c})"]
                self.stats_[f"edges({c})"] = np.linspace(lo, hi, self.bins + 1)[1:-1]
        else:
            vals = {c: [] for c in self.columns}
            for batch in _column_stream(dataset, self.columns):
                for c, v in batch.items():
                    vals[c].append(v.astype(np.float64))
            for c in self.columns:
                allv = np.concatenate(vals[c])
                qs = np.linspace(0, 1, self.bins + 1)[1:-1]
                self.stats_[f"edges({c})"] = np.quantile(allv, qs)

    def _transform_numpy(self, batch: Batch) -> Batch:
        out = dict(batch)
        for c in self.columns:
            out[c] = np.digitize(
                np.asarray(batch[c], np.float64), self.stats_[f"edges({c})"]
            ).astype(np.int64)
        return out


def _default_tokenize(s: str) -> List[str]:
    return s.lower().split()


@functools.lru_cache(maxsize=65536)
def _hash_bucket(token: str, num_features: int) -> int:
    # md5, not hash(): stable across processes/PYTHONHASHSEED
    return int.from_bytes(hashlib.md5(token.encode()).digest()[:8], "little") % num_features


class Tokenizer(Preprocessor):
    """String column -> list-of-tokens column (parity: tokenizer.py)."""

    _is_fittable = False

    def __init__(self, columns: List[str], tokenization_fn: Optional[Callable] = None):
        super().__init__()
        self.columns = columns
        self.fn = tokenization_fn or _default_tokenize

    def _transform_numpy(self, batch: Batch) -> Batch:
        out = dict(batch)
        for c in self.columns:
            rows = [self.fn(str(s)) for s in batch[c].tolist()]
            # np.array(..., dtype=object) would build a 2-D array whenever
            # every row has the same token count, making the column's ndim
            # batch-dependent; preallocate so each cell is a token LIST
            col = np.empty(len(rows), dtype=object)
            for i, r in enumerate(rows):
                col[i] = r
            out[c] = col
        return out


class FeatureHasher(Preprocessor):
    """Token lists -> fixed-width count vector by hashing (parity:
    hasher.py; stable across processes via md5, not Python hash())."""

    _is_fittable = False

    def __init__(self, columns: List[str], num_features: int = 256):
        super().__init__()
        self.columns = columns
        self.num_features = num_features

    def _bucket(self, token: str) -> int:
        return _hash_bucket(token, self.num_features)

    def _transform_numpy(self, batch: Batch) -> Batch:
        out = dict(batch)
        for c in self.columns:
            vec = np.zeros((len(batch[c]), self.num_features), np.float64)
            for i, tokens in enumerate(batch[c].tolist()):
                for t in tokens if not isinstance(tokens, str) else self._split(tokens):
                    vec[i, self._bucket(str(t))] += 1.0
            out[c] = vec
        return out

    @staticmethod
    def _split(s: str) -> List[str]:
        return _default_tokenize(s)


class CountVectorizer(Preprocessor):
    """Token lists / strings -> count vector over the fitted vocabulary
    (parity: vectorizer.py; optional max_features keeps the most frequent)."""

    def __init__(self, columns: List[str], max_features: Optional[int] = None):
        super().__init__()
        self.columns = columns
        self.max_features = max_features

    @staticmethod
    def _tokens(value) -> List[str]:
        return _default_tokenize(value) if isinstance(value, str) else list(value)

    def _fit(self, dataset) -> None:
        counts = {c: collections.Counter() for c in self.columns}
        for batch in _column_stream(dataset, self.columns):
            for c, v in batch.items():
                for row in v.tolist():
                    counts[c].update(str(t) for t in self._tokens(row))
        for c in self.columns:
            common = counts[c].most_common(self.max_features)
            self.stats_[f"token_counts({c})"] = {
                t: i for i, (t, _n) in enumerate(sorted(common))
            }

    def _transform_numpy(self, batch: Batch) -> Batch:
        out = dict(batch)
        for c in self.columns:
            vocab = self.stats_[f"token_counts({c})"]
            vec = np.zeros((len(batch[c]), len(vocab)), np.float64)
            for i, row in enumerate(batch[c].tolist()):
                for t in self._tokens(row):
                    j = vocab.get(str(t))
                    if j is not None:
                        vec[i, j] += 1.0
            out[c] = vec
        return out


__all__ = [
    "Preprocessor",
    "PreprocessorNotFittedError",
    "StandardScaler",
    "MinMaxScaler",
    "OrdinalEncoder",
    "LabelEncoder",
    "OneHotEncoder",
    "SimpleImputer",
    "Normalizer",
    "Concatenator",
    "BatchMapper",
    "Chain",
    "KBinsDiscretizer",
    "Tokenizer",
    "FeatureHasher",
    "CountVectorizer",
]
