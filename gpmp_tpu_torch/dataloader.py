# gpmp_tpu_torch/dataloader.py
"""Data helpers: sharded Dataset, batching DataLoader, scalers.

Counterpart of gpmp_tpu/dataloader.py:

- Index bookkeeping (shard offsets, permutations, fold indices, the
  approximate quantiles' draws) is host-side NumPy with the JAX package's
  generators, so the batches are the same, index for index: an epoch's
  order is ``np.random.default_rng(seed + epoch).permutation(n)``.  The
  data shards themselves are tensors, each on its device; a batch's index
  goes to a shard's device once per batch.
- A Dataset never shares memory with the caller's arrays: a NumPy array
  (or other array-like) is copied into a tensor on the configured device;
  a tensor is kept as it is.  The scalers return new tensors.
- ``DataLoader.as_stacked_batches()`` bridges to the mesh layer: it
  returns (num_batches, b, d) stacked tensors for
  ``gpmp_tpu_torch.parallel.make_data_parallel_criterion`` (equal-size
  batches, the remainder dropped).
- The scalers' ``fit`` takes population statistics (ddof 0, NumPy's and
  jnp's ``std``); ``Dataset``'s ``var``/``std`` divide by n - 1.
"""

from typing import Iterator, List, Optional, Tuple, Union

import numpy as np
import torch

import gpmp_tpu_torch.num as gnp

Array = gnp.ndarray
ArrayOrList = Union[Array, List[Array]]
_EPS = 1e-8


def _as_shards(obj) -> List[Array]:
    seq = obj if isinstance(obj, list) else [obj]
    return [gnp._tensor(s) for s in seq]


# ======================================================================
# Dataset
# ======================================================================
class Dataset:
    """Container for covariates x and observations z, possibly sharded.

    x and z may each be one array or a list of arrays (shards) with
    matching first-dimension lengths; indexing is lazy (no
    concatenation), with O(log #shards) lookup.
    """

    def __init__(self, x: ArrayOrList, z: ArrayOrList) -> None:
        self.x_list = _as_shards(x)
        self.z_list = _as_shards(z)

        assert len(self.x_list) == len(self.z_list), \
            "x and z shard counts differ"
        for xs, zs in zip(self.x_list, self.z_list):
            assert xs.shape[0] == zs.shape[0], "shard length mismatch"

        counts = [s.shape[0] for s in self.x_list]
        # offsets[k] = global index of shard k's first row;
        # offsets[-1] = total size
        self._offsets = np.concatenate([[0], np.cumsum(counts)])
        self.size = int(self._offsets[-1])

    def __len__(self) -> int:
        return self.size

    def __getitem__(self, idx: int):
        k = int(np.searchsorted(self._offsets, idx, side="right")) - 1
        j = idx - int(self._offsets[k])
        return self.x_list[k][j], self.z_list[k][j]

    def __repr__(self) -> str:
        return (
            f"{self.__class__.__name__}(size={self.size}, "
            f"shards={len(self.x_list)}, "
            f"x_shape={[tuple(x.shape) for x in self.x_list]}, "
            f"z_shape={[tuple(z.shape) for z in self.z_list]})"
        )

    def _gather(self, global_idx):
        """Per-shard (x, z) selections for sorted-or-not global indices,
        as two lists of arrays (empty selections skipped)."""
        global_idx = np.asarray(global_idx)
        xs, zs = [], []
        for k in range(len(self.x_list)):
            lo, hi = int(self._offsets[k]), int(self._offsets[k + 1])
            inside = global_idx[(global_idx >= lo) & (global_idx < hi)]
            if inside.size:
                idx = torch.as_tensor(inside - lo, device=self.x_list[k].device)
                xs.append(self.x_list[k][idx])
                zs.append(self.z_list[k][idx.to(self.z_list[k].device)])
        return xs, zs

    # ------------------------------------------------------------- slicing
    def subset(self, indices) -> "Dataset":
        """Dataset restricted to indices; shard structure preserved."""
        indices = np.asarray(gnp.to_np(indices))
        if indices.ndim != 1:
            raise ValueError("Subset indices must be 1D")
        xs, zs = self._gather(np.sort(indices))
        return Dataset(xs, zs)

    # ------------------------------------------------------------- split
    @staticmethod
    def split(dataset, ratios=(0.8, 0.1, 0.1), seed: Optional[int] = None):
        """(train, val, test) random split according to ratios."""
        assert abs(sum(ratios) - 1.0) < 1e-9, "Ratios must sum to 1"
        order = np.random.default_rng(seed).permutation(len(dataset))
        cut1 = int(ratios[0] * order.size)
        cut2 = cut1 + int(ratios[1] * order.size)
        return tuple(
            dataset.subset(part)
            for part in (order[:cut1], order[cut1:cut2], order[cut2:])
        )

    @staticmethod
    def k_fold_indices(n_samples, n_splits, seed: Optional[int] = None):
        """k (train, val) index tuples covering all samples."""
        order = np.random.default_rng(seed).permutation(n_samples)
        # first (n_samples mod k) folds get one extra sample
        folds = np.array_split(order, n_splits)
        return [
            (np.concatenate(folds[:k] + folds[k + 1:]), folds[k])
            for k in range(n_splits)
        ]

    @staticmethod
    def repeated_k_fold_indices(n_samples, n_splits, n_repeats,
                                seed: Optional[int] = None):
        """n_repeats independently shuffled k-fold splits."""
        out = []
        for r in range(n_repeats):
            out += Dataset.k_fold_indices(
                n_samples, n_splits, None if seed is None else seed + r
            )
        return out

    # ----------------------------------------------- streaming reductions
    # Each statistic is a fold over shards (never concatenates device
    # memory), except the exact quantiles, which need the full sample.
    def _fold(self, shards, shard_stat, combine):
        acc = None
        for s in shards:
            piece = shard_stat(s)
            acc = piece if acc is None else combine(acc, piece)
        return acc

    def _shards(self, x_or_z):
        return self.x_list if x_or_z == "x" else self.z_list

    def _reduce_min(self, x_or_z):
        return self._fold(self._shards(x_or_z),
                          lambda s: gnp.min(s, axis=0), gnp.minimum)

    def _reduce_max(self, x_or_z):
        return self._fold(self._shards(x_or_z),
                          lambda s: gnp.max(s, axis=0), gnp.maximum)

    def _reduce_mean(self, x_or_z):
        shards = self._shards(x_or_z)
        total = self._fold(shards, lambda s: gnp.sum(s, axis=0),
                           lambda a, b: a + b)
        return total / self.size

    def _reduce_var(self, x_or_z):
        center = self._reduce_mean(x_or_z)
        shards = self._shards(x_or_z)
        ss = self._fold(shards,
                        lambda s: gnp.sum((s - center) ** 2, axis=0),
                        lambda a, b: a + b)
        return ss / (self.size - 1)

    def _reduce_std(self, x_or_z):
        return gnp.sqrt(self._reduce_var(x_or_z))

    def _reduce_quantile(self, x_or_z, q):
        if not (0.0 <= q <= 1.0):
            raise ValueError("quantile level q must be between 0 and 1")
        full = gnp.concatenate(self._shards(x_or_z), axis=0)
        return gnp.percentile(full, q * 100.0, axis=0)

    def _reduce_quantile_approx(self, x_or_z, q, sample_size=1000):
        if not (0.0 <= q <= 1.0):
            raise ValueError("quantile level q must be between 0 and 1")
        shards = self._shards(x_or_z)
        rng = np.random.default_rng(0)
        per_shard = max(1, sample_size // len(shards))
        picks = [
            s[torch.as_tensor(rng.choice(s.shape[0], min(s.shape[0], per_shard),
                                         replace=False), device=s.device)]
            for s in shards
        ]
        return gnp.percentile(gnp.concatenate(picks, axis=0),
                              q * 100.0, axis=0)

    def _reduce_median(self, x_or_z):
        return self._reduce_quantile(x_or_z, 0.5)


# auto-generate x_*/z_* reduction methods (x_min ... z_median)
def _install_reducers():
    def bind(field, stat):
        def method(self, *args, **kwargs):
            return getattr(self, f"_reduce_{stat}")(field, *args, **kwargs)

        method.__name__ = f"{field}_{stat}"
        return method

    for field in ("x", "z"):
        for stat in ("min", "max", "mean", "var", "std",
                     "quantile", "median"):
            setattr(Dataset, f"{field}_{stat}", bind(field, stat))


_install_reducers()


# ======================================================================
# DataLoader
# ======================================================================
class DataLoader:
    """Mini-batch iterator with deterministic epoch seeding.

    batch_size=None uses the full dataset as one batch; drop_last and
    infinite cycling as in the JAX package.
    """

    def __init__(self, dataset, batch_size=None, shuffle=True, drop_last=False,
                 seed=None, infinite=False):
        self.dataset = dataset
        if batch_size is None:
            batch_size = len(dataset)
        if batch_size <= 0:
            raise ValueError("batch_size must be a positive integer.")
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.drop_last = drop_last
        self._base_seed = seed
        self._epoch = 0
        self._infinite = infinite

    def set_epoch(self, epoch: int) -> None:
        """Set the epoch used for deterministic shuffling."""
        self._epoch = epoch

    def _epoch_order(self) -> np.ndarray:
        seed = (None if self._base_seed is None
                else self._base_seed + self._epoch)
        n = len(self.dataset)
        if not self.shuffle:
            return np.arange(n)
        return np.random.default_rng(seed).permutation(n)

    def __iter__(self) -> Iterator[Tuple[Array, Array]]:
        while True:
            order = self._epoch_order()
            n = order.size
            stop = (n - n % self.batch_size) if self.drop_last else n
            for lo in range(0, stop, self.batch_size):
                yield self._fetch_batch(order[lo : lo + self.batch_size])
            self._epoch += 1
            if not self._infinite:
                return

    def _fetch_batch(self, batch_idx):
        xs, zs = self.dataset._gather(batch_idx)
        return gnp.concatenate(xs, 0), gnp.concatenate(zs, 0)

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)  # ceil

    def __getitem__(self, index):
        if self.shuffle or self._infinite:
            raise RuntimeError(
                "Batch indexing requires shuffle=False and infinite=False."
            )
        n_batches = len(self)
        if isinstance(index, slice):
            return [self[i] for i in range(*index.indices(n_batches))]
        if not isinstance(index, int):
            raise TypeError("Index must be int or slice")
        if index < 0:
            index += n_batches
        if index < 0 or index >= n_batches:
            raise IndexError("Batch index out of range")
        lo = index * self.batch_size
        hi = min(lo + self.batch_size, len(self.dataset))
        return self._fetch_batch(np.arange(lo, hi))

    def __repr__(self) -> str:
        return (
            f"{self.__class__.__name__}(batch_size={self.batch_size}, "
            f"shuffle={self.shuffle}, drop_last={self.drop_last}, "
            f"infinite={self._infinite}, dataset_size={len(self.dataset)})"
        )

    def reduce_mean(self, func):
        """Batch-size-weighted mean of func(x_batch, z_batch) over batches."""
        total, count = None, 0
        for xb, zb in self:
            w = xb.shape[0]
            term = func(xb, zb) * w
            total = term if total is None else total + term
            count += w
        return total / count

    # ------------------------------------------------- mesh bridge
    def as_stacked_batches(self, mesh=None, axis_name="batch"):
        """(num_batches, b, d)/(num_batches, b) stacked equal-size batches
        (remainder dropped), in the data's order; on a group mesh this
        rank's share -- the input format of
        gpmp_tpu_torch.parallel.make_data_parallel_criterion."""
        from gpmp_tpu_torch.parallel.batched import shard_batches

        x = gnp.concatenate(self.dataset.x_list, axis=0)
        z = gnp.concatenate(self.dataset.z_list, axis=0).reshape(-1)
        n_batches = len(self.dataset) // self.batch_size
        return shard_batches(x, z, n_batches, mesh=mesh, axis_name=axis_name)


# auto-generate DataLoader.dataset_{x,z}_{stat} properties forwarding to
# the underlying Dataset's reduction methods: the property value is the
# dataset's bound method.
def _install_forwarders():
    def bind(method_name):
        return property(lambda self: getattr(self.dataset, method_name))

    for field in ("x", "z"):
        for stat in ("min", "max", "mean", "var", "std",
                     "quantile", "median"):
            setattr(DataLoader, f"dataset_{field}_{stat}",
                    bind(f"{field}_{stat}"))


_install_forwarders()


# ======================================================================
# Scalers
# ======================================================================
class _AffineScaler:
    """Shared affine transform core: (x - shift) / spread."""

    def __init__(self, shift, spread):
        self.shift = gnp._tensor(shift)
        self.spread = gnp.where(gnp._tensor(spread) < _EPS, 1.0, spread)

    def transform(self, x, copy=True):
        return (gnp._tensor(x) - self.shift) / self.spread

    def inverse_transform(self, y, copy=True):
        return gnp._tensor(y) * self.spread + self.shift


class Normalizer(_AffineScaler):
    """Standardize covariates to zero mean / unit variance."""

    def __init__(self, mean, std):
        super().__init__(mean, std)

    mean = property(lambda self: self.shift)
    std = property(lambda self: self.spread)

    @staticmethod
    def fit(x):
        return Normalizer(gnp.mean(x, axis=0, keepdims=True),
                          gnp.std(x, axis=0, keepdims=True))


class RobustScaler(_AffineScaler):
    """Scale covariates by median and interquartile range."""

    def __init__(self, median, iqr):
        super().__init__(median, iqr)

    median = property(lambda self: self.shift)
    iqr = property(lambda self: self.spread)

    @staticmethod
    def fit(x, q_low=25.0, q_high=75.0):
        levels = [
            gnp.percentile(x, q, axis=0, keepdims=True)
            for q in (q_low, 50.0, q_high)
        ]
        return RobustScaler(levels[1], levels[2] - levels[0])


class MinMaxScaler(_AffineScaler):
    """Rescale covariates to [0, 1]."""

    def __init__(self, x_min, x_max):
        super().__init__(x_min, x_max - x_min)

    x_min = property(lambda self: self.shift)
    range = property(lambda self: self.spread)

    @staticmethod
    def fit(x):
        return MinMaxScaler(gnp.min(x, axis=0, keepdims=True),
                            gnp.max(x, axis=0, keepdims=True))


class ObservationScaler:
    """Standardize scalar observations to zero mean / unit variance."""

    def __init__(self, mean, std):
        self.mean = mean
        self.std = 1.0 if float(std) < _EPS else std

    def transform(self, z, copy=True):
        return (gnp._tensor(z) - self.mean) / self.std

    def inverse_transform(self, z_std, copy=True):
        return gnp._tensor(z_std) * self.std + self.mean

    @staticmethod
    def fit(z):
        return ObservationScaler(gnp.mean(z), gnp.std(z))


def collate_batches(batches):
    """Concatenate a list of (x_batch, z_batch) into full arrays."""
    if not batches:
        raise ValueError("Cannot collate an empty list of batches.")
    xs, zs = zip(*batches)
    return gnp.concatenate(xs, 0), gnp.concatenate(zs, 0)
