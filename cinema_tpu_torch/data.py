"""Batching shared by the task entry points: seeded batches of ``.npz`` studies with a
background loading thread. NIfTI input, the manifest cache, worker processes and the
augmentation transforms of the JAX package (cinema_tpu/data) are not ported yet."""

from __future__ import annotations

import queue
import threading
from pathlib import Path
from typing import Callable, Dict, Iterator, List, Sequence

import numpy as np

from cinema_tpu_torch.serve import scale_intensity, spatial_pad


def fit_to_size(x: np.ndarray, size: Sequence[int]) -> np.ndarray:
    """End-pad with zeros or crop the leading axes of ``x`` to ``size``."""
    x = x[tuple(slice(0, s) for s in size)]
    return np.pad(x, [(0, s - n) for n, s in zip(x.shape, size)] + [(0, 0)] * (x.ndim - len(size)))


class BatchLoader:
    """Batches of a dataset whose ``load(index, epoch)`` returns a dict of arrays: each
    key stacked along a new leading axis. Seeded shuffling per epoch and the incomplete
    last batch dropped unless asked otherwise; a background thread loads ``depth``
    batches ahead of the consumer."""

    def __init__(self, dataset, batch_size: int, seed: int = 0, depth: int = 2, shuffle: bool = True,
                 drop_last: bool = True) -> None:
        self.dataset, self.batch_size, self.seed, self.depth = dataset, batch_size, seed, depth
        self.shuffle, self.drop_last = shuffle, drop_last

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _batches(self, epoch: int) -> Iterator[Dict[str, np.ndarray]]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            order = np.random.default_rng([self.seed, epoch]).permutation(len(self.dataset))
        for b in range(len(self)):
            items = [self.dataset.load(int(i), epoch) for i in order[b * self.batch_size : (b + 1) * self.batch_size]]
            yield {key: np.stack([item[key] for item in items]) for key in items[0]}

    def epoch(self, epoch: int) -> Iterator[Dict[str, np.ndarray]]:
        """The batches of one epoch."""
        out: queue.Queue = queue.Queue(maxsize=self.depth)

        def work() -> None:
            try:
                for batch in self._batches(epoch):
                    out.put(batch)
                out.put(None)
            except Exception as e:  # handed to the consumer, which raises it
                out.put(e)

        thread = threading.Thread(target=work, daemon=True)
        thread.start()
        while True:
            batch = out.get()
            if batch is None:
                break
            if isinstance(batch, Exception):
                raise batch
            yield batch
        thread.join()


class NpzEDESDataset:
    """One ``.npz`` per study: per view ``{view}_image`` with the ED and ES frames as the
    two channels, (x, y, z, 2) for ``sax`` and (x, y, 2) for the ``lax_*`` views, and scalar
    fields. An item is {``{view}_image``: float32 in [0, 1], ``label``: ``label_fn(study)``}.

    Training items are cut to the view's patch size at a seeded random offset and
    end-padded up to it (the JAX package's RandSpatialCropd + SpatialPadd); evaluation
    items are only padded, so a larger study is evaluated patch by patch.
    """

    def __init__(self, paths: Sequence[Path], views: Sequence[str], sizes: Dict[str, Sequence[int]],
                 label_fn: Callable[[Dict[str, np.ndarray]], np.ndarray], train: bool, seed: int = 0) -> None:
        self.paths = [Path(p) for p in paths]
        self.views, self.sizes, self.label_fn, self.train, self.seed = list(views), sizes, label_fn, train, seed

    def __len__(self) -> int:
        return len(self.paths)

    def load(self, index: int, epoch: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng([self.seed, epoch, index])
        with np.load(self.paths[index]) as study:
            item = {"label": np.asarray(self.label_fn(study))}
            for view in self.views:
                image = scale_intensity(study[f"{view}_image"])
                size = tuple(self.sizes[view])
                if self.train:
                    starts = [int(rng.integers(max(n - s, 0) + 1)) for n, s in zip(image.shape, size)]
                    image = image[tuple(slice(a, a + s) for a, s in zip(starts, size))]
                item[f"{view}_image"] = spatial_pad(image, size)
        return item


def list_studies(data_dir: Path, max_n_samples: int = -1) -> List[Path]:
    """The ``.npz`` studies under ``data_dir``, sorted; raises when there is none."""
    paths = sorted(Path(data_dir).expanduser().glob("*.npz"))
    if max_n_samples > 0:
        paths = paths[:max_n_samples]
    if not paths:
        raise ValueError(f"No .npz studies found under {data_dir}.")
    return paths
