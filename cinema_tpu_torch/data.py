"""Batching shared by the task entry points: seeded batches of ``.npz`` studies with a
background loading thread. NIfTI input, the manifest cache, worker processes and the
augmentation transforms of the JAX package (cinema_tpu/data) are not ported yet: a
training item is only min-max scaled, cut at a seeded random offset and padded, without
the contrast, noise, affine and coarse-dropout transforms that precede the crop there."""

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
                    image = _cut(image, random_crop_starts(image.shape, size, rng), size)
                item[f"{view}_image"] = spatial_pad(image, size)
        return item


def random_crop_starts(shape: Sequence[int], size: Sequence[int], rng: np.random.Generator) -> List[int]:
    """Seeded start of a ``size`` cut of the leading axes of ``shape``; 0 on an axis no longer than the cut."""
    return [int(rng.integers(max(n - s, 0) + 1)) for n, s in zip(shape, size)]


def _cut(x: np.ndarray, starts: Sequence[int], size: Sequence[int]) -> np.ndarray:
    return x[tuple(slice(a, a + s) for a, s in zip(starts, size))]


class NpzEDESSegmentationDataset:
    """ED and ES segmentation frames of ``.npz`` studies (the JAX package's
    ``EDESSegmentationDataset``, cinema_tpu/data/datasets.py:68-109).

    A study holds ``sax_image`` (x, y, z, 2) and ``sax_label`` (x, y, z, 2) int8
    with the ED and ES frames on the last axis, and a scalar ``pathology``. Item
    ``i`` is frame ``i % 2`` (0 ED, 1 ES) of study ``i // 2``: ``sax_image``
    (x, y, z, 1) min-max scaled to [0, 1], ``sax_label`` (x, y, z), and the frame's
    ``sax_width``, ``sax_height`` and ``n_slices`` before padding. Training items are
    cut with their label at one seeded random offset to ``patch_size`` and end-padded
    with 0 up to it (RandSpatialCropd + SpatialPadd); evaluation items are only padded.
    """

    def __init__(self, paths: Sequence[Path], patch_size: Sequence[int], train: bool, seed: int = 0) -> None:
        self.paths = [Path(p) for p in paths]
        self.patch_size, self.train, self.seed = tuple(patch_size), train, seed

    def __len__(self) -> int:
        return 2 * len(self.paths)

    def load(self, index: int, epoch: int) -> Dict[str, np.ndarray]:
        frame = index % 2
        with np.load(self.paths[index // 2]) as study:
            image = scale_intensity(study["sax_image"][..., frame])[..., None]
            label = study["sax_label"][..., frame].astype(np.int8)
        width, height, n_slices = image.shape[:3]
        if self.train:
            starts = random_crop_starts(label.shape, self.patch_size, np.random.default_rng([self.seed, epoch, index]))
            image, label = _cut(image, starts, self.patch_size), _cut(label, starts, self.patch_size)
        return {
            "sax_image": spatial_pad(image, self.patch_size),
            "sax_label": spatial_pad(label[..., None], self.patch_size)[..., 0],
            "sax_width": np.int64(width),
            "sax_height": np.int64(height),
            "n_slices": np.int64(n_slices),
        }


def list_studies(data_dir: Path) -> List[Path]:
    """The ``.npz`` studies under ``data_dir``, sorted; raises when there is none."""
    paths = sorted(Path(data_dir).expanduser().glob("*.npz"))
    if not paths:
        raise ValueError(f"No .npz studies found under {data_dir}.")
    return paths
