"""Batching shared by the task entry points: seeded batches of ``.npz`` studies with a
background loading thread, and the landmark datasets of 8-bit grayscale PNGs with their
metadata tables. NIfTI input, the manifest cache, worker processes and the
augmentation transforms of the JAX package (cinema_tpu/data) are not ported yet: a
training item is only min-max scaled, cut at a seeded random offset and padded, without
the contrast, noise, affine and coarse-dropout transforms that precede the crop there.
The landmark items take no transform at all, as the JAX package's landmark tasks build them."""

from __future__ import annotations

import csv
import queue
import struct
import threading
import zlib
from pathlib import Path
from typing import Callable, Dict, Iterator, List, Sequence, Union

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


def gaussian_heatmap(shape: Sequence[int], centers: np.ndarray, sigma: float = 3.0) -> np.ndarray:
    """Gaussian heatmaps of landmarks (reference segmentation/landmark/dataset.py:19-38): (w, h) and
    (n, 2) centres -> (w, h, n) float32 in [0, 1], 1 at a centre on the grid."""
    w, h = shape
    xs, ys = np.meshgrid(np.arange(w), np.arange(h), indexing="ij")
    maps = [np.exp(-((xs - cx) ** 2 + (ys - cy) ** 2) / (2 * sigma**2)) for cx, cy in centers]
    return np.stack(maps, axis=-1).astype(np.float32)


_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _unfilter_row(kind: int, line: np.ndarray, prior: np.ndarray) -> np.ndarray:
    """One scanline of one byte per pixel, its PNG filter undone (None, Sub, Up, Average, Paeth)."""
    if kind == 0:
        return line
    if kind == 1:  # Sub: a running sum of the row, mod 256
        return np.cumsum(line, dtype=np.uint8)
    if kind == 2:  # Up
        return line + prior
    f, b = line.tolist(), prior.tolist()
    out, a, c = [0] * len(f), 0, 0
    if kind == 3:  # Average of the left and the upper neighbour
        for i, (fi, bi) in enumerate(zip(f, b)):
            a = (fi + ((a + bi) >> 1)) & 255
            out[i] = a
    elif kind == 4:  # Paeth: of left, upper and upper-left, the one nearest to left + upper - upper-left
        for i, (fi, bi) in enumerate(zip(f, b)):
            pa, pb, pc = abs(bi - c), abs(a - c), abs(a + bi - 2 * c)
            a = (fi + (a if pa <= pb and pa <= pc else bi if pb <= pc else c)) & 255
            out[i], c = a, bi
    else:
        raise ValueError(f"Unknown PNG filter type {kind}.")
    return np.asarray(out, np.uint8)


def read_png_gray(path: Union[str, Path]) -> np.ndarray:
    """An 8-bit grayscale, non-interlaced PNG as a float32 (x, y) array, the JAX package's
    ``np.asarray(Image.open(path).convert("L"), np.float32).T`` for the PNGs its landmark
    preprocessing writes; ancillary chunks are skipped. Any other PNG raises ``ValueError``."""
    data = Path(path).read_bytes()
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError(f"{path} is not a PNG file.")
    header, idat, pos = None, [], 8
    while pos + 12 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos : pos + 8])
        body = data[pos + 8 : pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length : pos + 12 + length])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"{path}: CRC mismatch in the {kind!r} chunk.")
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + length
    if header is None or not idat:
        raise ValueError(f"{path}: no IHDR or IDAT chunk.")
    width, height, bit_depth, colour_type, _, _, interlace = header
    if (bit_depth, colour_type, interlace) != (8, 0, 0):
        raise ValueError(
            f"{path}: bit depth {bit_depth}, colour type {colour_type}, interlace {interlace}; only 8-bit "
            "grayscale non-interlaced PNGs are read here. Other images wait for the port of the data engine "
            "(ROADMAP.md, Queue 1, item 14).")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != height * (width + 1):
        raise ValueError(f"{path}: {raw.size} bytes of image data, expected {height * (width + 1)}.")
    rows = raw.reshape(height, width + 1)
    image = np.empty((height, width), np.uint8)
    prior = np.zeros(width, np.uint8)
    for r in range(height):
        prior = image[r] = _unfilter_row(int(rows[r, 0]), rows[r, 1:], prior)
    return image.T.astype(np.float32)


def read_landmark_metadata(path: Union[str, Path]) -> List[Dict[str, str]]:
    """The rows of a landmark metadata table (``train_metadata.csv``, ``val_metadata.csv``): ``path``,
    ``x1``..``y3`` and, where several views share the table, ``view``."""
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


class LandmarkDetectionDataset:
    """Landmark PNGs with Gaussian heatmap labels (the JAX package's ``LandmarkDetectionDataset``,
    cinema_tpu/data/datasets.py:288-336; reference segmentation/landmark/dataset.py).

    ``rows`` are metadata rows; where they have a ``view`` column only this view's are kept. Item ``i``:
    ``{view}_image`` (x, y, 1) float32 with the PNG's 0-255 intensities, ``{view}_label`` (x, y, 3) the
    Gaussian heatmaps (sigma 3) of the three landmarks, ``{view}_width`` and ``{view}_height`` int64. No
    transform: the image keeps its size and intensities.
    """

    def __init__(self, data_dir: Union[str, Path], rows: Sequence[Dict[str, str]], view: str) -> None:
        self.data_dir, self.view = Path(data_dir), view
        self.rows = [r for r in rows if r.get("view", view) == view]

    def __len__(self) -> int:
        return len(self.rows)

    def _image_and_coords(self, index: int):
        row = self.rows[index]
        image = read_png_gray(self.data_dir / row["path"])
        coords = np.array([[float(row[f"{a}{i}"]) for a in "xy"] for i in (1, 2, 3)], dtype=np.float32)
        return image, coords

    def _item(self, image: np.ndarray, **fields: np.ndarray) -> Dict[str, np.ndarray]:
        return {f"{self.view}_image": image[..., None], **fields,
                f"{self.view}_width": np.asarray(image.shape[0]), f"{self.view}_height": np.asarray(image.shape[1])}

    def load(self, index: int, epoch: int = 0) -> Dict[str, np.ndarray]:
        image, coords = self._image_and_coords(index)
        return self._item(image, **{f"{self.view}_label": gaussian_heatmap(image.shape, coords)})


class LandmarkRegressionDataset(LandmarkDetectionDataset):
    """Landmark PNGs with the coordinates as the label (the JAX package's ``LandmarkRegressionDataset``,
    cinema_tpu/data/datasets.py:339-360; reference regression/landmark/dataset.py): ``label`` (6,) float32
    [x1, y1, x2, y2, x3, y3] divided by the image's (width, height)."""

    def load(self, index: int, epoch: int = 0) -> Dict[str, np.ndarray]:
        image, coords = self._image_and_coords(index)
        scale = np.array(image.shape, np.float32)
        return self._item(image, label=(coords / scale).reshape(-1).astype(np.float32))
