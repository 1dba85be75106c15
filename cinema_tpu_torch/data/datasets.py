"""The datasets, the batch loader and the device prefetch of the task entry points (port of
cinema_tpu/data/datasets.py).

- The NIfTI datasets read the processed studies that the preprocessing writes (the JAX package's
  cinema_tpu/data/preprocess/ or the port's cinema_tpu_torch/data/preprocess/, byte for byte the same), one row
  of a metadata table per study (:func:`read_metadata`):
  the EDES datasets ``data_dir/<pid>/<pid>_<view>_{ed,es}.nii.gz`` and the ``_gt.nii.gz``
  labels beside them (ACDC, M&Ms, M&Ms2); :class:`CineSegmentationDataset` the frames of
  4-D cines ``<pid>/<view>_t.nii.gz`` (Rescan); :class:`EMIDECDataset` ``<pid>/<pid>.nii.gz``;
  :class:`MYOPS2020Dataset` three sequences ``<pid>/<pid>_{c0,de,t2}.nii.gz`` as channels;
  :class:`KaggleVideoDataset` whole cines ``<pid>/<pid>_<view>_t.nii.gz``. Each item is
  augmented by the task's transform with its own generator,
  ``np.random.default_rng([seed, epoch, index])``, as the JAX package's ``SeededItemRNG``
  draws it, so an item is a pure function of (seed, epoch, index).
- The landmark datasets read PNGs (``png.read_png_gray``, as PIL's ``convert("L")``) and their
  metadata tables; their items take no transform, as the JAX package's landmark tasks build them.
- :class:`UKBCineDataset` reads the pretraining studies that the UKB preprocessing writes
  (cinema_tpu/data/preprocess/ukb_dicom.py): ``<pid>/<pid>_<view>.nii.gz``, one 4-D cine per view,
  one random frame of each per item by a frame seek.
- :class:`BatchLoader` loads the items of a batch in worker threads or worker processes, and
  :func:`device_prefetch` copies its batches to the card ahead of the step that takes them.
"""

from __future__ import annotations

import csv
import multiprocessing
import re
from collections import deque
from concurrent.futures import Executor, Future, ProcessPoolExecutor, ThreadPoolExecutor
from pathlib import Path
from typing import Any, Callable, Deque, Dict, Iterable, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np

from cinema_tpu_torch.data.nifti import load_nifti, load_nifti_frame, load_nifti_header
from cinema_tpu_torch.data.png import read_png_gray

Sample = Dict[str, Any]
Transform = Callable[[Sample, np.random.Generator], Sample]
Rows = List[Dict[str, Optional[str]]]


def collate(items: Sequence[Sample]) -> Sample:
    """One batch of items: each array field stacked along a new leading axis, each string field
    (``pid``) a list."""
    return {key: [item[key] for item in items] if isinstance(items[0][key], str)
            else np.stack([item[key] for item in items]) for key in items[0]}


_WORKER_DATASET = None  # the dataset of a worker process, set once by its initializer


def _worker_init(dataset) -> None:
    global _WORKER_DATASET
    _WORKER_DATASET = dataset


def _worker_load(index: int, epoch: int) -> Sample:
    return _WORKER_DATASET.load(index, epoch)


class BatchLoader:
    """Batches of a dataset whose ``load(index, epoch)`` returns a dict of arrays (and strings).

    The order of an epoch is the JAX package's: ``np.random.default_rng(seed + epoch)`` shuffles
    it, and the incomplete last batch is dropped unless asked otherwise. ``n_workers`` threads,
    or with ``processes`` as many worker processes (``spawn``: a worker starts from a fresh
    import and never touches CUDA; the dataset is sent to it once), load the items while the
    consumer runs: ``depth`` batches and one item per worker ahead of it. Items depend on
    (seed, epoch, index) alone, so threads and processes give the same batches. A worker's
    exception is raised to the consumer. ``close`` stops the workers.

    ``process_shard`` (a distributed run): (rank, size) of this process on the mesh's data axis
    (``parallel.multihost.data_shard``); rank r of n loads its strided shard of the epoch's order,
    wrap-padded to equal length (``DistributedSampler``; the JAX package's ``process_shard``), so
    tensor-parallel peers, which share a data coordinate, load the same rows.
    """

    def __init__(self, dataset, batch_size: int, seed: int = 0, depth: int = 2, shuffle: bool = True,
                 drop_last: bool = True, n_workers: int = 1, processes: bool = False,
                 process_shard: Tuple[int, int] = (0, 1)) -> None:
        self.dataset, self.batch_size, self.seed, self.depth = dataset, batch_size, seed, depth
        self.shuffle, self.drop_last = shuffle, drop_last
        self.n_workers, self.processes = max(1, n_workers), processes
        self.shard = process_shard
        self._pool: Optional[Executor] = None

    def _n_items(self) -> int:
        return -(-len(self.dataset) // self.shard[1])

    def __len__(self) -> int:
        n = self._n_items()
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __enter__(self) -> "BatchLoader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        """Stop the workers and wait for them; the next epoch starts new ones."""
        if self._pool is not None:
            self._pool.shutdown(wait=True, cancel_futures=True)
            self._pool = None

    def _submit(self, index: int, epoch: int) -> Future:
        if self._pool is None:
            if self.processes:
                self._pool = ProcessPoolExecutor(self.n_workers, mp_context=multiprocessing.get_context("spawn"),
                                                 initializer=_worker_init, initargs=(self.dataset,))
            else:
                self._pool = ThreadPoolExecutor(self.n_workers)
        if self.processes:
            return self._pool.submit(_worker_load, index, epoch)
        return self._pool.submit(self.dataset.load, index, epoch)

    def epoch(self, epoch: int) -> Iterator[Sample]:
        """The batches of one epoch."""
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + epoch).shuffle(order)
        rank, world = self.shard
        if world > 1:
            order = np.resize(order, self._n_items() * world)[rank::world]
        indices = iter(order[: len(self) * self.batch_size].tolist())
        ahead = self.depth * self.batch_size + self.n_workers
        pending: Deque[Future] = deque()
        try:
            for b in range(len(self)):
                while len(pending) < ahead and (index := next(indices, None)) is not None:
                    pending.append(self._submit(index, epoch))
                n = min(self.batch_size, len(order) - b * self.batch_size)
                yield collate([pending.popleft().result() for _ in range(n)])
        finally:
            for future in pending:
                future.cancel()


def to_device(batch: Dict[str, Any], device) -> Dict[str, Any]:
    """The array entries of a loader batch as tensors on ``device``; string entries (``pid``) are dropped."""
    import torch  # here, not at the top: the loader's worker processes import this module and need no torch

    return {k: torch.from_numpy(v).to(device, non_blocking=True) for k, v in batch.items() if isinstance(v, np.ndarray)}


def device_prefetch(batches: Iterable[Sample], device, depth: int = 2) -> Iterator[Dict[str, Any]]:
    """The array entries of each batch as tensors on ``device``, ``depth`` batches copied ahead of the
    one the caller takes (the JAX package's ``device_prefetch``); string entries (``pid``) are dropped.

    On a CUDA device each batch is copied into a pinned host buffer and from there to the card on a
    copy stream, so the copy overlaps the step that runs on the caller's stream; the caller's stream
    waits for a batch's copy before it is handed out. The pinned buffers are a ring of ``depth + 1``
    slots: a slot is refilled only after the event recorded behind its last copy has completed. On
    another device each batch goes through :func:`to_device`.
    """
    import torch  # here, not at the top: the loader's worker processes import this module and need no torch

    device = torch.device(device)
    if device.type != "cuda":
        for batch in batches:
            yield to_device(batch, device)
        return
    copy_stream = torch.cuda.Stream(device)
    slots: List[Tuple[Dict[str, torch.Tensor], torch.cuda.Event]] = [
        ({}, torch.cuda.Event()) for _ in range(depth + 1)
    ]
    ahead: Deque[Tuple[Dict[str, torch.Tensor], torch.cuda.Event]] = deque()

    def hand_out():
        tensors, done = ahead.popleft()
        consumer = torch.cuda.current_stream(device)
        consumer.wait_event(done)
        for t in tensors.values():
            t.record_stream(consumer)  # the copy stream's allocation is in use on the consumer's stream
        return tensors

    for n, batch in enumerate(batches):
        pinned, done = slots[n % len(slots)]
        done.synchronize()  # this slot's previous copy has left its buffers
        tensors = {}
        with torch.cuda.stream(copy_stream):
            for key, value in batch.items():
                if not isinstance(value, np.ndarray):
                    continue
                host = torch.from_numpy(np.ascontiguousarray(value))
                buf = pinned.get(key)
                if buf is None or buf.shape != host.shape or buf.dtype != host.dtype:
                    buf = pinned[key] = torch.empty(host.shape, dtype=host.dtype, pin_memory=True)
                buf.copy_(host)
                tensors[key] = buf.to(device, non_blocking=True)
            done.record(copy_stream)
        ahead.append((tensors, done))
        if len(ahead) >= depth:
            yield hand_out()
    while ahead:
        yield hand_out()


def read_metadata(path: Union[str, Path]) -> Rows:
    """The rows of a metadata table (``train_metadata.csv``, ``val_metadata.csv``) as dicts of strings,
    ``None`` where a field is empty (pandas' missing value): ``pid`` stays a string, as
    ``pd.read_csv(..., dtype={"pid": str})`` reads it."""
    with open(path, newline="") as f:
        return [{k: v if v != "" else None for k, v in row.items()} for row in csv.DictReader(f)]


# pandas' default missing-value markers of ``read_csv`` (pandas._libs.parsers.STR_NA_VALUES)
_CSV_NA = frozenset({"", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND", "1.#QNAN", "<NA>",
                     "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null"})
_CSV_INT = re.compile(r"[+-]?\d+\Z")
_CSV_FLOAT = re.compile(r"[+-]?(\d+\.?\d*([eE][+-]?\d+)?|\.\d+([eE][+-]?\d+)?|inf|infinity)\Z", re.IGNORECASE)
_CSV_BOOL = {"True": True, "TRUE": True, "true": True, "False": False, "FALSE": False, "false": False}


def _typed_column(fields: Sequence[str]) -> List[Any]:
    """A column's fields typed as ``pd.read_csv`` types them: ints where every field is an integer; floats where
    every field present is a number (NaN where one is missing); bools where every field is one; else strings,
    NaN where a field is missing. A column with no field present is NaN throughout."""
    present = [f for f in fields if f not in _CSV_NA]
    if len(present) == len(fields) and all(_CSV_INT.match(f) for f in present):
        return [int(f) for f in fields]
    if all(_CSV_FLOAT.match(f) for f in present):
        return [float(f) if f not in _CSV_NA else float("nan") for f in fields]
    if len(present) == len(fields) and all(f in _CSV_BOOL for f in present):
        return [_CSV_BOOL[f] for f in fields]
    return [f if f not in _CSV_NA else float("nan") for f in fields]


def read_table(path: Union[str, Path], names: Optional[Sequence[str]] = None) -> Tuple[List[str], List[Dict[str, Any]]]:
    """(columns, rows) of a CSV table, each value typed as ``pd.read_csv(path)`` types it (see
    :func:`_typed_column`); with ``names``, the file has no header line and these are its columns, as
    ``pd.read_csv(path, header=None, names=names)`` reads it. Blank lines are skipped."""
    with open(path, newline="") as f:
        records = [r for r in csv.reader(f) if r]
    if names is None:
        names, records = (records[0], records[1:]) if records else ([], [])
    columns = [_typed_column([r[i] if i < len(r) else "" for r in records]) for i in range(len(names))]
    return list(names), [dict(zip(names, values)) for values in zip(*columns)]


def _is_missing(value: Any) -> bool:
    return value is None or (isinstance(value, (float, np.floating)) and np.isnan(value))


def _is_number(value: Any) -> bool:
    return isinstance(value, (int, float, np.integer, np.floating)) and not isinstance(value, (bool, np.bool_))


def iterrows(rows: Sequence[Dict[str, Any]]) -> Iterator[Dict[str, Any]]:
    """The rows of :func:`read_table` as ``DataFrame.iterrows`` hands them out: where every value is a number
    (no bool, no string; NaN counts as a float) and one is a float, each value comes as an ``np.float64``."""
    values = [v for row in rows for v in row.values()]
    upcast = all(_is_number(v) for v in values) and any(isinstance(v, (float, np.floating)) for v in values)
    for row in rows:
        yield {k: np.float64(v) for k, v in row.items()} if upcast else dict(row)


def _column_fields(values: Sequence[Any]) -> List[str]:
    """A column's values as pandas' ``to_csv`` writes the column that ``pd.DataFrame(rows)`` makes of them. The
    column's type decides: bools as ``True`` / ``False``; numbers as ints, or, where one is a float or one is
    missing, as float64 by ``repr`` (``70.0``); float32 (or float16) values alone in their type's shortest
    form; any other mix by ``str``. An empty field for None and NaN."""
    present = [v for v in values if not _is_missing(v)]
    if present and all(isinstance(v, (bool, np.bool_)) for v in present):
        kind = str
    elif present and all(_is_number(v) for v in present):
        narrow = {type(v) for v in present}
        if len(present) == len(values) and len(narrow) == 1 and narrow <= {np.float32, np.float16}:
            kind = str
        elif len(present) < len(values) or any(isinstance(v, (float, np.floating)) for v in present):
            kind = lambda v: repr(float(v))  # noqa: E731
        else:
            kind = lambda v: str(int(v))  # noqa: E731
    else:
        kind = str
    return ["" if _is_missing(v) else kind(v) for v in values]


def write_table(path: Union[str, Path], rows: Sequence[Dict[str, Any]], columns: Sequence[str] = ()) -> None:
    """Write dict rows as ``pd.DataFrame(rows).to_csv(path, index=False)`` writes them: the columns in the order
    they first appear (after ``columns``, which lead, as those of an empty frame or of the first frame of a
    ``pd.concat``), each column's values as :func:`_column_fields` formats them, an empty field where a row
    lacks one or holds None or NaN."""
    columns = list(dict.fromkeys([*columns, *(key for row in rows for key in row)]))
    fields = [_column_fields([row.get(c) for row in rows]) for c in columns]
    with open(path, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(columns)
        writer.writerows(zip(*fields))


def column_means(rows: Sequence[Dict[str, Any]], drop: Sequence[str] = ()) -> Dict[str, float]:
    """Each column's mean over the rows but the columns ``drop``, skipping missing and NaN values, as
    ``pd.DataFrame(rows).drop(columns=drop).mean(numeric_only=True)`` gives it: the NaN-free sum over the
    count (NaN where none)."""
    columns = [c for c in dict.fromkeys(key for row in rows for key in row) if c not in drop]
    means = {}
    for c in columns:
        values = np.array([np.nan if row.get(c) is None else float(row[c]) for row in rows], np.float64)
        count = int(np.sum(~np.isnan(values)))
        means[c] = float(np.nansum(values) / count) if count else float("nan")
    return means


def _check_meta(rows: Rows, cols: Sequence[str] = ("pid", "n_slices")) -> None:
    for col in cols:
        if rows and col not in rows[0]:
            raise ValueError(f"Column {col} is required in meta_df.")


def _load_view_image(pid_dir: Path, pid: str, view: str, frame_name: str) -> np.ndarray:
    return load_nifti(pid_dir / f"{pid}_{view}_{frame_name}.nii.gz")[0].astype(np.float32)


def _int(value: Optional[str]) -> int:
    return int(float(value))


class _RowsDataset:
    """The studies of ``rows`` under ``data_dir``; ``transform`` applied to each item with its own
    generator, ``np.random.default_rng([seed, epoch, index])``."""

    def __init__(self, data_dir: Union[str, Path], rows: Rows, transform: Optional[Transform] = None,
                 seed: int = 0) -> None:
        self.data_dir, self.rows = Path(data_dir), list(rows)
        self.transform, self.seed = transform, seed

    def __len__(self) -> int:
        return len(self.rows)

    def _rng(self, index: int, epoch: int) -> np.random.Generator:
        return np.random.default_rng([int(self.seed), int(epoch), int(index)])

    def _transformed(self, data: Sample, index: int, epoch: int) -> Sample:
        if self.transform:
            data = self.transform(data, self._rng(index, epoch))
        return data


class _EDESDataset(_RowsDataset):
    """The studies of ``rows`` under ``data_dir``, the views ``views`` of each."""

    def __init__(self, data_dir: Union[str, Path], rows: Rows, views: Union[str, Sequence[str]],
                 transform: Optional[Transform] = None, seed: int = 0) -> None:
        _check_meta(rows)
        super().__init__(data_dir, rows, transform, seed)
        self.views = [views] if isinstance(views, str) else list(views)

    def _ed_es_images(self, row: Dict[str, Optional[str]], data: Sample) -> Sample:
        """``{view}_image``: the ED and ES frames as two channels, (x, y, z, 2) for ``sax`` and
        (x, y, 2) for a ``lax_*`` view (its single slice)."""
        pid = str(row["pid"])
        for view in self.views:
            image = np.stack([_load_view_image(self.data_dir / pid, pid, view, f) for f in ("ed", "es")], axis=-1)
            data[f"{view}_image"] = image if view == "sax" else image[:, :, 0]
        return data


class EDESSegmentationDataset(_EDESDataset):
    """The ED and ES frames of each study with their labels (the JAX package's ``EDESSegmentationDataset``;
    reference segmentation/dataset.py:33-137). Item ``i`` is frame ``i % 2`` (0 ED, 1 ES) of study
    ``i // 2``: ``pid``, ``is_ed``, per view ``{view}_image`` (x, y[, z], 1) float32, ``{view}_label``
    (x, y[, z]) int8, ``{view}_width`` and ``{view}_height`` before the transform, and for ``sax``
    ``n_slices`` from the metadata."""

    def __len__(self) -> int:
        return 2 * len(self.rows)

    def load(self, index: int, epoch: int = 0) -> Sample:
        row = self.rows[index // 2]
        is_ed = index % 2 == 0
        pid = str(row["pid"])
        frame = "ed" if is_ed else "es"
        data: Sample = {"pid": pid, "is_ed": np.asarray(is_ed)}
        for view in self.views:
            image = _load_view_image(self.data_dir / pid, pid, view, frame)
            label, _ = load_nifti(self.data_dir / pid / f"{pid}_{view}_{frame}_gt.nii.gz")
            data[f"{view}_width"] = np.asarray(image.shape[0])
            data[f"{view}_height"] = np.asarray(image.shape[1])
            if view == "sax":
                data["n_slices"] = np.asarray(_int(row["n_slices"]))
            else:
                image, label = image[..., 0], label[..., 0]
            data[f"{view}_image"] = image[..., None]
            data[f"{view}_label"] = label.astype(np.int8)
        return self._transformed(data, index, epoch)


class EDESClassificationDataset(_EDESDataset):
    """ED and ES as two channels with the index of the study's ``class_col`` in ``classes`` as ``label``
    (the JAX package's ``EDESClassificationDataset``; reference classification/dataset.py:32-133)."""

    def __init__(self, data_dir: Union[str, Path], rows: Rows, class_col: str, classes: Sequence[str],
                 views: Union[str, Sequence[str]], transform: Optional[Transform] = None, seed: int = 0) -> None:
        super().__init__(data_dir, rows, views, transform, seed)
        self.class_col, self.classes = class_col, list(classes)

    def load(self, index: int, epoch: int = 0) -> Sample:
        row = self.rows[index]
        data: Sample = {"pid": str(row["pid"]), "label": np.asarray(self.classes.index(row[self.class_col]))}
        return self._transformed(self._ed_es_images(row, data), index, epoch)


class EDESRegressionDataset(_EDESDataset):
    """ED and ES as two channels with the study's ``reg_col`` z-normalised by ``reg_mean`` and ``reg_std`` as
    ``label`` (the JAX package's ``EDESRegressionDataset``; reference regression/dataset.py:22-133)."""

    def __init__(self, data_dir: Union[str, Path], rows: Rows, reg_col: str, reg_mean: float, reg_std: float,
                 views: Union[str, Sequence[str]], transform: Optional[Transform] = None, seed: int = 0) -> None:
        super().__init__(data_dir, rows, views, transform, seed)
        self.reg_col, self.reg_mean, self.reg_std = reg_col, reg_mean, reg_std

    def load(self, index: int, epoch: int = 0) -> Sample:
        row = self.rows[index]
        value = (float(row[self.reg_col]) - self.reg_mean) / self.reg_std
        data: Sample = {"pid": str(row["pid"]), "label": np.asarray(value, np.float32)}
        return self._transformed(self._ed_es_images(row, data), index, epoch)


class CineSegmentationDataset(_RowsDataset):
    """Single frames of 4-D cines with their labels (the JAX package's ``CineSegmentationDataset``;
    reference segmentation/rescan/dataset.py:22-130).

    ``rows`` need ``pid``, ``n_slices`` and ``n_frames``; the files are the Rescan preprocessing's
    ``<pid>/<view>_t.nii.gz`` and, for labelled rows, ``<pid>/<view>_gt_t.nii.gz``. Item ``i`` is frame
    ``t`` of study ``r`` for the i-th (r, t) of ``index_map`` (every frame of every study, at most
    ``max_n_frames`` of each), read alone (``load_nifti_frame``) and min-max scaled to [0, 1]:
    ``pid``, ``frame``, per view [``n_slices`` for ``sax``], ``{view}_width``, ``{view}_height``,
    ``{view}_image`` (x, y[, z], 1) float32 and ``{view}_label`` int8, or without labels the row's
    ``edv``, ``esv`` and ``ef`` where the table has them (NaN where a field is empty).
    """

    def __init__(self, data_dir: Union[str, Path], rows: Rows, views: Union[str, Sequence[str]] = "sax",
                 has_labels: bool = True, transform: Optional[Transform] = None,
                 max_n_frames: Optional[int] = None, seed: int = 0) -> None:
        _check_meta(rows, ("pid", "n_slices", "n_frames"))
        super().__init__(data_dir, rows, transform, seed)
        self.views = [views] if isinstance(views, str) else list(views)
        if has_labels and set(self.views) != {"sax"}:
            raise ValueError(f"Only the SAX view has labels, got {self.views}.")
        self.has_labels = has_labels
        self.index_map: List[Tuple[int, int]] = []
        for r, row in enumerate(self.rows):
            n_frames = _int(row["n_frames"])
            if max_n_frames is not None:
                n_frames = min(n_frames, max_n_frames)
            self.index_map += [(r, t) for t in range(n_frames)]

    def __len__(self) -> int:
        return len(self.index_map)

    def load(self, index: int, epoch: int = 0) -> Sample:
        r, t = self.index_map[index]
        row = self.rows[r]
        pid = str(row["pid"])
        data: Sample = {"pid": pid, "frame": np.asarray(t)}
        for view in self.views:
            image = load_nifti_frame(self.data_dir / pid / f"{view}_t.nii.gz", t)[0].astype(np.float32)
            v_min, v_max = float(image.min()), float(image.max())
            if v_max > v_min:
                image = (image - v_min) / (v_max - v_min)
            if view == "sax":
                data["n_slices"] = np.asarray(_int(row["n_slices"]))
            else:
                image = image[..., 0]
            data[f"{view}_width"] = np.asarray(image.shape[0])
            data[f"{view}_height"] = np.asarray(image.shape[1])
            data[f"{view}_image"] = image[..., None]
            if self.has_labels:
                label = load_nifti_frame(self.data_dir / pid / f"{view}_gt_t.nii.gz", t)[0]
                data[f"{view}_label"] = label.astype(np.int8)
            else:
                for col in ("edv", "esv", "ef"):
                    if col in row:
                        data[col] = np.asarray(float("nan") if row[col] is None else float(row[col]))
        return self._transformed(data, index, epoch)


class _VolumeDataset(_RowsDataset):
    """One SAX volume per study with its label where ``<pid>/<pid>_gt.nii.gz`` exists; ``_image`` reads
    the (x, y, z, ch) image of a study."""

    views = ["sax"]

    def __init__(self, data_dir: Union[str, Path], rows: Rows, transform: Optional[Transform] = None,
                 seed: int = 0) -> None:
        _check_meta(rows)
        super().__init__(data_dir, rows, transform, seed)

    def _pid(self, row: Dict[str, Optional[str]]) -> str:
        return str(row["pid"])

    def _image(self, pid_dir: Path, pid: str) -> np.ndarray:
        raise NotImplementedError

    def load(self, index: int, epoch: int = 0) -> Sample:
        row = self.rows[index]
        pid = self._pid(row)
        pid_dir = self.data_dir / pid
        image = self._image(pid_dir, pid)
        data: Sample = {"pid": pid, "sax_width": np.asarray(image.shape[0]), "sax_height": np.asarray(image.shape[1]),
                        "n_slices": np.asarray(_int(row["n_slices"])), "sax_image": image}
        gt_path = pid_dir / f"{pid}_gt.nii.gz"
        if gt_path.exists():
            data["sax_label"] = load_nifti(gt_path)[0].astype(np.int8)
        return self._transformed(data, index, epoch)


class EMIDECDataset(_VolumeDataset):
    """EMIDEC delayed-enhancement studies (the JAX package's ``EMIDECDataset``; reference
    segmentation/emidec/train.py:34-115): ``<pid>/<pid>.nii.gz`` and ``<pid>/<pid>_gt.nii.gz``. Item:
    ``pid``, ``sax_width``, ``sax_height``, ``n_slices``, ``sax_image`` (x, y, z, 1) float32 and
    ``sax_label`` int8."""

    def _image(self, pid_dir: Path, pid: str) -> np.ndarray:
        return load_nifti(pid_dir / f"{pid}.nii.gz")[0].astype(np.float32)[..., None]


class MYOPS2020Dataset(_VolumeDataset):
    """MyoPS2020 studies, bSSFP, LGE and T2 as three channels (the JAX package's ``MYOPS2020Dataset``;
    reference segmentation/myops2020/train.py:34-120): ``<pid>/<pid>_{c0,de,t2}.nii.gz`` and
    ``<pid>/<pid>_gt.nii.gz``, ``pid`` the table's as an integer (``"0101"`` is study ``101``, as pandas
    reads it). Item: as :class:`EMIDECDataset`'s, ``sax_image`` (x, y, z, 3)."""

    def _pid(self, row: Dict[str, Optional[str]]) -> str:
        return str(int(row["pid"]))

    def _image(self, pid_dir: Path, pid: str) -> np.ndarray:
        return np.stack([load_nifti(pid_dir / f"{pid}_{seq}.nii.gz")[0] for seq in ("c0", "de", "t2")],
                        axis=-1).astype(np.float32)


class KaggleVideoDataset(_RowsDataset):
    """Whole cines of the Kaggle Data Science Bowl for the label-free EF evaluation (the JAX package's
    ``KaggleVideoDataset``; reference segmentation/kaggle/dataset.py:24-115).

    ``rows`` need ``pid`` (an integer), ``n_slices``, ``n_frames``, ``diastole_volume`` and
    ``systole_volume``; the file is ``<pid>/<pid>_<view>_t.nii.gz`` (x, y, z, t). Item: ``pid``,
    ``n_slices``, ``n_frames``, ``edv``, ``esv``, ``ef`` (float32) and ``{view}_image`` (t, x, y[, z], 1)
    float32 of the first ``max_n_frames`` frames, zero frames appended up to ``max_n_frames``. The
    transform sees the video with time as the channel axis, (x, y[, z], t).
    """

    def __init__(self, data_dir: Union[str, Path], rows: Rows, view: str, max_n_frames: int,
                 transform: Optional[Transform] = None, seed: int = 0) -> None:
        if view not in {"sax", "lax_2c", "lax_4c"}:
            raise ValueError(f"Invalid view {view}.")
        super().__init__(data_dir, rows, transform, seed)
        self.view, self.max_n_frames = view, max_n_frames

    def load(self, index: int, epoch: int = 0) -> Sample:
        row = self.rows[index]
        pid = str(int(row["pid"]))
        video = np.moveaxis(load_nifti(self.data_dir / pid / f"{pid}_{self.view}_t.nii.gz")[0], -1, 0)
        if self.view != "sax":
            video = video[..., 0]
        video = video[: self.max_n_frames].astype(np.float32)
        edv, esv = float(row["diastole_volume"]), float(row["systole_volume"])
        data: Sample = {"pid": pid, "n_slices": np.asarray(_int(row["n_slices"])),
                        "n_frames": np.asarray(_int(row["n_frames"])), "edv": np.asarray(edv, np.float32),
                        "esv": np.asarray(esv, np.float32), "ef": np.asarray((edv - esv) / edv * 100.0, np.float32)}
        if self.transform:
            key = f"{self.view}_image"
            video = np.moveaxis(self.transform({key: np.moveaxis(video, 0, -1)}, self._rng(index, epoch))[key], -1, 0)
        if video.shape[0] < self.max_n_frames:
            video = np.concatenate([video, np.zeros((self.max_n_frames - video.shape[0], *video.shape[1:]),
                                                    video.dtype)])
        data[f"{self.view}_image"] = video[..., None]
        return data


def find_view_file(pid_dir: Path, pid: str, view: str) -> Optional[Path]:
    """A study's 4-D NIfTI of ``view``: ``<pid>_<view>_t.nii.gz`` (the bundled demos), ``<pid>_<view>_t.nii``,
    ``<pid>_<view>.nii.gz`` (the UKB preprocessing) or ``<pid>_<view>.nii``, the first that exists; None if
    none does."""
    for name in (f"{pid}_{view}_t.nii.gz", f"{pid}_{view}_t.nii", f"{pid}_{view}.nii.gz", f"{pid}_{view}.nii"):
        path = pid_dir / name
        if path.exists():
            return path
    return None


class UKBCineDataset(_RowsDataset):
    """The pretraining studies ``pids`` under ``data_dir``, kept as ``rows`` (the JAX package's
    ``UKBCineDataset``; reference mae/pretrain.py:88-154). Item ``i``: ``pid`` and per view of ``views`` one random frame of its 4-D cine,
    (x, y, z, 1) for ``sax`` and (x, y, 1) for a ``lax_*`` view (its single slice), float32, read by a frame
    seek; then the transform. The item's generator draws each view's frame in view order and then
    drives the transform."""

    def __init__(self, data_dir: Union[str, Path], pids: Sequence[str],
                 views: Sequence[str] = ("sax", "lax_2c", "lax_3c", "lax_4c"), transform: Optional[Transform] = None,
                 seed: int = 0) -> None:
        super().__init__(data_dir, list(pids), transform, seed)
        self.views = list(views)

    def load(self, index: int, epoch: int = 0) -> Sample:
        pid = self.rows[index]
        pid_dir = self.data_dir / pid
        rng = self._rng(index, epoch)
        data: Sample = {"pid": pid}
        for view in self.views:
            path = find_view_file(pid_dir, pid, view)
            if path is None:
                raise FileNotFoundError(f"No 4D NIfTI for view {view} in {pid_dir}.")
            t = int(rng.integers(0, load_nifti_header(path).shape[-1]))
            frame, _ = load_nifti_frame(path, t)
            if view != "sax":
                frame = frame[:, :, 0]
            data[view] = frame.astype(np.float32)[..., None]
        return self.transform(data, rng) if self.transform else data


def gaussian_heatmap(shape: Sequence[int], centers: np.ndarray, sigma: float = 3.0) -> np.ndarray:
    """Gaussian heatmaps of landmarks (reference segmentation/landmark/dataset.py:19-38): (w, h) and
    (n, 2) centres -> (w, h, n) float32 in [0, 1], 1 at a centre on the grid."""
    w, h = shape
    xs, ys = np.meshgrid(np.arange(w), np.arange(h), indexing="ij")
    maps = [np.exp(-((xs - cx) ** 2 + (ys - cy) ** 2) / (2 * sigma**2)) for cx, cy in centers]
    return np.stack(maps, axis=-1).astype(np.float32)


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
