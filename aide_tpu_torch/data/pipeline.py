"""Host-side data pipeline: decode-once cache, batching, working labels.

An own copy of ``aide_tpu.data.pipeline`` for one device. Every slice is
decoded, resized and reduced ONCE to uint8 pixels plus per-image affine
normalization coefficients (normalized = u8 * scale + fill, applied on the
device by ``engine.steps.batch_images``); epochs only index into the arrays.
``to_device`` uploads them once and gathers each batch on the device by
index. The per-net working labels live in a LabelStore, which starts from
the targets, takes any refreshed labels already mirrored to disk, and
mirrors each refresh back to disk; ``sync_labels_to_device`` then copies
the refreshed rows into the device copy.

Over a data axis of N > 1 shards (``core.mesh``) every rank decodes the
whole set and keeps the whole LabelStore, but a batch is only its shard's
rows of the global batch (``mesh.local_rows``): the host-batch path slices
the indices, and the device-resident path is a ``ShardedCache``, the
counterpart of the JAX package's ``MeshCache``, where each shard holds a
contiguous block of the rows and one collective of its data group
assembles a batch. On a net axis both ranks of a pair hold the same rows
and the working labels of both nets. On a live space axis the cache keeps
whole images (as ``MeshCache.put`` does), and a batch that the data axis
divides (or any batch at data size 1) comes back with this rank's H rows
of each image-like leaf (``mesh.shard_h``); a ragged batch, replicated
over the data axis, keeps whole images, as in the JAX package. Only the
primary rank mirrors refreshed labels to disk.

With a ``cache_dir``, the decoded arrays are kept in a keyed npz file there
(``decode_cache_path``), under the JAX package's key and array names, so a
cache written by either package serves the other.
"""

from __future__ import annotations

import glob
import hashlib
import os
import zipfile
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from aide_tpu_torch.core import mesh, trace
from aide_tpu_torch.data.tasks.base import SliceSpec, Task, resize_image, resize_mask


def decode_cache_path(
    cache_dir: str, task: Task, specs: Sequence[SliceSpec], img_size: int, data_mean, data_std,
) -> Tuple[str, str]:
    """(prefix, file) of the decode cache of these specs, keyed as
    ``aide_tpu.data.pipeline.SlicePipeline`` keys it: an identity (the
    task's decode fingerprint, the specs' reprs, the size and the fixed
    stats) and a content signature (size and mtime of every source file).

    The signature stats the spec paths as given. The real tasks' paths are
    relative to ``task.root``, so unless the working directory is the root
    every file reads "?" and a re-annotated mask at the same path does not
    invalidate the cache: the JAX package's behaviour, ported as it is."""

    def stat_sig(spec: SliceSpec) -> str:
        sig = []
        for p in list(spec.image_paths) + [spec.mask_path]:
            try:
                st = os.stat(p)
                sig.append(f"{st.st_size}:{st.st_mtime_ns}")
            except OSError:
                sig.append("?")
        return ",".join(sig)

    id_key = hashlib.sha1(
        "|".join(
            [task.decode_fingerprint()]
            + [repr(s) for s in specs]
            + [str(img_size), str(data_mean), str(data_std)]
        ).encode()
    ).hexdigest()[:16]
    stat_key = hashlib.sha1("|".join(stat_sig(s) for s in specs).encode()).hexdigest()[:16]
    prefix = os.path.join(cache_dir, f"decode_{id_key}_")
    return prefix, f"{prefix}{stat_key}.npz"


class LabelStore:
    """Per-net working labels (N, H, W) and their disk mirror via the task."""

    def __init__(self, task: Task, specs: Sequence[SliceSpec], targets: np.ndarray):
        self.task = task
        self.specs = list(specs)
        size = targets.shape[1]
        self.labels = [targets.copy(), targets.copy()]  # net 1, net 2
        # rows changed since the last device sync (sync_labels_to_device)
        self.dirty: List[List[int]] = [[], []]
        # pick up refreshed labels already on disk (resume / interop)
        for net in (1, 2):
            for i, spec in enumerate(self.specs):
                disk = task.read_tempmask(spec, net)
                if disk is not None:
                    if disk.shape != targets.shape[1:]:
                        disk = resize_mask(disk, size)
                    self.labels[net - 1][i] = disk

    def get(self, net: int) -> np.ndarray:
        return self.labels[net - 1]

    def refresh_case(self, net: int, indices: Sequence[int], volume: np.ndarray,
                     mirror: bool = True) -> None:
        """Replace one case's working labels (``indices`` into the slice
        table, ``volume`` (S, H, W) binary at img_size) and, with
        ``mirror``, write them to disk."""
        lab = self.labels[net - 1]
        for i, sl in zip(indices, volume):
            lab[i] = sl.astype(np.uint8)
        self.dirty[net - 1].extend(int(i) for i in indices)
        if mirror and self.task.tempmask_folder:
            specs = [self.specs[i] for i in indices]
            with trace.span("refresh.write"):
                self.task.write_case_tempmask(specs, volume.astype(np.uint8), net)


def _widen_targets(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    for k in ("target", "target1", "target2"):
        if k in batch:
            batch[k] = batch[k].to(torch.int64)
    return batch


class ShardedCache:
    """The decode-once arrays on the cards of a data axis, sharded by rows.

    The counterpart of the JAX package's ``MeshCache``: the rows are padded
    to a multiple of N data shards (repeating the last), and the ranks of
    shard d keep rows [d*R, (d+1)*R), R = ceil(n/N), every array of a row
    packed side by side
    as bytes in one (R, row bytes) uint8 matrix, the images' columns first
    and the labels' last. A batch of global indices is gathered in one
    collective: each rank serves the rows it owns and zeros elsewhere, and
    the sum over ranks (exact: one contributor is nonzero) is
    reduce-scattered when N divides the batch (each rank receives its own
    rows) or all-reduced otherwise (every rank the whole batch, as the
    ragged final eval batch needs), all over the rank's data group. The
    dataset itself never moves. Refreshed label rows are written by the
    ranks that own them."""

    def __init__(self, arrays: Dict[str, np.ndarray], device):
        n_dev, r = mesh.data_size(), mesh.data_rank()
        n = next(iter(arrays.values())).shape[0]
        self.shard = -(-n // n_dev)
        self.lo = r * self.shard
        rows = np.clip(np.arange(self.lo, self.lo + self.shard), 0, n - 1)
        # images and coefficients first, targets and working labels last:
        # inference gathers a prefix of the columns
        keys = sorted(arrays, key=lambda k: k.startswith("target"))
        self.layout = {}
        cols, col = [], 0
        for k in keys:
            a = np.ascontiguousarray(arrays[k][rows])
            b = a.reshape(self.shard, -1).view(np.uint8)
            self.layout[k] = (torch.from_numpy(a).dtype, a.shape[1:], col, col + b.shape[1])
            col += b.shape[1]
            cols.append(b)
        self.image_cols = max(
            (stop for k, (_, _, _, stop) in self.layout.items() if not k.startswith("target")),
            default=0)
        self.data = torch.from_numpy(np.concatenate(cols, axis=1)).to(device)

    def gather(self, idx: np.ndarray, images_only: bool = False) -> Dict[str, torch.Tensor]:
        """This rank's rows (``mesh.local_rows``) of the batch of global
        indices ``idx``, unpacked; a collective."""
        b = len(idx)
        i = torch.from_numpy(np.asarray(idx, np.int64)).to(self.data.device)
        rel = i - self.lo
        own = (rel >= 0) & (rel < self.shard)
        width = self.image_cols if images_only else self.data.shape[1]
        part = self.data[:, :width].index_select(0, rel.clamp(0, self.shard - 1))
        part = part * own.to(torch.uint8)[:, None]
        if mesh.rows_sharded(b):
            out = part.new_empty((b // mesh.data_size(), width))
            mesh.reduce_scatter(out, part, kind="cache")
        else:
            out = part
            mesh.all_reduce(out, kind="cache")
        batch = {}
        for k, (dtype, shape, start, stop) in self.layout.items():
            if stop <= width:
                flat = out[:, start:stop].contiguous().view(dtype)
                batch[k] = flat.reshape((out.shape[0],) + tuple(shape))
        return _widen_targets(batch)

    def scatter(self, key: str, idx: Sequence[int], rows: np.ndarray) -> None:
        """Write the rows ``rows`` of array ``key`` at global indices
        ``idx`` where this rank owns them."""
        _, shape, start, stop = self.layout[key]
        rel = np.asarray(idx, np.int64) - self.lo
        own = (rel >= 0) & (rel < self.shard)
        if not own.any():
            return
        vals = np.ascontiguousarray(rows[own]).reshape(int(own.sum()), -1).view(np.uint8)
        at = torch.from_numpy(rel[own]).to(self.data.device)
        self.data[at, start:stop] = torch.from_numpy(vals).to(self.data.device)

    def rows(self, key: str) -> torch.Tensor:
        """This rank's block of rows of ``key`` (the padding included)."""
        dtype, shape, start, stop = self.layout[key]
        return self.data[:, start:stop].contiguous().view(dtype).reshape((self.shard,) + tuple(shape))


class SlicePipeline:
    def __init__(
        self,
        task: Task,
        specs: Sequence[SliceSpec],
        img_size: int,
        data_mean: Optional[Sequence[float]] = None,
        data_std: Optional[Sequence[float]] = None,
        working_labels: bool = False,
        cache_dir: Optional[str] = None,
    ):
        self.task = task
        self.specs = list(specs)
        self.img_size = img_size
        n = len(self.specs)
        if n == 0:
            raise ValueError("empty manifest")
        n_mod = 2 if task.two_modal else 1
        cache_file = None
        if cache_dir:
            self._cache_prefix, cache_file = decode_cache_path(
                cache_dir, task, self.specs, img_size, data_mean, data_std)
            if os.path.exists(cache_file) and self._load_cache(cache_file, n_mod):
                self._finish_init(working_labels)
                return
        self._decode_all(n_mod, data_mean, data_std)
        if cache_file:
            self._write_cache(cache_file, n_mod)
        self._finish_init(working_labels)

    def _decode_all(self, n_mod: int, data_mean, data_std) -> None:
        """Decode, resize and reduce every slice to uint8 pixels and its
        normalization coefficients."""
        n, img_size = len(self.specs), self.img_size
        self.images = [np.zeros((n, img_size, img_size, 3), np.uint8) for _ in range(n_mod)]
        self.scales = [np.zeros((n, 3), np.float32) for _ in range(n_mod)]
        self.fills = [np.zeros((n, 3), np.float32) for _ in range(n_mod)]
        self.targets = np.zeros((n, img_size, img_size), np.uint8)

        fixed = data_mean is not None
        mean_arr = np.asarray(data_mean, np.float32) if fixed else None
        std_arr = np.asarray(data_std, np.float32) if fixed else None
        for i, spec in enumerate(self.specs):
            imgs, mask = self.task.decode(spec)
            for m, img in enumerate(imgs):
                resized_u8 = resize_image(img, img_size).astype(np.uint8)
                resized = resized_u8.astype(np.float32) / 255.0
                if fixed:
                    mean, std = mean_arr, std_arr
                else:
                    # per-image channel stats, N-1 std (torch's estimator)
                    mean = resized.mean(axis=(0, 1))
                    std = resized.std(axis=(0, 1), ddof=1)
                std = np.maximum(std, 1e-6)
                self.images[m][i] = resized_u8
                self.scales[m][i] = 1.0 / (255.0 * std)
                self.fills[m][i] = -mean / std
            self.targets[i] = resize_mask(mask, img_size)

    def _load_cache(self, cache_file: str, n_mod: int) -> bool:
        """Take the arrays from a cache file; False (and the file removed)
        when it cannot be read, e.g. truncated by a crash."""
        try:
            with np.load(cache_file) as z:
                self.images = [z[f"images{m}"] for m in range(n_mod)]
                self.scales = [z[f"scales{m}"] for m in range(n_mod)]
                self.fills = [z[f"fills{m}"] for m in range(n_mod)]
                self.targets = z["targets"]
            return True
        except (OSError, ValueError, KeyError, EOFError, zipfile.BadZipFile, zlib.error):
            try:
                os.remove(cache_file)
            except OSError:
                pass
            return False

    def _write_cache(self, cache_file: str, n_mod: int) -> None:
        """Write the arrays to a temporary file and rename it into place, so
        an interrupted write leaves no truncated cache; then remove the
        files of the same identity under an older content signature."""
        os.makedirs(os.path.dirname(cache_file), exist_ok=True)
        arrays = {"targets": self.targets}
        for m in range(n_mod):
            arrays[f"images{m}"] = self.images[m]
            arrays[f"scales{m}"] = self.scales[m]
            arrays[f"fills{m}"] = self.fills[m]
        # one temporary name a process: the ranks of a data axis decode
        # and write the same cache side by side
        tmp = f"{cache_file}.{os.getpid()}.tmp.npz"
        np.savez(tmp, **arrays)
        os.replace(tmp, cache_file)
        # the pre-signature name decode_<id>.npz is stale too
        legacy = f"{self._cache_prefix.rstrip('_')}.npz"
        for stale in glob.glob(f"{self._cache_prefix}*.npz") + [legacy]:
            if os.path.abspath(stale) == os.path.abspath(cache_file):
                continue
            try:
                os.remove(stale)
            except OSError:
                pass

    def _finish_init(self, working_labels: bool) -> None:
        self.case_slices: Dict[str, List[int]] = {}
        for i, spec in enumerate(self.specs):
            self.case_slices.setdefault(spec.case_id, []).append(i)
        for idxs in self.case_slices.values():
            idxs.sort(key=lambda i: self.specs[i].sort_key)
        self.cases = list(self.case_slices)
        self.labels: Optional[LabelStore] = (
            LabelStore(self.task, self.specs, self.targets) if working_labels else None
        )
        self._device_data: Optional[Dict[str, torch.Tensor]] = None
        self._device_labels: Optional[Dict[str, torch.Tensor]] = None
        self._sharded: Optional[ShardedCache] = None

    def __len__(self) -> int:
        return len(self.specs)

    # ------------------------- device residency -------------------------

    def _host_arrays(self) -> Dict[str, np.ndarray]:
        if self.task.two_modal:
            return {
                "modal1": self.images[0], "modal2": self.images[1],
                "scale1": self.scales[0], "scale2": self.scales[1],
                "fill1": self.fills[0], "fill2": self.fills[1],
                "target": self.targets,
            }
        return {
            "image": self.images[0], "scale": self.scales[0],
            "fill": self.fills[0], "target": self.targets,
        }

    def to_device(self, device) -> None:
        """Upload the decode-once cache and the working labels to ``device``
        ONCE (uint8 pixels and targets, f32 coefficients); later batches are
        gathered there by index, so an epoch moves only index vectors to the
        device. Over a data axis of N > 1 shards each rank uploads its
        shard's block of the rows (``ShardedCache``)."""
        if mesh.data_size() > 1:
            arrays = self._host_arrays()
            if self.labels is not None:
                arrays.update({f"target{net}": self.labels.get(net) for net in (1, 2)})
                self.labels.dirty = [[], []]
            self._sharded = ShardedCache(arrays, device)
            return
        self._device_data = {
            k: torch.from_numpy(v).to(device) for k, v in self._host_arrays().items()
        }
        if self.labels is not None:
            self._device_labels = {
                f"target{net}": torch.from_numpy(self.labels.get(net)).to(device)
                for net in (1, 2)
            }
            self.labels.dirty = [[], []]

    @property
    def device_image_data(self) -> Optional[Dict[str, torch.Tensor]]:
        """The device-resident image arrays (no targets or labels): the data
        argument of ``engine.steps.make_predict_all``. None unless
        ``to_device`` was called."""
        if self._device_data is None:
            return None
        return {k: v for k, v in self._device_data.items() if not k.startswith("target")}

    def sync_labels_to_device(self) -> None:
        """Copy the working-label rows changed on the host (``refresh_case``)
        into the device copy, one ``index_copy_`` a net (the owning rank's
        rows of a ``ShardedCache``). Without a device copy it only clears
        the record of changed rows."""
        if self.labels is None:
            return
        if self._sharded is not None:
            for net in (1, 2):
                idx = self.labels.dirty[net - 1]
                if idx:
                    self._sharded.scatter(f"target{net}", idx, self.labels.get(net)[idx])
        if self._device_labels is not None:
            for net in (1, 2):
                idx = self.labels.dirty[net - 1]
                if not idx:
                    continue
                dev = self._device_labels[f"target{net}"]
                rows = torch.from_numpy(self.labels.get(net)[idx]).to(dev.device)
                dev.index_copy_(0, torch.tensor(idx, dtype=torch.int64, device=dev.device), rows)
        self.labels.dirty = [[], []]

    # ------------------------- batching -------------------------

    def _batch_from(self, idx: np.ndarray, images_only: bool = False) -> Dict[str, torch.Tensor]:
        """The batch of global slice indices ``idx``: this rank's rows of it
        over a data axis (``mesh.local_rows``), all of them on one rank; its
        H rows on a live space axis (``mesh.h_sharded``)."""
        batch = self._rows_from(idx, images_only)
        if not mesh.h_sharded(len(idx)):
            return batch
        return {k: v.contiguous() for k, v in mesh.shard_h(batch).items()}

    def _rows_from(self, idx: np.ndarray, images_only: bool) -> Dict[str, torch.Tensor]:
        if self._sharded is not None:
            return self._sharded.gather(idx, images_only)
        idx = np.asarray(idx)[mesh.local_rows(len(idx))]
        if self._device_data is not None:
            data = dict(self._device_data)
            if self._device_labels is not None:
                data.update(self._device_labels)
            if images_only:
                # inference never reads the labels: do not gather them
                data = {k: v for k, v in data.items() if not k.startswith("target")}
            device = next(iter(data.values())).device
            i = torch.from_numpy(np.asarray(idx, np.int64)).to(device)
            return _widen_targets({k: v.index_select(0, i) for k, v in data.items()})
        batch = {k: torch.from_numpy(v[idx]) for k, v in self._host_arrays().items()}
        if images_only:
            return {k: v for k, v in batch.items() if k != "target"}
        if self.labels is not None:
            batch["target1"] = torch.from_numpy(self.labels.get(1)[idx])
            batch["target2"] = torch.from_numpy(self.labels.get(2)[idx])
        return _widen_targets(batch)

    def batches(
        self,
        batch_size: int,
        rng: Optional[np.random.Generator] = None,
        shuffle: bool = True,
        drop_last: bool = True,
    ):
        """Epoch iterator: shuffle with ``rng`` and drop the ragged tail."""
        n = len(self.specs)
        order = np.arange(n)
        if shuffle:
            if rng is None:
                rng = np.random.default_rng(0)
            rng.shuffle(order)
        end = (n // batch_size) * batch_size if drop_last else n
        for s in range(0, end, batch_size):
            yield self._batch_from(order[s : s + batch_size])

    def steps_per_epoch(self, batch_size: int, drop_last: bool = True) -> int:
        n = len(self.specs)
        return n // batch_size if drop_last else -(-n // batch_size)

    # ------------------------- case access -------------------------

    def case_indices(self, case_id: str) -> List[int]:
        return self.case_slices[str(case_id)]

    def batch_at(self, indices, images_only: bool = False) -> Dict[str, torch.Tensor]:
        """The batch of explicit slice indices (packed case eval);
        ``images_only`` leaves out the targets and working labels."""
        return self._batch_from(np.asarray(indices), images_only=images_only)

    def case_targets(self, case_id: str, net: Optional[int] = None) -> np.ndarray:
        """(S, H, W) stacked working labels of ``net`` (ground truth for None)."""
        idxs = self.case_indices(case_id)
        src = self.targets if net is None else self.labels.get(net)
        return src[idxs]
