"""Input pipeline: decode -> geometry -> fixed-shape batches -> device (the
port of synchformer_tpu/data/pipeline.py).

- per-epoch deterministic global shuffle, sharded by process
  (DistributedSampler semantics: each process sees a disjoint 1/P slice,
  reshuffled by (seed, epoch)); EpochSampler and SyncDataLoader are the JAX
  package's, so they give the same batches from the same seed
- a thread pool runs decode (media.py) + host geometry (transforms.py),
  both GIL-light (libav releases the GIL; numpy slicing is trivial)
- fixed-shape batch assembly: every batch is (B, S, 16, H, W, 3) uint8 +
  (B, S, seg_a) f32 + targets; the C++ staging runtime (native/avstage)
  does the segment gathers when built, with a numpy fallback
- StagedLoader: a staging thread copies each device-bound key into pinned
  host memory and onto the card on a side CUDA stream, so the transfer of
  batch k+1 rides under the compute of batch k (the reference's pin_memory +
  non_blocking copies, ref: scripts/train_utils.py:359-371)
"""
from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from synchformer_tpu_torch.data.datasets import AVClipDataset, ClipRecord
from synchformer_tpu_torch.data.media import get_video_and_audio
from synchformer_tpu_torch.data.transforms import SyncPipelineConfig, prepare_item

# the keys a training step reads on the device
DEVICE_KEYS = ("video", "audio", "audio_full", "audio_seg_starts")


class EpochSampler:
    """Deterministic per-epoch order, sharded across processes
    (DistributedSampler parity: ref train_utils.py:167-182)."""

    def __init__(self, n_items: int, shuffle: bool, seed: int = 1337,
                 process_index: int = 0, process_count: int = 1,
                 drop_last: bool = True):
        self.n_items = n_items
        self.shuffle = shuffle
        self.seed = seed
        self.process_index = process_index
        self.process_count = process_count
        self.drop_last = drop_last

    def indices(self, epoch: int) -> np.ndarray:
        order = np.arange(self.n_items)
        if self.shuffle:
            order = np.random.default_rng(self.seed + epoch).permutation(self.n_items)
        per = self.n_items // self.process_count
        if self.drop_last:
            order = order[: per * self.process_count]
        return order[self.process_index::self.process_count]


class SyncDataLoader:
    """Threaded prefetching loader producing fixed-shape numpy batches."""

    def __init__(self, dataset: AVClipDataset, pipeline_cfg: SyncPipelineConfig,
                 batch_size: int, num_workers: int = 6, seed: int = 1337,
                 shuffle: Optional[bool] = None, drop_last: bool = True,
                 process_index: int = 0, process_count: int = 1,
                 prefetch: int = 2, decode_backend: Optional[str] = None):
        self.dataset = dataset
        self.cfg = pipeline_cfg
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.seed = seed
        self.split = dataset.split
        self.shuffle = (dataset.split == "train") if shuffle is None else shuffle
        self.decode_backend = decode_backend
        self.sampler = EpochSampler(len(dataset), self.shuffle, seed,
                                    process_index, process_count, drop_last)
        self.prefetch = prefetch
        self._epoch = 0

    def set_epoch(self, epoch: int):
        """ref: train_sync.py:127-128 sampler.set_epoch."""
        self._epoch = epoch

    def __len__(self):
        return len(self.sampler.indices(0)) // self.batch_size

    def _load_one(self, idx: int, item_seed: int) -> Dict[str, np.ndarray]:
        rec: ClipRecord = self.dataset[idx]
        video, audio, meta = get_video_and_audio(
            rec.path, end_sec=self.dataset.max_clip_len_sec,
            backend=self.decode_backend)
        rng = np.random.default_rng(item_seed)
        fixed = rec.fixed_offset or {}
        out = prepare_item(
            video, audio, self.cfg, rng, split=self.split,
            fixed_offset_sec=fixed.get("offset_sec"),
            fixed_v_start_sec=fixed.get("v_start_i_sec"))
        out["index"] = np.int32(idx)
        if fixed.get("oos_target") is not None:
            out["oos_target"] = np.int32(fixed["oos_target"])
        return out

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        indices = self.sampler.indices(self._epoch)
        if self.sampler.drop_last:
            n_batches = len(indices) // self.batch_size
            indices = indices[: n_batches * self.batch_size]
            pad_from = len(indices)
        else:
            # pad the tail batch by wrapping around so shapes stay static;
            # the batch carries a `pad_mask` (1 = real item) that eval
            # aggregation uses to drop the duplicates
            pad_from = len(indices)
            n_batches = -(-len(indices) // self.batch_size)
            short = n_batches * self.batch_size - len(indices)
            if short:
                indices = np.concatenate([indices, indices[:short]])
        epoch_seed = (self.seed * 1_000_003 + self._epoch) & 0x7FFFFFFF

        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def producer():
            with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
                for b in range(n_batches):
                    if stop.is_set():
                        return
                    lo = b * self.batch_size
                    batch_idx = indices[lo:lo + self.batch_size]
                    futures = [
                        pool.submit(self._load_one, int(i),
                                    (epoch_seed * 1_000_003 + int(i)) & 0x7FFFFFFF)
                        for i in batch_idx
                    ]
                    try:
                        items = [f.result() for f in futures]
                    except Exception as e:  # propagate to consumer
                        out_q.put(e)
                        return
                    batch = {
                        k: np.stack([it[k] for it in items])
                        for k in items[0]
                    }
                    batch["pad_mask"] = (np.arange(lo, lo + self.batch_size)
                                         < pad_from)
                    out_q.put(batch)
            out_q.put(None)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                got = out_q.get()
                if got is None:
                    return
                if isinstance(got, Exception):
                    raise got
                yield got
        finally:
            stop.set()
            # unblock a producer stuck on a full queue so the thread can exit
            try:
                out_q.get_nowait()
            except queue.Empty:
                pass


class StagedLoader:
    """Wrap a loader so batches arrive already on ``device``, ``depth``
    batches ahead.

    A staging thread pulls host batches from the wrapped loader, runs
    ``host_transform`` on them (e.g. avstage.patchify_u8 of the video key),
    and copies each device-bound key onto the device. On a CUDA device the
    copy goes through pinned host memory on a side stream, which records an
    event per batch; the consumer's stream waits on that event before the
    batch is handed out, and each tensor is recorded on the consumer's
    stream, so its memory is not reused before the consumer's work on it is
    done. On the CPU the keys become tensors sharing the numpy buffers.

    ``h2d_s`` accumulates the staging thread's busy time (host transform,
    pinning and the enqueue of the copies: it overlaps the consumer's
    compute) and ``h2d_bytes`` the staged volume. A producer error is
    raised in the consumer.
    """

    def __init__(self, loader, depth: int = 2, device_keys=DEVICE_KEYS,
                 device="cpu", host_transform=None):
        self.loader = loader
        self.depth = depth
        self.device_keys = device_keys
        self.device = torch.device(device)
        self.host_transform = host_transform
        self.h2d_s = 0.0
        self.h2d_bytes = 0

    def set_epoch(self, epoch: int):
        self.loader.set_epoch(epoch)

    def __len__(self):
        return len(self.loader)

    def reset_stats(self):
        self.h2d_s = 0.0
        self.h2d_bytes = 0

    def __iter__(self):
        cuda = self.device.type == "cuda"
        stream = torch.cuda.Stream(self.device) if cuda else None
        out_q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        stop = threading.Event()

        def stager():
            try:
                for b in self.loader:
                    if stop.is_set():
                        return
                    t0 = time.perf_counter()
                    staged = dict(b)
                    if self.host_transform is not None:
                        staged = self.host_transform(staged)
                    keys = [k for k in self.device_keys if k in staged]
                    event = None
                    for k in keys:
                        self.h2d_bytes += staged[k].nbytes
                    if cuda:
                        with torch.cuda.stream(stream):
                            for k in keys:
                                host = torch.as_tensor(np.ascontiguousarray(staged[k]))
                                staged[k] = host.pin_memory().to(self.device,
                                                                  non_blocking=True)
                            event = torch.cuda.Event()
                            event.record(stream)
                    else:
                        for k in keys:
                            staged[k] = torch.as_tensor(staged[k]).to(self.device)
                    self.h2d_s += time.perf_counter() - t0
                    out_q.put((staged, keys, event))
            except Exception as e:  # propagate to the consumer
                out_q.put(e)
                return
            out_q.put(None)

        thread = threading.Thread(target=stager, daemon=True)
        thread.start()
        try:
            while True:
                got = out_q.get()
                if got is None:
                    return
                if isinstance(got, Exception):
                    raise got
                staged, keys, event = got
                if event is not None:
                    consumer = torch.cuda.current_stream(self.device)
                    consumer.wait_event(event)
                    for k in keys:
                        staged[k].record_stream(consumer)
                yield staged
        finally:
            stop.set()
            # unblock a stager stuck on a full queue so the thread can exit
            try:
                out_q.get_nowait()
            except queue.Empty:
                pass


def measure_pipeline_throughput(loader, consume, epochs: int = 1,
                                sync=None) -> Dict[str, float]:
    """Drive ``loader -> consume`` overlapped and measure sustained
    throughput, attributed across the three walls.

    ``consume(batch)`` should dispatch device work asynchronously and return;
    ``sync()`` must block until all dispatched work finished (on the card:
    torch.cuda.synchronize).

    Returns clips_per_sec (sustained, includes decode+geometry+H2D+compute)
    and the wall split:
      host_wait_frac    — blocked on the loader (decode + host geometry when
                          close to 1; the workers hide it otherwise)
      consume_frac      — inside consume(): the step's dispatch
      device_drain_frac — the final sync() tail after the last dispatch."""
    total_clips = 0
    wait_host = 0.0
    consume_s = 0.0
    t0 = time.perf_counter()
    for ep in range(epochs):
        loader.set_epoch(ep)
        it = iter(loader)
        while True:
            t_w = time.perf_counter()
            batch = next(it, None)
            wait_host += time.perf_counter() - t_w
            if batch is None:
                break
            t_c = time.perf_counter()
            consume(batch)
            consume_s += time.perf_counter() - t_c
            total_clips += int(np.asarray(batch.get("pad_mask",
                                                    np.ones(len(batch["video"])))).sum())
    t_d = time.perf_counter()
    if sync is not None:
        sync()
    drain = time.perf_counter() - t_d
    total = time.perf_counter() - t0
    return {"clips_per_sec": total_clips / total,
            "host_wait_frac": wait_host / total,
            "consume_frac": consume_s / total,
            "device_drain_frac": drain / total,
            "clips": total_clips, "total_s": total}


def batch_to_device(batch: Dict[str, np.ndarray], device="cpu",
                    keys=DEVICE_KEYS) -> Dict:
    """A host batch with its device-bound keys copied onto ``device`` (the
    H2D boundary, ref: train_utils.py:359-371); other keys pass through."""
    device = torch.device(device)
    out = dict(batch)
    for k in keys:
        if k in out:
            out[k] = torch.as_tensor(out[k]).to(device, non_blocking=True)
    return out
