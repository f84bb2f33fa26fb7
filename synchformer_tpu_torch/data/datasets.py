"""Dataset catalog: VGGSound (+variants), LRS3, AudioSet (the port's copy of
synchformer_tpu/data/datasets.py, registered in the port's registry under
the JAX package's target names and the reference's).

Behavior parity with ref: dataset/{vggsound,lrs,audioset}.py — metadata CSVs,
bad-example filter lists, deterministic split-file generation, fixed-offset
CSVs for valid/test, size-ratio subsampling — re-designed as plain-Python
index providers: a dataset is a list of (path, fixed-offset-params, target)
records; decode + geometry happen in the pipeline (data/pipeline.py), device
math on the card.

Fixed-offset CSV machinery (ref: dataset/dataset_utils.py:15-54,
utils/utils.py:150-163): filenames encode the offset-grid parameters, e.g.
``test_size21_crop5_min-2.00_max2.00.csv``; rows are
``path,vstart_sec,offset_sec[,oos_target]``.
"""
from __future__ import annotations

import csv
import logging
import os
import random
from collections import Counter
from glob import glob
from pathlib import Path
from typing import Dict, List, Optional, Sequence


from synchformer_tpu_torch.registry import register


# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------

def fixed_offsets_fname(split: str, grid_size: int, crop_len_sec: float,
                        min_off: float, max_off: float) -> str:
    crop = int(crop_len_sec) if crop_len_sec == int(crop_len_sec) else crop_len_sec
    return f"{split}_size{grid_size}_crop{crop}_min{min_off:.2f}_max{max_off:.2f}.csv"


def load_fixed_offsets(splits_path: str, dataset_name: str, split: str,
                       grid_size: int = 21, crop_len_sec: float = 5,
                       min_off: float = -2.0, max_off: float = 2.0) -> Dict[str, Dict]:
    """Load id -> {offset_sec, v_start_i_sec[, oos_target]} from the
    fixed-offset CSVs of every split (the reference globs across splits and
    asserts consistency, ref: dataset_utils.py:15-54)."""
    fname = fixed_offsets_fname(split, grid_size, crop_len_sec, min_off, max_off)
    pattern = os.path.join(splits_path, f"fixed_offsets_{dataset_name}",
                           fname.replace(split, "*"))
    paths = sorted(glob(pattern))
    assert paths, f"no fixed-offset files match {pattern}"
    vid2params: Dict[str, Dict] = {}
    for p in paths:
        with open(p) as f:
            reader = csv.reader(f)
            if dataset_name == "k700_2020":
                # k700 CSVs have no header and vstart precedes offset
                # (ref: dataset_utils.py:29-31)
                header = ["path", "vstart_sec", "offset_sec", "oos_target"]
            else:
                header = next(reader)
            for line in reader:
                row = dict(zip(header, line))
                vid = row.pop("path")
                data = {"offset_sec": float(row["offset_sec"])}
                for key in ("vstart_sec", "v_start_sec"):
                    if key in row:
                        data["v_start_i_sec"] = float(row[key])
                if "oos_target" in row:
                    data["oos_target"] = int(row["oos_target"])
                if vid in vid2params:
                    assert all(vid2params[vid][k] == v for k, v in data.items()), \
                        f"{vid} has conflicting fixed offsets across splits"
                vid2params[vid] = data
    return vid2params


def subsample_dataset(items: List, size_ratio: Optional[float],
                      shuffle: bool = False, seed: int = 1337) -> List:
    """Keep a fraction of the dataset (ref: dataset_utils.py:100-112)."""
    if size_ratio is not None and 0.0 < size_ratio < 1.0:
        items = list(items)
        if shuffle:
            random.Random(seed).shuffle(items)
        items = items[: max(1, int(len(items) * size_ratio))]
        logging.info(f"subsampled dataset to ratio {size_ratio} -> {len(items)} items")
    return items


def _read_filter_lists(*dirs: str) -> set:
    bad = set()
    for d in dirs:
        for p in sorted(glob(os.path.join(d, "*.txt"))):
            bad |= set(open(p).read().splitlines())
    return bad


class ClipRecord:
    __slots__ = ("path", "target", "fixed_offset")

    def __init__(self, path: str, target=None, fixed_offset: Optional[Dict] = None):
        self.path = path
        self.target = target
        self.fixed_offset = fixed_offset

    def __repr__(self):
        return f"ClipRecord({self.path!r}, target={self.target})"


class AVClipDataset:
    """Base: an ordered list of ClipRecords + class maps."""

    max_clip_len_sec: Optional[float] = None

    def __init__(self):
        self.records: List[ClipRecord] = []
        self.label2target: Dict[str, int] = {}
        self.target2label: Dict[int, str] = {}
        self.split = "train"

    def __len__(self):
        return len(self.records)

    def __getitem__(self, idx: int) -> ClipRecord:
        return self.records[idx]


# ---------------------------------------------------------------------------
# VGGSound family (ref: dataset/vggsound.py)
# ---------------------------------------------------------------------------

@register("synchformer_tpu.data.datasets.VGGSound", "dataset.vggsound.VGGSound")
class VGGSound(AVClipDataset):
    """VGGSound clips: csv meta (vid, start, label, split), bad-example
    filters, generated train/valid/test split files where valid mirrors the
    test-set class distribution (ref: vggsound.py:16-185)."""

    dataset_name = "vggsound"

    def __init__(self, split: str, vids_dir: str, splits_path: str = "./data",
                 meta_path: str = "./data/vggsound.csv",
                 to_filter_bad_examples: bool = True, seed: int = 1337,
                 load_fixed_offsets_on: Sequence[str] = ("valid", "test"),
                 size_ratio: Optional[float] = None, **_unused):
        super().__init__()
        self.split = split
        self.vids_dir = vids_dir
        self.splits_path = splits_path
        self.seed = seed

        meta = list(csv.reader(open(meta_path), quotechar='"'))
        if to_filter_bad_examples:
            meta = self._filter_bad(meta)

        classes = sorted({row[2] for row in meta})
        self.label2target = {l: t for t, l in enumerate(classes)}
        self.target2label = {t: l for l, t in self.label2target.items()}
        self.video2target = {row[0]: self.label2target[row[2]] for row in meta}

        split_file = os.path.join(splits_path, f"vggsound_{split}.txt")
        if not os.path.exists(split_file):
            self._make_split_files(meta)
        available = {f"{r[0]}_{int(r[1]) * 1000}_{(int(r[1]) + 10) * 1000}" for r in meta}
        within = set(open(split_file).read().splitlines())
        clip_ids = sorted(available & within)

        offsets = {}
        if split in (load_fixed_offsets_on or ()):
            offsets = load_fixed_offsets(splits_path, self.dataset_name, split)

        self.records = [
            ClipRecord(os.path.join(vids_dir, cid + ".mp4"),
                       target=self.video2target[cid[:11]],
                       fixed_offset=offsets.get(cid))
            for cid in clip_ids
        ]
        self.records = subsample_dataset(self.records, size_ratio,
                                         shuffle=split == "train", seed=seed)

    # -- hooks overridden by variants --------------------------------------
    def _filter_bad(self, meta):
        bad = _read_filter_lists(os.path.join(self.splits_path, "filtered_examples_vggsound"))
        return [r for r in meta
                if f"{r[0]}_{int(r[1]) * 1000}_{(int(r[1]) + 10) * 1000}" not in bad]

    def _make_split_files(self, meta):
        """valid is carved out of train with the test set's class counts
        (ref: vggsound.py:122-183)."""
        logging.info("generating vggsound split files")
        available = sorted(glob(os.path.join(self.vids_dir, "*.mp4")))
        train_vids = {r[0] for r in meta if r[3] == "train"}
        test_vids = {r[0] for r in meta if r[3] == "test"}
        test_counts = Counter(self.video2target[v] for v in test_vids)

        train_wo_valid, valid_vids = set(), set()
        for label, target in self.label2target.items():
            cls_vids = sorted(v for v in train_vids if self.video2target[v] == target)
            random.Random(self.seed).shuffle(cls_vids)
            count = test_counts[target]
            valid_vids.update(cls_vids[:count])
            train_wo_valid.update(cls_vids[count:])

        handles = {s: open(os.path.join(self.splits_path, f"vggsound_{s}.txt"), "w")
                   for s in ("train", "valid", "test")}
        try:
            for path in available:
                name = Path(path).stem
                vid = name[:11]
                if vid in train_wo_valid:
                    handles["train"].write(name + "\n")
                elif vid in valid_vids:
                    handles["valid"].write(name + "\n")
                elif vid in test_vids:
                    handles["test"].write(name + "\n")
        finally:
            for h in handles.values():
                h.close()


@register("synchformer_tpu.data.datasets.VGGSoundSparse", "dataset.vggsound.VGGSoundSparse")
class VGGSoundSparse(VGGSound):
    """VGGSound restricted to sparse-sound classes (ref: vggsound.py:188-231)."""

    def __init__(self, split, vids_dir, splits_path="./data",
                 meta_path="./data/vggsound.csv",
                 sparse_meta_path="./data/sparse_classes.csv", **kwargs):
        super().__init__(split, vids_dir, splits_path=splits_path,
                         meta_path=meta_path, **kwargs)
        sparse_meta = list(csv.reader(open(sparse_meta_path), quotechar='"',
                                      delimiter="\t"))
        sparse_classes = {row[0] for row in sparse_meta if row[1] == "y"}
        new_l2t = {l: t for t, l in enumerate(sorted(sparse_classes))}
        kept = []
        video2new = {}
        for rec in self.records:
            vid = Path(rec.path).stem[:11]
            label = self.target2label[self.video2target[vid]]
            if label in sparse_classes:
                rec.target = new_l2t[label]
                video2new[vid] = new_l2t[label]
                kept.append(rec)
        self.records = kept
        self.label2target = new_l2t
        self.target2label = {t: l for l, t in new_l2t.items()}
        self.video2target = video2new


@register("synchformer_tpu.data.datasets.VGGSoundSparsePicked",
          "dataset.vggsound.VGGSoundSparsePicked")
class VGGSoundSparsePicked(VGGSoundSparse):
    """Sparse subset with hand-picked classes (ref: vggsound.py:234-244)."""

    def __init__(self, split, vids_dir,
                 sparse_meta_path="./data/picked_sparse_classes.csv", **kwargs):
        super().__init__(split, vids_dir, sparse_meta_path=sparse_meta_path, **kwargs)


@register("synchformer_tpu.data.datasets.VGGSoundSparsePickedCleanTest",
          "dataset.vggsound.VGGSoundSparsePickedCleanTest")
class VGGSoundSparsePickedCleanTest(VGGSoundSparsePicked):
    """Adds the extra cleaned-test filter lists (ref: vggsound.py:247-261)."""

    def _filter_bad(self, meta):
        bad = _read_filter_lists(
            os.path.join(self.splits_path, "filtered_examples_vggsound"),
            os.path.join(self.splits_path, "filtered_examples_vggsound_extra"))
        return [r for r in meta
                if f"{r[0]}_{int(r[1]) * 1000}_{(int(r[1]) + 10) * 1000}" not in bad]


@register("synchformer_tpu.data.datasets.VGGSoundSparsePickedCleanTestFixedOffsets",
          "dataset.vggsound.VGGSoundSparsePickedCleanTestFixedOffsets")
class VGGSoundSparsePickedCleanTestFixedOffsets(VGGSoundSparsePicked):
    """Hand-annotated fixed offsets only (ref: vggsound.py:264-289): rows
    ``dataset,video_id,vstart_sec,offset_sec,is_sync``; keeps is_sync == 1."""

    def __init__(self, split, vids_dir, splits_path="./data", **kwargs):
        super().__init__(split, vids_dir, splits_path=splits_path, **kwargs)
        fix_path = os.path.join(splits_path, "vggsound_sparse_clean_fixed_offsets.csv")
        vid2params = {}
        with open(fix_path) as f:
            reader = csv.reader(f)
            next(reader)
            for _, vid, start, off, sync in reader:
                assert vid not in vid2params, f"duplicate fixed offset for {vid}"
                if sync == "1":
                    vid2params[vid] = {"offset_sec": float(off),
                                       "v_start_i_sec": float(start)}
        kept = []
        for rec in self.records:
            params = vid2params.get(Path(rec.path).stem)
            if params is not None:
                rec.fixed_offset = params
                kept.append(rec)
        self.records = kept


@register("synchformer_tpu.data.datasets.LongerVGGSound", "dataset.vggsound.LongerVGGSound")
class LongerVGGSound(VGGSound):
    """Extra filter for clips shorter than 9.5 s (ref: vggsound.py:292-328)."""

    def __init__(self, split, vids_dir, splits_path="./data",
                 to_filter_bad_examples=True, **kwargs):
        super().__init__(split, vids_dir, splits_path=splits_path,
                         to_filter_bad_examples=to_filter_bad_examples, **kwargs)
        if to_filter_bad_examples:
            short_list = os.path.join(splits_path, "filtered_examples_vggsound_shorter",
                                      "less_than_9.5s.txt")
            if os.path.exists(short_list):
                bad = set(open(short_list).read().splitlines())
                self.records = [r for r in self.records if Path(r.path).stem not in bad]


# ---------------------------------------------------------------------------
# LRS3 (ref: dataset/lrs.py)
# ---------------------------------------------------------------------------

@register("synchformer_tpu.data.datasets.LRS3", "dataset.lrs.LRS3")
class LRS3(AVClipDataset):
    """LRS3 'pretrain' clips with a speaker-disjoint 8:1:1 split by video id
    and an 11 s IO cap (ref: lrs.py:16-166)."""

    dataset_name = "lrs3"
    max_clip_len_sec = 11

    def __init__(self, split: str, vids_dir: str, splits_path: str = "./data",
                 seed: int = 1337, load_fixed_offsets_on: Sequence[str] = ("valid", "test"),
                 to_filter_bad_examples: bool = True,
                 size_ratio: Optional[float] = None, **_unused):
        super().__init__()
        self.split = split
        self.vids_dir = vids_dir
        self.splits_path = splits_path
        self.seed = seed

        split_file = os.path.join(splits_path, f"lrs3_{split}.txt")
        if not os.path.exists(split_file):
            clip_ids = sorted(
                str(p.relative_to(vids_dir)).removesuffix(".mp4")
                for p in Path(vids_dir).glob("pretrain/*/*.mp4"))
            if to_filter_bad_examples:
                bad = _read_filter_lists(os.path.join(splits_path, "filtered_examples_lrs"))
                clip_ids = [c for c in clip_ids if c not in bad]
            self._make_split_files(clip_ids)

        clip_ids = sorted(open(split_file).read().splitlines())
        offsets = {}
        if split in (load_fixed_offsets_on or ()):
            offsets = load_fixed_offsets(splits_path, self.dataset_name, split)
        self.records = [
            ClipRecord(os.path.join(vids_dir, cid + ".mp4"),
                       fixed_offset=offsets.get(cid))
            for cid in clip_ids
        ]
        self.records = subsample_dataset(self.records, size_ratio,
                                         shuffle=split == "train", seed=seed)

    def _make_split_files(self, clip_ids: List[str]):
        """Split by SPEAKER (parent dir), not clip: 8:1:1 (ref: lrs.py:97-120)."""
        speakers = sorted({Path(c).parent.name for c in clip_ids})
        random.Random(self.seed).shuffle(speakers)
        hold = int(len(speakers) * 0.1)
        test_sp = set(speakers[:hold])
        valid_sp = set(speakers[hold:2 * hold])
        split_of = lambda c: ("test" if Path(c).parent.name in test_sp else
                              "valid" if Path(c).parent.name in valid_sp else "train")
        handles = {s: open(os.path.join(self.splits_path, f"lrs3_{s}.txt"), "w")
                   for s in ("train", "valid", "test")}
        try:
            for c in clip_ids:
                handles[split_of(c)].write(c + "\n")
        finally:
            for h in handles.values():
                h.close()


@register("synchformer_tpu.data.datasets.LongerLRS3", "dataset.lrs.LongerLRS3")
class LongerLRS3(LRS3):
    """LRS3 variant with the shorter-than-9.5 s clips filtered out
    (ref: lrs.py LongerLRS3)."""

    def __init__(self, split, vids_dir, splits_path="./data",
                 to_filter_bad_examples=True, **kwargs):
        super().__init__(split, vids_dir, splits_path=splits_path,
                         to_filter_bad_examples=to_filter_bad_examples, **kwargs)
        if to_filter_bad_examples:
            short_list = os.path.join(splits_path, "filtered_examples_lrs_shorter",
                                      "less_than_9.5s.txt")
            if os.path.exists(short_list):
                bad = set(open(short_list).read().splitlines())
                self.records = [
                    r for r in self.records
                    if str(Path(r.path).relative_to(self.vids_dir)).removesuffix(".mp4")
                    not in bad]


# ---------------------------------------------------------------------------
# AudioSet (ref: dataset/audioset.py)
# ---------------------------------------------------------------------------

_AS_SPLIT2SHORT = {"train": "unbalanced", "valid": "balanced", "test": "eval"}
_AS_SHORT2LONG = {"unbalanced": "unbalanced_train_segments",
                  "balanced": "balanced_train_segments",
                  "eval": "eval_segments"}


@register("synchformer_tpu.data.datasets.AudioSet", "dataset.audioset.AudioSet")
class AudioSet(AVClipDataset):
    """AudioSet: unbalanced->train / balanced->valid / eval->test, multi-label
    meta (ref: audioset.py:14-110; targets are carried but unused by sync)."""

    dataset_name = "audioset"

    def __init__(self, split: str, vids_dir: str, splits_path: str = "./data",
                 meta_path: str = "./data/audioset.csv",
                 to_filter_bad_examples: bool = True, seed: int = 1337,
                 load_fixed_offsets_on: Sequence[str] = ("valid", "test"),
                 size_ratio: Optional[float] = None, **_unused):
        super().__init__()
        self.split = split
        self.splits_path = splits_path
        rows = []
        for shortdir_vid, start, end, targets, phase in csv.reader(open(meta_path),
                                                                   quotechar='"'):
            if shortdir_vid.startswith(_AS_SPLIT2SHORT[split]):
                short, vid = shortdir_vid.split("/")
                rows.append(["/".join([_AS_SHORT2LONG[short], vid]),
                             float(start), float(end), targets])
        if to_filter_bad_examples:
            bad = _read_filter_lists(os.path.join(splits_path, "filtered_examples_audioset"))
            rows = [r for r in rows
                    if f"{r[0]}_{int(r[1] * 1000)}_{int(r[2] * 1000)}" not in bad]

        labels_csv = os.path.join(splits_path, "audioset_labels.csv")
        if os.path.exists(labels_csv):
            self.label2target = {l: int(t) for t, _, l in csv.reader(open(labels_csv))}
            self.target2label = {t: l for l, t in self.label2target.items()}

        offsets = {}
        if split in (load_fixed_offsets_on or ()):
            offsets = load_fixed_offsets(splits_path, self.dataset_name, split)

        self.records = []
        for key, start, end, targets in rows:
            cid = f"{key}_{int(start * 1000)}_{int(end * 1000)}"
            self.records.append(ClipRecord(
                os.path.join(vids_dir, cid + ".mp4"),
                target=[int(t) for t in targets.split(",")] if targets else None,
                fixed_offset=offsets.get(cid)))
        self.records.sort(key=lambda r: r.path)
        self.records = subsample_dataset(self.records, size_ratio, shuffle=True,
                                         seed=seed)


class _BalancedAudioSet(AudioSet):
    """Balanced train subsets defined by a clip-id list file
    (ref: audioset.py:113-150)."""

    list_fname = ""

    def __init__(self, split, vids_dir, splits_path="./data", **kwargs):
        super().__init__(split, vids_dir, splits_path=splits_path, **kwargs)
        if split == "train" and self.list_fname:
            list_path = os.path.join(splits_path, self.list_fname)
            if os.path.exists(list_path):
                keep = set(open(list_path).read().splitlines())
                self.records = [r for r in self.records
                                if Path(r.path).stem in keep]


@register("synchformer_tpu.data.datasets.AudioSetBalanced737k",
          "dataset.audioset.AudioSetBalanced737k")
class AudioSetBalanced737k(_BalancedAudioSet):
    list_fname = "audioset_balanced_737k.txt"


@register("synchformer_tpu.data.datasets.AudioSetBalanced540k",
          "dataset.audioset.AudioSetBalanced540k")
class AudioSetBalanced540k(_BalancedAudioSet):
    list_fname = "audioset_balanced_540k.txt"


# ---------------------------------------------------------------------------
# synthetic dataset (tests / benchmarks; no media files required)
# ---------------------------------------------------------------------------

@register("synchformer_tpu.data.datasets.LocalClips")
class LocalClips(AVClipDataset):
    """An explicit list of local media files, cycled to ``n_clips`` items.

    Drives real decode through the pipeline without dataset metadata — e.g.
    bench.py --decode=cv2 loops the reference's two shipped sample mp4s
    (the clips ref: README.md:73-97 publishes example outputs for)."""

    def __init__(self, paths, split: str = "test", n_clips: int = None,
                 max_clip_len_sec: float = None, **_unused):
        super().__init__()
        self.split = split
        paths = [str(p) for p in paths]
        if not paths:
            raise ValueError("LocalClips needs at least one path")
        n = n_clips or len(paths)
        self.records = [ClipRecord(paths[i % len(paths)]) for i in range(n)]
        self.max_clip_len_sec = max_clip_len_sec


@register("synchformer_tpu.data.datasets.SyntheticAV")
class SyntheticAV(AVClipDataset):
    """Deterministic generated clips, decoded by media.py's synthetic backend.
    Used by integration tests and throughput benchmarks."""

    def __init__(self, split: str, n_clips: int = 8, **_unused):
        super().__init__()
        self.split = split
        self.records = [ClipRecord(f"synthetic://{split}/{i}.mp4")
                        for i in range(n_clips)]
