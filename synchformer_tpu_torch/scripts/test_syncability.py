"""Syncability evaluation on the card (the port of scripts/test_syncability.py).

    python -m synchformer_tpu_torch.scripts.test_syncability \\
        ckpt_sync=./checkpoints/24-01-22T20-34-52.pt \\
        [ckpt_off=./checkpoints/24-01-04T16-39-21.pt] \\
        vids_path=/path/to/vggsound splits_path=./data \\
        [iter_times=25] [batch_size=8] [logdir=./logs/syncability] \\
        [dataset=<target>] [device=cuda]

Builds the Stage III syncability model (S=13, 2-class head, position
embedding 184) and, with ``ckpt_off``, the Stage II offset model (S=14, 21
classes, 198), loads each from its reference ``.pt`` (strictly on the names
the model reads, the position embedding cut to the model's), reads
VGGSoundSparsePickedCleanTest (``dataset`` names another registered
dataset, e.g. synchformer_tpu.data.datasets.SyntheticAV, which needs no
files) through the loader with every clip kept (drop_last off), drops the
reference protocol's ten too-short videos, and evaluates iter_times passes:
the ROC pickle, the syncability metrics and, with the offset model, the
tiered offset metrics per confidence threshold (ref:
test_syncability.py:277-387; the syncability model sees the first 13 of the
14 segments, :282-284).

``device`` is the card (``cuda``) unless it says ``cpu``. Both models run in
bf16 on the kernels (K1-K4 on the card).
"""
from __future__ import annotations

import logging
import sys
from typing import Optional, Sequence

import numpy as np

from synchformer_tpu_torch.models.presets import build_synchformer

DATASET = "synchformer_tpu.data.datasets.VGGSoundSparsePickedCleanTest"
N_SEGMENTS_SYNC, N_SEGMENTS_OFF = 13, 14


def load_predictor(ckpt_path: str, n_segments: int, syncability: bool, device, dtype,
                   impl: str):
    """The preset sync model (n_segments, the syncability head or the
    offset head) loaded from a reference ``.pt``, its sync position
    embedding cut to the model's, as a SyncPredictor on ``device`` in
    ``dtype`` on ``impl``."""
    from synchformer_tpu_torch.infer import SyncPredictor
    from synchformer_tpu_torch.utils.checkpoint import load_torch_checkpoint
    from synchformer_tpu_torch.utils.convert import load_sync_state_dict, sync_state_dict_from_ckpt

    model = build_synchformer(n_segments, syncability=syncability, device="cpu")
    seq_len = model.transformer.pos_emb_cfg.pos_emb.shape[1]
    load_sync_state_dict(model, sync_state_dict_from_ckpt(load_torch_checkpoint(ckpt_path),
                                                          seq_len))
    return SyncPredictor(model, device, dtype, impl)


def eval_fn(pred):
    """A loader batch's (video, audio) -> the predictor's (B, C) logits: the
    uint8 frames patched at the model's 3-D patch size on the host."""
    import torch

    from synchformer_tpu_torch.ops.video import patchify_frames

    z, p, _ = pred.model.vfeat_extractor.patch_embed_3d.proj.kernel_size

    def run(batch):
        video = np.ascontiguousarray(patchify_frames(np.asarray(batch["video"]), z, p))
        pcm = np.ascontiguousarray(batch["audio"], dtype=np.float32)
        return pred.logits(torch.from_numpy(video), torch.from_numpy(pcm)).float()

    return run


def make_loader(kv: dict):
    """The evaluation loader: the dataset's test split, the too-short videos
    dropped, 14-segment syncability items, in order, every clip kept."""
    from synchformer_tpu_torch.data.pipeline import SyncDataLoader
    from synchformer_tpu_torch.data.transforms import SyncPipelineConfig
    from synchformer_tpu_torch.registry import get_registered
    from synchformer_tpu_torch.train.syncability_eval import filter_too_short_videos

    ds = get_registered(kv.get("dataset", DATASET))(
        "test", vids_dir=kv.get("vids_path"), splits_path=kv.get("splits_path", "./data"))
    filter_too_short_videos(ds)
    return SyncDataLoader(ds, SyncPipelineConfig(n_segments=N_SEGMENTS_OFF, for_syncability=True),
                          int(kv.get("batch_size", 8)), num_workers=6, shuffle=False,
                          drop_last=False)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the CLI on ``argv`` (default sys.argv[1:]); returns
    evaluate_syncability's output."""
    import torch

    from synchformer_tpu_torch.train.syncability_eval import evaluate_syncability

    logging.basicConfig(level=logging.INFO)
    argv = sys.argv[1:] if argv is None else argv
    kv = dict(item.split("=", 1) for item in argv if "=" in item)
    device = torch.device(kv.get("device", "cuda"))
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available: pass device=cpu to run on the CPU")
    run = (device, torch.bfloat16, "kernel")
    pred_sync = load_predictor(kv["ckpt_sync"], N_SEGMENTS_SYNC, True, *run)
    pred_off = (load_predictor(kv["ckpt_off"], N_SEGMENTS_OFF, False, *run)
                if "ckpt_off" in kv else None)
    out = evaluate_syncability(eval_fn(pred_sync), make_loader(kv),
                               eval_off=eval_fn(pred_off) if pred_off is not None else None,
                               iter_times=int(kv.get("iter_times", 25)),
                               n_segments_sync=N_SEGMENTS_SYNC,
                               logdir=kv.get("logdir", "./logs/syncability"))
    print("syncability metrics:", out["metrics_sync"])
    print("mean one-vs-rest ROC-AUC:", out["roc"]["roc_curve_sc"])
    if "tiered" in out:
        for thresh, metrics in out["tiered"].items():
            print(f"confidence > {thresh}: {metrics}")
    return out


if __name__ == "__main__":
    main()
