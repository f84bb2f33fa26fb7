"""Single-clip offset prediction on the card (the port of example.py).

    python -m synchformer_tpu_torch.example exp_name=24-01-04T16-39-21 \\
        vid_path=data/clip.mp4 offset_sec=1.6 [v_start_i_sec=0.0] \\
        [ckpt_dir=./checkpoints] [fp32=false] [device=cuda] [out=pred.npz]

Reads a reference Stage II checkpoint (``<ckpt_dir>/<exp_name>.pt``, the
published file's name; its download link is kept, and the file is fetched
only where it is absent), rebuilds the trained model from the config stored
in it (``args``; a file without one gets the S=14 preset), loads its
weights, decodes the clip (re-encoded to 25 fps / 16 kHz / 256 side with
ffmpeg where the media is not canonical and ffmpeg exists, else brought
there on the host), applies the deterministic test transform with the
requested offset, and prints the top-5 offset probabilities on the class
grid. ``vid_path=synthetic://<name>`` takes a generated clip, which needs no
decoder.

``device`` is the card (``cuda``) unless it says ``cpu``. The model runs in
bf16 on the kernels (impl='kernel'; on the card K1-K4), and the kernel
launches of its forward are printed; ``fp32=true`` asks for the plain path
in f32 (impl='plain'). ``out`` writes the logits, the probabilities, the
class grid, the prepared clip (video (S, T, H, W, C) uint8, audio (S, n)
f32) and the launches to an .npz file.

Expected outputs on the reference assets (ref: README.md:73-97), with the
published checkpoint: +1.6 s on 3qesirWAGt4_20000_30000.mp4 -> p=0.8076 at
class 18 ("1.60"); -2.0 s (v_start 4.0) on ZYc410CE4Rg_0_10000.mp4 ->
p=0.8291 at class 0.
"""
from __future__ import annotations

import json
import logging
import sys
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

# checkpoint name -> download URL (ref: utils/utils.py:13-66); the files are
# read from ckpt_dir where they exist
FNAME2LINK = {
    f"{exp}.pt": f"https://a3s.fi/swift/v1/AUTH_a235c0f452d648828f745589cde1219a/sync/sync_models/{exp}/{exp}.pt"
    for exp in ("24-01-04T16-39-21", "24-01-02T10-00-53", "23-12-23T18-33-57",
                "24-01-22T20-34-52")
}
# a checkpoint without a stored config: the S=14 preset's geometry
PRESET_INFO = dict(target_seq_len=198, num_cls=21, max_off_sec=2.0, max_spec_t=66,
                   num_mel_bins=128, data={})
# the data section's keys that shape the pipeline (absent ones keep the
# S=14 defaults)
PIPELINE_KEYS = ("crop_len_sec", "max_off_sec", "step_size_seg", "segment_size_vframes",
                 "n_segments", "input_size", "size_before_crop", "vfps", "afps")


def check_if_file_exists_else_download(path: str) -> str:
    path = Path(path)
    if path.exists():
        return str(path)
    url = FNAME2LINK.get(path.name)
    if url is None:
        raise FileNotFoundError(path)
    logging.info(f"downloading {url} -> {path}")
    import urllib.request

    path.parent.mkdir(parents=True, exist_ok=True)
    urllib.request.urlretrieve(url, str(path))
    return str(path)


def decode_single_video_prediction(logits: np.ndarray, grid: np.ndarray, k: int = 5) -> int:
    probs = np.exp(logits - logits.max()) / np.exp(logits - logits.max()).sum()
    order = np.argsort(-probs)[:k]
    print("Prediction Result:")
    for cls in order:
        print(f"p={probs[cls]:.4f} ({logits[cls]:.4f}), "
              f"label={cls} ({grid[cls]:.2f} sec)")
    return int(order[0])


def load_sync_checkpoint(ckpt_path: str, device="cpu", attn_impl: Optional[str] = None):
    """A reference Stage II / III ``.pt`` -> (model in f32 on ``device``,
    info): the model from the file's stored config
    (build_synchformer_from_ckpt_args) or, without one, the S=14 preset;
    the weights loaded strictly on the names the model reads, the sync
    position embedding cut to the model's."""
    from synchformer_tpu_torch.models.presets import (
        build_synchformer,
        build_synchformer_from_ckpt_args,
    )
    from synchformer_tpu_torch.utils.checkpoint import load_torch_checkpoint, plain_from_ckpt_args
    from synchformer_tpu_torch.utils.convert import load_sync_state_dict, sync_state_dict_from_ckpt

    ckpt = load_torch_checkpoint(ckpt_path)
    args = plain_from_ckpt_args(ckpt.get("args")) if isinstance(ckpt, dict) else None
    if isinstance(args, dict) and "model" in args:
        model, info = build_synchformer_from_ckpt_args(args, device=device, attn_impl=attn_impl)
        logging.info("model reconstructed from ckpt args "
                     f"({args['model']['target']}, seq_len={info['target_seq_len']})")
    else:
        logging.info("no cfg embedded in ckpt; using the full-size S=14 preset")
        model, info = build_synchformer(14, device=device), dict(PRESET_INFO)
    load_sync_state_dict(model, sync_state_dict_from_ckpt(ckpt, info["target_seq_len"]))
    return model.eval(), info


def prepare_clip(vid_path: str, offset_sec: float, v_start_i_sec: float, info: dict) -> dict:
    """Decode the clip (bringing non-canonical media to 25 fps / 16 kHz / 256
    side) and run the test transform with the fixed offset and start, its
    knobs from the checkpoint's data section: prepare_item's dict."""
    from synchformer_tpu_torch.data.media import (
        available_backends,
        get_video_and_audio,
        reencode_video,
    )
    from synchformer_tpu_torch.data.transforms import (
        SyncPipelineConfig,
        ingest_noncanonical,
        prepare_item,
    )

    video, audio, meta = get_video_and_audio(vid_path)
    v_fps = meta["video"]["fps"][0]
    a_rate = meta["audio"]["framerate"][0]
    h, w = video.shape[1:3]
    if v_fps != 25 or a_rate != 16_000 or min(h, w) != 256:
        if "ffmpeg" in available_backends():
            logging.info("re-encoding to 25 fps / 16 kHz / 256 side")
            video, audio, meta = get_video_and_audio(reencode_video(vid_path))
        else:
            logging.info("no ffmpeg; resampling and letterboxing on the host")
            video, audio = ingest_noncanonical(video, audio, v_fps, a_rate)
    data = info["data"]
    pipe_kwargs = {k: data[k] for k in PIPELINE_KEYS if data.get(k) is not None}
    pipe_kwargs["num_off_cls"] = info["num_cls"]
    return prepare_item(video, audio, SyncPipelineConfig(**pipe_kwargs),
                        np.random.default_rng(0), split="test",
                        fixed_offset_sec=offset_sec, fixed_v_start_sec=v_start_i_sec)


def predict(model, info: dict, item: dict, device="cuda",
            fp32: bool = False) -> Tuple[np.ndarray, str, dict]:
    """One forward of the clip, patched at the model's 3-D patch size: (f32
    logits (C,), impl, the kernel launches of the forward). bf16 on the
    kernels, or with ``fp32`` the plain path in f32."""
    import torch

    from synchformer_tpu_torch.infer import SyncPredictor
    from synchformer_tpu_torch.ops.kernels import _build
    from synchformer_tpu_torch.ops.video import patchify_frames

    dtype, impl = (torch.float32, "plain") if fp32 else (torch.bfloat16, "kernel")
    z, p, _ = model.vfeat_extractor.patch_embed_3d.proj.kernel_size
    video = torch.from_numpy(np.ascontiguousarray(patchify_frames(item["video"][None], z, p)))
    pcm = torch.from_numpy(np.ascontiguousarray(item["audio"][None]))
    pred = SyncPredictor(model, device, dtype, impl, max_spec_t=info["max_spec_t"],
                         n_mels=info["num_mel_bins"])
    if pred.device.type == "cuda":
        torch.cuda.synchronize(pred.device)
    _build.launches.clear()
    logits = pred.logits(video, pcm)[0].float().cpu().numpy()
    return logits, impl, dict(_build.launches)


def main(argv: Optional[Sequence[str]] = None) -> np.ndarray:
    """Run the CLI on ``argv`` (default sys.argv[1:]); returns the logits."""
    import torch

    from synchformer_tpu_torch.data.transforms import make_class_grid

    logging.basicConfig(level=logging.INFO)
    argv = sys.argv[1:] if argv is None else argv
    kv = dict(item.split("=", 1) for item in argv if "=" in item)
    exp_name = kv.get("exp_name", "24-01-04T16-39-21")
    vid_path = kv["vid_path"]
    offset_sec = float(kv.get("offset_sec", 0.0))
    v_start_i_sec = float(kv.get("v_start_i_sec", 0.0))
    ckpt_dir = kv.get("ckpt_dir", "./checkpoints")
    fp32 = kv.get("fp32", "false").lower() == "true"
    device = torch.device(kv.get("device", "cuda"))
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available: pass device=cpu to run on the CPU")

    ckpt_path = check_if_file_exists_else_download(f"{ckpt_dir}/{exp_name}.pt")
    model, info = load_sync_checkpoint(ckpt_path)
    item = prepare_clip(vid_path, offset_sec, v_start_i_sec, info)
    logits, impl, launches = predict(model, info, item, device, fp32)
    grid = make_class_grid(-info["max_off_sec"], info["max_off_sec"], info["num_cls"])
    print(f"using offset={offset_sec} v_start={v_start_i_sec} "
          f"(target class {int(item['offset_target'])})")
    print(f"impl={impl} dtype={'float32' if fp32 else 'bfloat16'} device={device}")
    if launches:
        print("kernel launches: " + json.dumps(launches, sort_keys=True))
    decode_single_video_prediction(logits, grid)
    if "out" in kv:
        z = logits - logits.max()
        np.savez(kv["out"], logits=logits, probs=np.exp(z) / np.exp(z).sum(), grid=grid,
                 video=item["video"], audio=item["audio"],
                 offset_target=np.int32(item["offset_target"]),
                 launches=json.dumps(launches, sort_keys=True))
    return logits


if __name__ == "__main__":
    main()
