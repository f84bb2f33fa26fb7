"""The reference-checkpoint entry points in the port against the JAX package
on the CPU (device=cpu):

- a seeded tiny port model (tests/test_example_reconstruct.py's
  REF_STYLE_CFG: reference target names, the legacy transformer target,
  ${} interpolations, 'torch.nn.Identity' time tails, an unknown
  legacy_knob) written as a reference-style .pt (weights under "model" with
  module. and an entry no model reads, args a pickled omegaconf DictConfig)
  and read back by the port (example.load_sync_checkpoint) and by JAX
  (build_synchformer_from_ckpt_args + convert_sync_checkpoint): info equal,
  the same prepare_item(fixed_offset_sec=...) clip through both, logits
  within rtol = atol = 1e-5 in f32 (JAX on its XLA path);
- sync_state_dict_from_ckpt / load_sync_state_dict against
  convert_sync_checkpoint, and their refusals;
- python -m synchformer_tpu_torch.example in-process: its printed top 5 on
  a synthetic:// clip against example.py's (the JAX composition of
  example.py:84-150) on the same .pt, both in f32 (4 printed decimals,
  held to 1e-4);
- python -m synchformer_tpu_torch.scripts.test_syncability in-process at
  narrow widths (towers of depth 1 and 64 wide, the published geometry) on
  a SyntheticAV loader: metrics_sync, the ROC and tiered pickles against JAX
  evaluate_syncability on the same logits; filter_too_short_videos against
  JAX's.
"""
import contextlib
import io
import pickle
import re
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_example_reconstruct import REF_STYLE_CFG

from synchformer_tpu_torch import example as texample
from synchformer_tpu_torch.models.presets import build_synchformer_from_ckpt_args
from synchformer_tpu_torch.models.sync_model import Synchformer
from synchformer_tpu_torch.scripts import test_syncability as tsync_cli
from synchformer_tpu_torch.train import syncability_eval as tsync
from synchformer_tpu_torch.utils import convert
from synchformer_tpu_torch.utils.reference_ckpt import save_reference_ckpt

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
REF = dict(rtol=1e-5, atol=1e-5)
CLIP = "synthetic://example/0.mp4"
OFFSET = 1.6
UNREAD = "transformer.legacy_unused"


@pytest.fixture(scope="module")
def ref_ckpt(tmp_path_factory):
    """A reference-style Stage II .pt of a seeded tiny port model built from
    REF_STYLE_CFG; returns (directory, experiment name, state dict)."""
    model, _ = build_synchformer_from_ckpt_args(REF_STYLE_CFG)
    sd = convert.seeded_state_dict(model, 7)
    root = tmp_path_factory.mktemp("ckpts")
    save_reference_ckpt(str(root / "exp.pt"), {**sd, UNREAD: np.zeros(3, np.float32)},
                        REF_STYLE_CFG, extra={"epoch": 3})
    return root, "exp", sd


def jax_from_ckpt(path: str, dtype=jnp.float32):
    """The JAX package's reading of a reference .pt (example.py:84-104)."""
    from synchformer_tpu.models.presets import build_synchformer_from_ckpt_args as jbuild
    from synchformer_tpu.utils.checkpoint import (
        convert_sync_checkpoint,
        load_torch_checkpoint,
        plain_from_ckpt_args,
    )

    ckpt = load_torch_checkpoint(path)
    model, info = jbuild(plain_from_ckpt_args(ckpt["args"]), dtype=dtype)
    return model, info, convert_sync_checkpoint(ckpt, target_seq_len=info["target_seq_len"])


def test_tiny_model_from_reference_ckpt_matches_jax(ref_ckpt):
    """The port and JAX on the same .pt: info equal, the weights the file's,
    the same fixed-offset item (the port's prepare_clip against JAX
    prepare_item on the JAX decode), logits within 1e-5 in f32."""
    from synchformer_tpu.data.media import get_video_and_audio
    from synchformer_tpu.data.transforms import SyncPipelineConfig, prepare_item
    from synchformer_tpu.ops.mel import MelSpectrogramConfig, log_mel_spectrogram
    from synchformer_tpu.ops.video import prepare_video_batch

    root, exp, sd = ref_ckpt
    path = str(root / f"{exp}.pt")
    model, info = texample.load_sync_checkpoint(path)
    jmodel, jinfo, params = jax_from_ckpt(path)
    assert info == jinfo
    got_sd = model.state_dict()
    assert sorted(got_sd) == sorted(sd)
    for name, arr in sd.items():
        np.testing.assert_array_equal(got_sd[name].numpy(), arr, err_msg=name)
    item = texample.prepare_clip(CLIP, OFFSET, 0.0, info)
    video, audio, _ = get_video_and_audio(CLIP)
    data = jinfo["data"]
    cfg = SyncPipelineConfig(**{k: data[k] for k in texample.PIPELINE_KEYS if k in data},
                             num_off_cls=jinfo["num_cls"])
    jitem = prepare_item(video, audio, cfg, np.random.default_rng(0), split="test",
                         fixed_offset_sec=OFFSET, fixed_v_start_sec=0.0)
    for key in ("video", "audio", "offset_target"):
        np.testing.assert_array_equal(item[key], jitem[key], err_msg=key)

    @jax.jit
    def infer(params, video_u8, pcm):
        vis = prepare_video_batch(video_u8[None], train=False, dtype=jnp.float32)
        mel = log_mel_spectrogram(pcm[None], MelSpectrogramConfig(
            max_spec_t=jinfo["max_spec_t"], n_mels=jinfo["num_mel_bins"]))
        return jmodel.apply({"params": params}, vis, jnp.swapaxes(mel, -1, -2))[1][0]

    want = np.asarray(infer(params, jnp.asarray(jitem["video"]), jnp.asarray(jitem["audio"])))
    logits, impl, launches = texample.predict(model, info, item, "cpu", fp32=True)
    assert (impl, launches) == ("plain", {})
    np.testing.assert_allclose(logits, want, **REF)


def test_sync_state_dict_reader_matches_jax_converter(ref_ckpt):
    """sync_state_dict_from_ckpt on the .pt (and on its bare state dict):
    module. stripped, the sync position embedding cut to a shorter target
    as convert_sync_checkpoint cuts it; load_sync_state_dict raises on a
    missing or misshapen tensor, naming it, and returns the entries no
    model reads."""
    from synchformer_tpu.utils.checkpoint import convert_sync_checkpoint

    from synchformer_tpu_torch.utils.checkpoint import load_torch_checkpoint

    root, exp, sd = ref_ckpt
    ckpt = load_torch_checkpoint(str(root / f"{exp}.pt"))
    got = convert.sync_state_dict_from_ckpt(ckpt, 10)
    want = convert.state_dict_from_jax(convert_sync_checkpoint(ckpt, target_seq_len=10))
    assert set(want) <= set(got) and set(got) - set(want) == {UNREAD}
    for name, arr in want.items():
        np.testing.assert_array_equal(got[name].numpy(), arr, err_msg=name)
    bare = convert.sync_state_dict_from_ckpt(ckpt["model"], None)
    assert bare[convert.SYNC_POS_EMB].shape[1] == 14 and not any("module." in k for k in bare)
    with pytest.raises(ValueError, match="shorter"):
        convert.sync_state_dict_from_ckpt(ckpt, 15)
    model, _ = build_synchformer_from_ckpt_args(REF_STYLE_CFG)
    assert convert.load_sync_state_dict(model, bare) == [UNREAD]
    lacking = {k: v for k, v in bare.items() if k != "transformer.ln_f.bias"}
    with pytest.raises(KeyError, match="transformer.ln_f.bias"):
        convert.load_sync_state_dict(model, lacking)
    bad = {**bare, "vproj.bias": torch.zeros(5)}
    with pytest.raises(ValueError, match="vproj.bias"):
        convert.load_sync_state_dict(model, bad)


def top5(text: str) -> list:
    """The printed predictions: (p, logit, label, seconds) per line."""
    pat = re.compile(r"p=([\d.]+) \((-?[\d.]+)\), label=(\d+) \((-?[\d.]+) sec\)")
    return [tuple(float(g) for g in m.groups()) for m in pat.finditer(text)]


def test_example_cli_matches_jax_example(ref_ckpt, monkeypatch):
    """python -m synchformer_tpu_torch.example device=cpu fp32=true against
    example.py fp32=true on the same .pt and synthetic:// clip: the same
    target line and top 5 (labels exact; probabilities and logits, printed
    to 4 decimals, within 1e-4). Without fp32 it runs the bf16 route and
    says so; without device=cpu and no card it refuses."""
    root, exp, _ = ref_ckpt
    argv = [f"exp_name={exp}", f"vid_path={CLIP}", f"offset_sec={OFFSET}", f"ckpt_dir={root}"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        texample.main(argv + ["device=cpu", "fp32=true", f"out={root / 'pred.npz'}"])
    got = out.getvalue()
    monkeypatch.syspath_prepend(str(REPO))
    import example as jexample

    monkeypatch.setattr(sys, "argv", ["example.py", *argv, "fp32=true"])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        jexample.main()
    want = out.getvalue()
    assert got.splitlines()[0] == want.splitlines()[0]  # the offset and target class
    assert "impl=plain dtype=float32 device=cpu" in got
    g, w = top5(got), top5(want)
    assert len(g) == len(w) == 5
    assert [r[2] for r in g] == [r[2] for r in w]
    np.testing.assert_allclose(np.array(g), np.array(w), rtol=0, atol=1e-4)
    saved = np.load(root / "pred.npz")
    assert saved["probs"].shape == (21,) and int(saved["offset_target"]) == 18
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        texample.main(argv + ["device=cpu"])
    assert "impl=kernel dtype=bfloat16 device=cpu" in out.getvalue()
    assert len(top5(out.getvalue())) == 5
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="device=cpu"):
            texample.main(argv)


def narrow_synchformer(n_segments: int = 14, syncability: bool = False, device=None):
    """The preset's architecture at narrow widths: towers of one layer of one
    head of 64, the published frame and mel geometry (8 x 196 patches, 74
    AST tokens), a one-layer GlobalTransformer of one head; pos-emb 2 + 14
    n_segments."""
    return Synchformer(vfeat_extractor=dict(depth=1, num_heads=1),
                       afeat_extractor=dict(depth=1, num_heads=1), d=64,
                       n_segments=n_segments, n_layer=1, n_head=1, syncability=syncability,
                       device=device).eval()


def test_syncability_cli_matches_jax(tmp_path, monkeypatch):
    """The syncability CLI's main (device=cpu) over a SyntheticAV
    loader (8 clips at B=3: the tail batch wrap-padded) with narrow models
    read from reference-style .pt files: metrics_sync, the ROC pickle and
    the tiered pickle equal JAX evaluate_syncability's on the same batches
    and the logits the port computed for them."""
    from synchformer_tpu.train.syncability_eval import evaluate_syncability

    paths = {}
    for name, n_seg, sync in (("sync", 13, True), ("off", 14, False)):
        sd = convert.seeded_state_dict(narrow_synchformer(n_seg, sync), 11 + n_seg)
        paths[name] = save_reference_ckpt(str(tmp_path / f"{name}.pt"), sd, None)
    monkeypatch.setattr(tsync_cli, "build_synchformer", narrow_synchformer)
    calls = []
    real_eval_fn = tsync_cli.eval_fn

    def recording_eval_fn(pred):
        run = real_eval_fn(pred)

        def rec(batch):
            out = run(batch)
            calls.append((batch["video"].shape[1], out.numpy().copy()))
            return out
        return rec

    monkeypatch.setattr(tsync_cli, "eval_fn", recording_eval_fn)
    argv = [f"ckpt_sync={paths['sync']}", f"ckpt_off={paths['off']}",
            "dataset=synchformer_tpu.data.datasets.SyntheticAV", "batch_size=3",
            "iter_times=1", f"logdir={tmp_path / 'port'}", "device=cpu"]
    out = tsync_cli.main(argv)
    assert out["n_evaluated"] == 8 and len(calls) == 6

    batches = list(tsync_cli.make_loader(dict(a.split("=", 1) for a in argv)))
    logits = {13: [c[1] for c in calls if c[0] == 13], 14: [c[1] for c in calls if c[0] == 14]}

    class Loader:
        def set_epoch(self, epoch):
            pass

        def __iter__(self):
            return iter(batches)

    def step(params, batch):
        return logits[batch["video"].shape[1]].pop(0)

    want = evaluate_syncability("sync", None, Loader(), step, model_off="off", params_off=None,
                                eval_step_off=step, iter_times=1, n_segments_sync=13,
                                logdir=str(tmp_path / "jax"))
    assert out["metrics_sync"] == want["metrics_sync"]
    assert out["tiered"] == want["tiered"]
    for name in ("roc_test.pkl", "metrics_test.pkl"):
        with open(tmp_path / "port" / name, "rb") as f:
            got_p = pickle.load(f)
        with open(tmp_path / "jax" / name, "rb") as f:
            want_p = pickle.load(f)
        if name == "metrics_test.pkl":
            assert got_p == want_p
            continue
        assert got_p.keys() == want_p.keys()
        for k in ("fpr", "tpr", "thresholds"):
            np.testing.assert_allclose(got_p[k], want_p[k], rtol=0, atol=1e-6, err_msg=k)
        assert abs(got_p["roc_curve_sc"] - want_p["roc_curve_sc"]) <= 1e-6


def test_filter_too_short_videos_matches_jax():
    """The exclusion list and the filter against JAX's on a dataset holding
    three of the listed videos among others."""
    from synchformer_tpu.train import syncability_eval as jsync

    assert tsync.VIDEO_IDS_SHORTER_THAN_9_6_SEC == jsync.VIDEO_IDS_SHORTER_THAN_9_6_SEC

    class Rec:
        def __init__(self, path):
            self.path = path

    class DS:
        def __init__(self):
            listed = sorted(jsync.VIDEO_IDS_SHORTER_THAN_9_6_SEC)[:3]
            self.records = [Rec(f"/v/{name}") for name in listed + ["keep_0.mp4", "keep_1.mp4"]]

    port, ref = DS(), DS()
    assert tsync.filter_too_short_videos(port) == jsync.filter_too_short_videos(ref) == 3
    assert [r.path for r in port.records] == [r.path for r in ref.records]
    assert tsync.filter_too_short_videos(port) == 0
