"""Config cross-field sanity checks (the port's copy of
synchformer_tpu/config/sanity.py::cfg_sanity_check_and_patch; ref:
utils/utils.py:95-148).

Validates action/model/data combinations before an expensive run starts.
"""
from __future__ import annotations

from typing import Any, Mapping

VALID_ACTIONS = ("train_avclip", "train_avsync_model",
                 "ft_avsync_model_for_syncability")


def cfg_sanity_check_and_patch(cfg: Mapping[str, Any]) -> Mapping[str, Any]:
    action = cfg.get("action")
    assert action in VALID_ACTIONS, f"unknown action {action!r} (valid: {VALID_ACTIONS})"

    data = cfg.get("data", {})
    training = cfg.get("training", {})
    model_params = cfg.get("model", {}).get("params", {})

    if action == "train_avclip":
        # towers must agree on the multi-level setup (ref: utils/utils.py:96-101)
        a = model_params.get("afeat_extractor", {}).get("params", {})
        v = model_params.get("vfeat_extractor", {}).get("params", {})
        assert a.get("add_global_repr") == v.get("add_global_repr"), \
            "add_global_repr is diff for A&V"
        assert a.get("max_segments") == v.get("max_segments"), \
            "max_segments is diff for A&V"

    # legacy flag spelling: load_fixed_offsets_on_test -> load_fixed_offsets_on
    # (ref: utils/utils.py:102-110)
    ds_params = data.get("dataset", {}).get("params")
    if isinstance(ds_params, dict) and "load_fixed_offsets_on_test" in ds_params:
        if "load_fixed_offsets_on" not in ds_params:
            ds_params["load_fixed_offsets_on"] = (
                ["val", "valid", "test"]
                if ds_params["load_fixed_offsets_on_test"] else [])
        del ds_params["load_fixed_offsets_on_test"]

    # resume / finetune / run_test_only are pairwise exclusive
    # (ref: utils/utils.py:112-114)
    modes = [m for m in ("resume", "finetune", "run_test_only")
             if training.get(m)]
    assert len(modes) <= 1, f"mutually exclusive training modes set: {modes}"

    # offset parameterization must match the loss family
    # (ref: utils/utils.py:116-121)
    offset_type = data.get("offset_type")
    loss_fn = training.get("loss_fn")
    if offset_type is not None and loss_fn is not None:
        loss_name = loss_fn[1] if isinstance(loss_fn, (list, tuple)) else str(loss_fn)
        if "grid" in offset_type:
            assert "mse" not in loss_name, f"to class but loss: {loss_name}"
        elif "uniform" in offset_type:
            assert "cross_entropy" not in loss_name, f"reg but loss: {loss_name}"

    if "patience" in training:
        assert training["patience"] is not None, "patience is None"
    assert cfg.get("logging", {}).get("log_max_items", 1) > 0, \
        "log_max_items should be > 0"

    # resuming/testing restores the full model ckpt, which already contains
    # the tower weights — drop standalone tower ckpt paths
    # (ref: utils/utils.py:137-142)
    if training.get("resume") or training.get("run_test_only"):
        for tower in ("afeat_extractor", "vfeat_extractor"):
            params = model_params.get(tower, {}).get("params")
            if isinstance(params, dict) and params.get("ckpt_path"):
                params["ckpt_path"] = None

    # pre-proj legacy features cannot be similarity-visualized
    # (ref: utils/utils.py:144-147)
    a_target = model_params.get("afeat_extractor", {}).get("target", "")
    v_target = model_params.get("vfeat_extractor", {}).get("target", "")
    if (a_target.endswith("ResNet18AudioFeatures")
            and v_target.endswith("S3DVisualFeatures")):
        assert not cfg.get("logging", {}).get("vis_segment_sim", False), \
            "logger.vizualize_segment_sim mults pre-proj features"

    if action in ("train_avsync_model", "ft_avsync_model_for_syncability"):
        offset_type = data.get("offset_type", "grid")
        if offset_type == "grid":
            assert int(data.get("num_off_cls", 21)) >= 3, "grid needs >= 3 classes"
        if offset_type == "uniform_binary":
            assert data.get("prob_oos") is not None, \
                "uniform_binary offsets need data.prob_oos"
        # the segment layout must fit inside the temporal crop
        n_seg = int(data.get("n_segments", 14))
        step = float(data.get("step_size_seg", 0.5))
        seg_frames = int(data.get("segment_size_vframes", 16))
        vfps = float(data.get("vfps", 25))
        crop_len = float(data.get("crop_len_sec", 5))
        coverage = (n_seg * step + (1 - step)) * seg_frames / vfps
        assert coverage <= crop_len + 1e-6, \
            f"{n_seg} segments (stride {step}) need {coverage:.2f}s > crop {crop_len}s"
        # audio jitter must stay within half a grid cell
        if data.get("audio_jitter_sec"):
            cell = 2 * float(data.get("max_off_sec", 2)) / (int(data.get("num_off_cls", 21)) - 1)
            assert float(data["audio_jitter_sec"]) - 1e-6 <= cell / 2, \
                "audio jitter larger than half a grid cell breaks the labels"

    if action == "ft_avsync_model_for_syncability":
        tfm = cfg.get("model", {}).get("params", {}).get("transformer", {})
        target = tfm.get("target", "")
        assert "Syncability" in target or target == "", \
            "syncability fine-tuning needs the syncability-head transformer"

    return cfg
