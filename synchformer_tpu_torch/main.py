"""Command-line entry point of the port (the counterpart of main.py):

    python -m synchformer_tpu_torch.main config=<yaml> [k.path=v ...] [device=cpu]
    python -m torch.distributed.run --nproc_per_node N \\
        -m synchformer_tpu_torch.main config=<yaml> [k.path=v ...] [device=cpu]

YAML + CLI-dotlist merge (CLI wins), the config sanity pass, then dispatch on
``cfg.action`` (ref: main.py:8-46):

- train_avclip                       -> Stage I contrastive pre-training
- train_avsync_model                 -> Stage II offset training
- ft_avsync_model_for_syncability    -> Stage III syncability fine-tune

``device`` is an argument of the command, not a config key: it defaults to
``cuda``, and the trainers raise where CUDA is not available unless it names
the CPU. Run plainly, it is one process on one device. Under the launcher
(torchrun's RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT) every
process joins one group before the dispatch (parallel/dist.py
init_from_env: NCCL and the card cuda:LOCAL_RANK on ``cuda``, gloo with
``device=cpu``) and trains on a (n_data x training.model_parallel) grid of
ranks: training.base_batch_size is the global batch, split over the n_data
= world / model_parallel data ranks, Stage II/III's learning rate is
base_learning_rate x n_data, and at model_parallel above 1 the parameters
that the JAX mesh shards are stored as shards over each model group
(parallel/tensor.py). A world that does not split into model_parallel is
refused. The group is left at the end, whatever the outcome; a rank that
fails fails the run.
"""
from __future__ import annotations

import logging
import sys
from typing import Any, Optional, Sequence, Tuple


def get_config(argv: Sequence[str]) -> Tuple[Any, str]:
    """argv -> (the merged, checked config, the device)."""
    from synchformer_tpu_torch.config.core import load_config, merge_cli_overrides
    from synchformer_tpu_torch.config.sanity import cfg_sanity_check_and_patch

    kv = dict(item.split("=", 1) for item in argv if "=" in item)
    if "config" not in kv:
        raise SystemExit("usage: python -m synchformer_tpu_torch.main config=<yaml> "
                         "[k.path=v ...] [device=cpu]")
    device = kv.pop("device", "cuda")
    cfg = load_config(kv.pop("config"))
    merge_cli_overrides(cfg, [f"{k}={v}" for k, v in kv.items()])
    cfg_sanity_check_and_patch(cfg)
    return cfg, device


def main(argv: Optional[Sequence[str]] = None) -> Any:
    """Run the action of the config that ``argv`` (default sys.argv[1:])
    names; returns the trainer's results."""
    from synchformer_tpu_torch.parallel import dist as pdist

    logging.basicConfig(level=logging.INFO)
    cfg, device = get_config(sys.argv[1:] if argv is None else argv)
    action = cfg["action"]
    cfg_dict = cfg.to_dict()
    device = pdist.init_from_env(device)
    try:
        if action == "train_avclip":
            from synchformer_tpu_torch.train.stage_clip import train

            return train(cfg_dict, device=device)
        if action in ("train_avsync_model", "ft_avsync_model_for_syncability"):
            from synchformer_tpu_torch.train.stage_sync import train

            return train(cfg_dict, device=device)
        raise NotImplementedError(f"action {action!r}")
    finally:
        pdist.destroy()


if __name__ == "__main__":
    main()
