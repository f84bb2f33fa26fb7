"""Entry ``sync_train_step``: the Stage II step,
``synchformer_tpu_torch.train.stage_sync.SyncTrainer.train_step``, back to
back on pooled batches of uint8 frames, PCM and offset targets, the towers
frozen (drivers/_train.py)."""
from __future__ import annotations

from benchmark.drivers._train import TrainDriver
from benchmark.flops import model as mflops


class Driver(TrainDriver):
    def make_trainer(self, cfg: dict, model):
        from synchformer_tpu_torch.train.stage_sync import SyncTrainer

        return SyncTrainer(cfg, device=self.device, model=model, impl="kernel")

    def model_flops(self, units: int) -> float:
        """The model FLOPs of ``units`` steps."""
        return units * mflops.sync_step_flops(self.sizes, self.traffic["batch"])
