"""What the training entries share: the trainer built from the
configuration's node and trainer settings with the run's seed, its first
steps driven in the set-up through the window's own call and feed, and the
readings of those steps against the reference's.

Set-up: the model from the configuration's node (the port's registry),
the seeded weights loaded, the trainer around it; then its first
``CHECKED_STEPS`` steps on distinct pooled batches, each through
``train_step`` as the window calls it (they also build or load the kernels
and warm every shape). After the first, each trainable leaf's gradient as
the optimizer received it, from its first moment (exp_avg / (1 - beta1));
after the last, each leaf's change from the seeded weights. The window
then continues the same trainer from step ``CHECKED_STEPS`` on.
"""
from __future__ import annotations

import copy
import time

import torch

from benchmark import checks, inputs
from benchmark.reference import synchformer as ref

CHECKED_STEPS = 3


class TrainDriver:
    item_unit = "steps"

    def __init__(self, cell: dict, seed: int, device, fault=None):
        self.cell, self.seed, self.device, self.fault = cell, int(seed), device, fault
        self.sizes, self.traffic = cell["sizes"], cell["traffic"]
        self.steps = []
        self.marks = []  # (set-up phase, host clock at its end)

    # the entry's own: the trainer class and the batch it takes
    def make_trainer(self, cfg: dict, model):
        raise NotImplementedError

    def trainer_batch(self, batch: dict) -> dict:
        return {"video": batch["frames"], "audio": batch["audio"],
                **({"offset_target": batch["offset_target"]} if "offset_target" in batch
                   else {})}

    def setup(self) -> None:
        from synchformer_tpu_torch.registry import instantiate_from_config

        cfg = copy.deepcopy(self.cell["config"]["trainer"])
        cfg["training"]["seed"] = self.seed
        model = instantiate_from_config(self.cell["config"]["model"], device=self.device)
        model.load_state_dict(ref.make_weights(self.sizes, self.seed, self.device), strict=True)
        self.trainer = self.make_trainer(cfg, model)
        self._plant_fault()
        self.marks.append(("model and trainer", time.perf_counter()))
        self.pool = [self.trainer_batch(b) for b in
                     inputs.make_pool(self.sizes, self.traffic, self.seed, self.device)]
        self.marks.append(("input pool", time.perf_counter()))
        beta1 = float(self.sizes["optimizer"]["betas"][0])
        named = dict(self.trainer.model.named_parameters())
        names = ref.trainable_names(self.sizes, [k for k, p in named.items() if p.requires_grad])
        losses, grad = [], None
        for i in range(CHECKED_STEPS):
            losses.append(self.trainer.train_step(self.pool[i])["loss"])
            if i == 0:
                state = self.trainer.optimizer.state
                grad = {k: float(torch.linalg.vector_norm(state[named[k]]["exp_avg"]))
                        / (1.0 - beta1) if named[k] in state else 0.0 for k in names}
        self.marks.append((f"first {CHECKED_STEPS} steps", time.perf_counter()))
        w0 = ref.make_weights(self.sizes, self.seed, self.device)
        change = {k: float(torch.linalg.vector_norm(named[k].detach().float() - w0[k]))
                  for k in names}
        del w0
        self.checked = {"losses": losses, "grad": grad, "change": change}

    def _plant_fault(self) -> None:
        """The faults a training cell can have, for the check's own tests:
        a step that leaves the state unchanged; half of the batch left out,
        the loss the mean over the rest; one clip's input altered where the
        step prepares it."""
        t = self.trainer
        if self.fault == "state_unchanged":
            t.optimizer.step = lambda *a, **k: None
        elif self.fault in ("half_batch", "row_altered"):
            prepare = t.prepare

            def faulty(batch, train):
                vis, aud = prepare(batch, train)
                if self.fault == "half_batch":
                    half = vis.shape[0] // 2
                    return vis[:half], aud[:half]
                return vis, torch.cat([-aud[:1], aud[1:]])

            t.prepare = faulty
            if self.fault == "half_batch" and hasattr(t, "_targets"):
                targets = t._targets
                t._targets = lambda batch: targets(batch)[:targets(batch).shape[0] // 2]

    def unit(self, i: int) -> int:
        self.steps.append(self.trainer.train_step(
            self.pool[(CHECKED_STEPS + i) % len(self.pool)])["loss"])
        return 1

    def spans(self, tracer) -> None:
        from synchformer_tpu_torch.train import step

        tracer.span_module("forward", self.trainer.net)
        tracer.span_function("optimizer", step, "_apply_update", after="forward")

    def close_program(self) -> None:
        self.trainer = None

    def reference(self, numerics: str = "f32") -> dict:
        """The reference's first steps from the seeded weights, batches and
        draws, after the program is freed."""
        ref.no_tf32()
        w0 = ref.make_weights(self.sizes, self.seed, self.device)
        batches = [inputs.to_device(self.pool[i], self.device) for i in range(CHECKED_STEPS)]
        return ref.reference_steps(self.sizes, w0, batches, self.seed, ref.Numerics(numerics))

    def compare(self, reference: dict) -> dict:
        return checks.train_readings(self.checked, reference)

    def control(self, reference: dict, lower: dict) -> dict:
        """The control's readings: the reference in a lower precision put in
        the program's place."""
        return checks.train_readings(lower, reference)

    def detail(self, reference: dict, lower: dict = None) -> dict:
        return checks.train_detail(self.checked if lower is None else lower, reference)

    def readings(self) -> dict:
        return self.compare(self.reference())
