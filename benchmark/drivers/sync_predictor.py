"""Entry ``sync_predictor``: offline sync inference through
``synchformer_tpu_torch.infer.SyncPredictor`` on the kernel route in bf16.

One closed-loop caller sends batches back to back: each unit copies a
pooled batch of patch-major uint8 video and PCM from pinned host memory to
the card, runs the predictor and reads the (B, classes) probabilities
back to the host. The set-up builds the model from the configuration's
node through the port's registry, loads the seeded weights, wraps it in the
predictor and runs the first batch twice (the kernels built or loaded,
every shape of the window warmed).

The check: every delivered answer against the reference's probabilities
of its clips (checks.logit_rms), the reference run once per pooled batch
after the program is freed.
"""
from __future__ import annotations

import collections
import time

import torch

from benchmark import checks, inputs
from benchmark.flops import model as mflops
from benchmark.reference import synchformer as ref


class Driver:
    item_unit = "clips"

    def __init__(self, cell: dict, seed: int, device, fault=None):
        self.cell, self.seed, self.device, self.fault = cell, int(seed), device, fault
        self.sizes, self.traffic = cell["sizes"], cell["traffic"]
        self.answers = collections.defaultdict(list)
        self.marks = []  # (set-up phase, host clock at its end)

    def setup(self) -> None:
        from synchformer_tpu_torch.infer import SyncPredictor
        from synchformer_tpu_torch.registry import instantiate_from_config

        s = self.sizes
        model = instantiate_from_config(self.cell["config"]["model"], device=self.device)
        weights = ref.make_weights(s, self.seed, self.device)
        model.load_state_dict(weights, strict=True)
        del weights
        self.predictor = SyncPredictor(model, self.device, torch.bfloat16, impl="kernel",
                                       max_spec_t=s["audio"]["max_spec_t"],
                                       n_mels=s["audio"]["n_mels"])
        self.marks.append(("model and predictor", time.perf_counter()))
        self.pool = inputs.make_pool(s, self.traffic, self.seed, self.device)
        self.marks.append(("input pool", time.perf_counter()))
        for _ in range(2):
            self._call(self.pool[0])
        self.marks.append(("two warm batches", time.perf_counter()))
        self.answers.clear()

    def _call(self, batch: dict) -> torch.Tensor:
        probs = self.predictor(batch["patches"], batch["audio"])
        if self.fault == "answer_altered":
            probs = torch.cat([probs[:1].roll(1, dims=-1), probs[1:]])
        elif self.fault == "half_batch":
            half = probs.shape[0] // 2
            probs = torch.cat([probs[:half], probs[:probs.shape[0] - half]])
        return probs.cpu()

    def unit(self, i: int) -> int:
        k = i % len(self.pool)
        self.answers[k].append(self._call(self.pool[k]))
        return self.traffic["batch"]

    def spans(self, tracer) -> None:
        model = self.predictor.model
        tracer.span_module("video_tower", model.vfeat_extractor)
        tracer.span_module("audio_tower", model.afeat_extractor)

    def model_flops(self, units: int) -> float:
        """The model FLOPs of ``units`` batches."""
        return units * self.traffic["batch"] * mflops.sync_forward_flops(self.sizes)

    def close_program(self) -> None:
        self.predictor = None

    def reference(self, numerics: str = "f32") -> dict:
        """The reference's probabilities of each pooled batch that was
        answered, after the program is freed."""
        ref.no_tf32()
        s = self.sizes
        weights = ref.make_weights(s, self.seed, self.device)
        nm = ref.Numerics(numerics)
        out = {}
        for k in sorted(self.answers):
            batch = inputs.to_device(self.pool[k], self.device)
            out[k] = torch.softmax(ref.sync_logits(nm, weights, s, batch["patches"],
                                                   batch["audio"]).double(), dim=-1).cpu()
        return out

    def compare(self, reference: dict, answers: dict = None) -> dict:
        answers = self.answers if answers is None else answers
        return {"logit_rms": max(checks.logit_rms(answers[k], probs)
                                 for k, probs in reference.items())}

    def control(self, reference: dict, lower: dict) -> dict:
        """The control's readings: the reference in a lower precision put in
        the program's place."""
        return self.compare(reference, {k: [v] for k, v in lower.items()})

    def detail(self, reference: dict, lower: dict = None) -> dict:
        """The widest gap and each pooled batch's reading."""
        answers = self.answers if lower is None else {k: [v] for k, v in lower.items()}
        return {"logit_gap": max(checks.logit_gap(answers[k], probs)
                                 for k, probs in reference.items()),
                "logit_rms_batches": [checks.logit_rms(answers[k], probs)
                                      for k, probs in reference.items()]}

    def readings(self) -> dict:
        return self.compare(self.reference())
