"""The plain reference against the port at tiny sizes on the CPU, both in
float32: sync inference, the Stage I step and the Stage II step, from the
same seeded weights, batches and draws. Close agreement here says the
reference computes the configuration (and draws the steps' masks in the
port's order); the bf16 program is judged against it on the card."""
import copy

import pytest
import torch

from benchmark import checks, inputs
from benchmark.drivers._train import CHECKED_STEPS
from benchmark.reference import synchformer as ref
from benchmark.tests.tiny import tiny_cell

SEED = 2 ** 31 + 12345
CPU = torch.device("cpu")


def _model(cell):
    from synchformer_tpu_torch.registry import instantiate_from_config

    model = instantiate_from_config(cell["config"]["model"], device=CPU)
    model.load_state_dict(ref.make_weights(cell["sizes"], SEED, CPU), strict=True)
    return model


def test_weights_are_the_seeds():
    s = tiny_cell("sync_offline_b8")["sizes"]
    a, b = ref.make_weights(s, SEED, CPU), ref.make_weights(s, SEED, CPU)
    c = ref.make_weights(s, SEED + 1, CPU)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["vproj.weight"], c["vproj.weight"])
    assert float(a["transformer.ln_f.weight"].min()) == 1.0
    assert float(a["vproj.weight"].std()) == pytest.approx(0.02, rel=0.1)


def test_sync_inference_f32():
    from synchformer_tpu_torch.infer import SyncPredictor

    cell = tiny_cell("sync_offline_b8")
    s = cell["sizes"]
    batch = inputs.make_pool(s, cell["traffic"], SEED, CPU)[0]
    pred = SyncPredictor(_model(cell), CPU, torch.float32, impl="plain")
    got = pred.logits(batch["patches"], batch["audio"]).double()
    want = ref.sync_logits(ref.Numerics(), ref.make_weights(s, SEED, CPU), s,
                           batch["patches"], batch["audio"]).double()
    assert float((got - want).abs().max()) < 2e-4 * float(want.abs().max())
    probs = torch.softmax(got, -1)
    assert checks.logit_gap([probs], torch.softmax(want, -1)) < 1e-3


def _program_steps(cell, trainer_cls, f32_cfg):
    cfg = copy.deepcopy(cell["config"]["trainer"])
    cfg["training"].update(seed=SEED, **f32_cfg)
    trainer = trainer_cls(cfg, device=CPU, model=_model(cell), impl="plain")
    pool = inputs.make_pool(cell["sizes"], cell["traffic"], SEED, CPU)
    batches = [{"video": b["frames"], "audio": b["audio"],
                **({"offset_target": b["offset_target"]} if "offset_target" in b else {})}
               for b in pool]
    named = dict(trainer.model.named_parameters())
    names = ref.trainable_names(cell["sizes"], [k for k, p in named.items() if p.requires_grad])
    losses, grad = [], None
    for i in range(CHECKED_STEPS):
        losses.append(trainer.train_step(batches[i])["loss"])
        if i == 0:
            st = trainer.optimizer.state
            grad = {k: float(st[named[k]]["exp_avg"].norm()) / 0.1 for k in names}
    w0 = ref.make_weights(cell["sizes"], SEED, CPU)
    change = {k: float((named[k].detach() - w0[k]).norm()) for k in names}
    reference = ref.reference_steps(cell["sizes"], w0, batches[:CHECKED_STEPS], SEED)
    return checks.train_readings({"losses": losses, "grad": grad, "change": change}, reference)


def test_stage1_step_f32():
    from synchformer_tpu_torch.train.stage_clip import AVCLIPTrainer

    r = _program_steps(tiny_cell("stage1_avclip_b2"), AVCLIPTrainer, {"precision": "f32"})
    assert r["loss_gap"] < 1e-5 and r["grad_gap"] < 1e-3 and r["change_gap"] < 1e-2, r


def test_stage2_step_f32():
    from synchformer_tpu_torch.train.stage_sync import SyncTrainer

    r = _program_steps(tiny_cell("stage2_sync_b16"), SyncTrainer,
                       {"use_half_precision": False})
    # the change of the offset transformer's query and key matrices, whose
    # gradient elements at initialisation lie near Adam's eps (1e-7), moves
    # with round-off: 1.4% between two float32 orders of the same sums
    assert r["loss_gap"] < 1e-5 and r["grad_gap"] < 1e-3 and r["change_gap"] < 5e-2, r


def test_fp8_control_rounds_every_product():
    a = torch.randn(16, 32, dtype=torch.float64).float()
    q = ref._fp8(a)
    rel = float((q - a).abs().max() / a.abs().max())
    assert 1e-3 < rel < 0.07  # e4m3: 3 mantissa bits
    nm = ref.Numerics("fp8")
    x = torch.randn(4, 8, requires_grad=True)
    w = torch.randn(3, 8, requires_grad=True)
    nm.linear(x, w).sum().backward()
    assert x.grad.shape == x.shape and w.grad.shape == w.shape
