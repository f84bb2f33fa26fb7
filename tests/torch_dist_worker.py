"""One rank of the distributed tests' gloo group (tests/test_torch_distributed*.py,
tests/test_torch_tensor_parallel*.py).

    RANK=r WORLD_SIZE=n MASTER_ADDR=127.0.0.1 MASTER_PORT=p \\
        python tests/torch_dist_worker.py <suite> <workdir>

The test process writes ``<workdir>/inputs.pt`` (state dicts, inputs,
configs), starts ``spawn(...)`` and computes the JAX side meanwhile; each rank
joins the group through parallel/dist.py init_from_env on the CPU, runs every
case of ``<suite>`` and writes ``<workdir>/<suite>_rank<r>.pt``. A case whose
inputs name ``model_parallel`` lays the group out as that (data x model) grid.
This module imports torch and the port only, never JAX. Every rank runs one
thread.
"""
from __future__ import annotations

import copy
import logging
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
# a hang fails within this many seconds: the group's timeout, and the spawn's
GROUP_TIMEOUT_S = 60
SPAWN_TIMEOUT_S = 110


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def group_env(rank: int, world: int, port: int) -> dict:
    """torchrun's variables for ``rank`` of ``world`` on localhost, one
    thread, the group's timeout."""
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH",)}
    # PYTHONHASHSEED: SyntheticAV's clips are seeded by hash(path), which
    # differs between processes unless it is fixed
    env.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world),
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), OMP_NUM_THREADS="1",
               PYTHONHASHSEED="0",
               SFT_DIST_TIMEOUT_S=str(GROUP_TIMEOUT_S), PYTHONPATH=str(REPO))
    return env


def spawn(argv_of_rank, world: int = 2, cwd=REPO) -> list:
    """Start ``world`` processes of one group: ``argv_of_rank(r)`` each."""
    port = free_port()
    return [subprocess.Popen(argv_of_rank(r), cwd=str(cwd), env=group_env(r, world, port),
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in range(world)]


def spawn_suite(suite: str, workdir, world: int = 2) -> list:
    return spawn(lambda r: [sys.executable, str(Path(__file__).resolve()), suite,
                            str(workdir)], world)


def wait(procs, timeout: float = SPAWN_TIMEOUT_S) -> list:
    """Each process's (returncode, stdout, stderr); every process is killed
    past ``timeout`` seconds, and the call raises."""
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            outs.append((p.returncode, out, err))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        errs = [p.communicate()[1][-3000:] for p in procs]
        raise RuntimeError(f"the group did not finish in {timeout} s: {errs}")
    return outs


def results(workdir, suite: str, world: int = 2) -> list:
    return [torch.load(Path(workdir) / f"{suite}_rank{r}.pt", weights_only=False)
            for r in range(world)]


# ---------------------------------------------------------------------------
# the cases, run on every rank


def _rows(x, pdist):
    """This rank's rows of a global batch: its data rank's (every rank's
    at model_parallel 1)."""
    n = x.shape[0] // pdist.n_data()
    return x[pdist.data_rank() * n:(pdist.data_rank() + 1) * n]


def _grads(module) -> dict:
    """Every gradient, each shard's gathered to the whole tensor (a
    tensor-parallel model's)."""
    from synchformer_tpu_torch.parallel import tensor as ptensor

    return ptensor.whole_tensors(module, {n: p.grad.detach().clone()
                                          for n, p in module.named_parameters()
                                          if p.grad is not None})


def _state(module) -> dict:
    """The state dict (whole tensors, also of a tensor-parallel model)."""
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


def _layout(model, optimizer) -> dict:
    """What this rank holds: each parameter as stored (a shard where it is
    sharded), the sharded names, and the bytes of the parameters and of the
    optimizer's moments (its state tensors of a parameter's shape, the
    step count apart)."""
    from synchformer_tpu_torch.parallel import tensor as ptensor

    local = {n: p.detach().clone() for n, p in model.named_parameters()}
    moments = sum(v.numel() * v.element_size() for p in model.parameters()
                  for k, v in optimizer.state.get(p, {}).items()
                  if k != "step" and torch.is_tensor(v) and v.shape == p.shape)
    return {"local": local, "sharded": sorted(ptensor.sharded_names(model)),
            "param_bytes": sum(v.numel() * v.element_size() for v in local.values()),
            "moment_bytes": moments}


def avclip_step(inp, pdist) -> dict:
    """The tiny AVCLIP under DDP on this rank's rows: the loss and gradients
    of one forward / backward, then one avclip_train_step (AdamW, cosine)."""
    from synchformer_tpu_torch.models.presets import build_tiny_avclip
    from synchformer_tpu_torch.parallel import tensor as ptensor
    from synchformer_tpu_torch.train import state as tstate
    from synchformer_tpu_torch.train.step import avclip_train_step
    from synchformer_tpu_torch.utils.convert import load_numpy_state_dict

    pdist.init_grid(inp.get("model_parallel", 1))
    model = build_tiny_avclip()
    load_numpy_state_dict(model, inp["avclip_sd"])
    net = pdist.wrap_ddp(ptensor.shard_model_(model), "cpu")
    vis, aud = _rows(inp["vis"], pdist), _rows(inp["aud"], pdist)
    loss, _, _ = net(vis, aud, "kernel", deterministic=False, generator=torch.Generator())
    loss.backward()
    out = {"loss_local": loss.item(), "loss": pdist.all_reduce_mean(loss.detach()).item(),
           "grads": _grads(model)}
    h = inp["hyper"]
    opt = tstate.make_adamw(model.named_parameters(), h["wd"])
    sched = tstate.make_lr_schedule("cosine", h["lr"], h["warmup"], h["total"])
    metrics = avclip_train_step(net, opt, sched, 0, vis, aud, torch.Generator(), "kernel", 1.0)
    out["metrics"] = {k: float(v) for k, v in metrics.items()}
    out["params"] = _state(model)
    out["layout"] = _layout(model, opt)
    return out


def gathered_infonce(inp, pdist) -> dict:
    """AVCLIP.contrastive_loss on this rank's rows of the global features:
    the loss and the features' gradients of loss / world, with the gather's
    backward as it is and with a planted one that keeps only this rank's
    part of the incoming gradient (no sum over ranks)."""
    from synchformer_tpu_torch.models.presets import build_tiny_avclip

    model = build_tiny_avclip()
    out = {}
    for variant in ("summed", "local_only"):
        saved = pdist._AllGatherWithGrad.backward
        if variant == "local_only":
            pdist._AllGatherWithGrad.backward = staticmethod(
                lambda ctx, g: g[pdist.rank() * ctx.n:(pdist.rank() + 1) * ctx.n])
        try:
            v = _rows(inp["feat_v"], pdist).clone().requires_grad_(True)
            a = _rows(inp["feat_a"], pdist).clone().requires_grad_(True)
            loss = model.contrastive_loss(v, a)
            (loss / pdist.world()).backward()
        finally:
            pdist._AllGatherWithGrad.backward = saved
        out[variant] = {"loss": loss.item(),
                        "loss_mean": pdist.all_reduce_mean(loss.detach()).item(),
                        "grad_v": v.grad.clone(), "grad_a": a.grad.clone()}
    return out


def gather_dict_case(inp, pdist) -> dict:
    from synchformer_tpu_torch.train.metrics import gather_dict

    r = pdist.rank()
    local = {"logits": np.full((3, 2), float(r), np.float32),
             "ragged": np.full((3 - r, 4), float(r), np.float32),
             "as_list": [r, r],
             "loss": float(r), "count": r + 1, "tag": "keep-me"}
    return gather_dict(local)


def sampler_case(inp, pdist) -> dict:
    """EpochSampler's shard, the trainer's rows a rank (its loader's batches)
    and the refusal of a global batch that does not divide."""
    from synchformer_tpu_torch.data.datasets import SyntheticAV
    from synchformer_tpu_torch.data.pipeline import EpochSampler, SyncDataLoader
    from synchformer_tpu_torch.train.stage_clip import AVCLIPTrainer

    out = {"indices": EpochSampler(10, True, 0, pdist.rank(), pdist.world()).indices(3).tolist()}
    cfg = copy.deepcopy(inp["avclip_cfg"])
    tr = AVCLIPTrainer(cfg, device="cpu")
    loader = SyncDataLoader(SyntheticAV("train", n_clips=8), tr.pipe_cfg, tr.local_batch,
                            num_workers=1, seed=0, process_index=pdist.rank(),
                            process_count=pdist.world(), decode_backend="synthetic")
    out["local_batch"] = tr.local_batch
    out["batch_rows"] = [len(b["video"]) for b in loader]
    cfg["training"]["base_batch_size"] = 3
    try:
        AVCLIPTrainer(cfg, device="cpu")
        out["odd_batch"] = "accepted"
    except ValueError as e:
        out["odd_batch"] = str(e)
    return out


def eval_metrics_case(inp, pdist) -> dict:
    """SyncTrainer's valid phase over an odd number of clips (the loader
    keeps its last, short shard; the logits are gathered), and world 1's
    over the same clips: one loader over every clip at the global batch,
    the same eval step and metric calls, no collective."""
    from synchformer_tpu_torch.data.datasets import SyntheticAV
    from synchformer_tpu_torch.data.pipeline import SyncDataLoader
    from synchformer_tpu_torch.train.metrics import calc_cls_metrics, per_class_accuracy
    from synchformer_tpu_torch.train.stage_sync import SyncTrainer

    tr = SyncTrainer(inp["sync_cfg"], device="cpu")
    ds = SyntheticAV("valid", n_clips=inp["n_valid"])
    loader = tr._loader(ds, 1, False, "synthetic")
    logits, targets = tr._eval_pass(loader)
    loader.set_epoch(0)
    metrics = tr.run_phase(loader, 0, "valid")
    whole = SyncDataLoader(ds, tr.pipe_cfg, tr.batch_size, 1, tr.seed, shuffle=False,
                           drop_last=False, decode_backend="synthetic")
    parts = []
    for batch in whole:
        mask = np.asarray(batch["pad_mask"])
        parts.append((tr.eval_step(batch)["logits"].numpy()[mask],
                      np.asarray(batch[tr.target_key])[mask]))
    logits1 = np.concatenate([p[0] for p in parts])
    targets1 = np.concatenate([p[1] for p in parts])
    metrics1 = calc_cls_metrics(targets1, logits1, topk=(1, 5))
    metrics1["per_class"] = per_class_accuracy(targets1, logits1)
    return {"logits": logits, "targets": targets, "metrics": metrics,
            "world1": {"logits": logits1, "targets": targets1, "metrics": metrics1}}


def moco_step(inp, pdist) -> dict:
    """The tiny MoCo under DDP on this rank's rows: each level's loss and the
    gradients of one forward / backward, then one moco_train_step (EMA,
    AdamW, the queues) from the same state."""
    from synchformer_tpu_torch.models.moco_clip import MoCoQueues, moco_forward, momentum_update
    from synchformer_tpu_torch.models.presets import build_tiny_moco_avclip
    from synchformer_tpu_torch.parallel import tensor as ptensor
    from synchformer_tpu_torch.train import state as tstate
    from synchformer_tpu_torch.train.step import moco_train_step
    from synchformer_tpu_torch.utils.convert import load_numpy_state_dict

    h = inp["hyper"]
    pdist.init_grid(inp.get("model_parallel", 1))

    def fresh():
        model = build_tiny_moco_avclip(pos_dropout=h["pos_drop"])
        model_m = build_tiny_moco_avclip(pos_dropout=h["pos_drop"]).requires_grad_(False)
        load_numpy_state_dict(model, inp["moco_sd"])
        load_numpy_state_dict(model_m, inp["moco_m_sd"])
        ptensor.shard_model_(model), ptensor.shard_model_(model_m)
        q = inp["queues"]
        queues = MoCoQueues(torch.tensor(q["segment_v"]), torch.tensor(q["segment_a"]),
                            int(q["segment_ptr"]), torch.tensor(q["global_v"]),
                            torch.tensor(q["global_a"]), int(q["global_ptr"]))
        return model, model_m, queues

    vis, aud = _rows(inp["vis"], pdist), _rows(inp["aud"], pdist)
    model, model_m, queues = fresh()
    net = pdist.wrap_ddp(model, "cpu")
    momentum_update(model, model_m, model.momentum)
    losses, _, _ = moco_forward(net, model_m, queues, vis, aud, "kernel", torch.Generator(),
                                h["alpha"], train=True)
    sum(losses.values()).backward()
    out = {"losses": {k: pdist.all_reduce_mean(v.detach()).item() for k, v in losses.items()},
           "grads": _grads(model)}
    del net
    model, model_m, queues = fresh()
    net = pdist.wrap_ddp(model, "cpu")
    opt = tstate.make_adamw(model.named_parameters(), h["wd"])
    sched = tstate.make_lr_schedule("cosine", h["lr"], h["warmup"], h["total"])
    metrics = moco_train_step(net, model_m, queues, opt, sched, 0, vis, aud, torch.Generator(),
                              h["alpha"], "kernel", 1.0)
    out["metrics"] = {k: float(v) for k, v in metrics.items()}
    out["params"], out["params_m"] = _state(model), _state(model_m)
    out["layout"] = _layout(model, opt)
    out["queues"] = {k: (v.clone() if isinstance(v, torch.Tensor) else v)
                     for k, v in vars(queues).items()}
    return out


def sync_step(inp, pdist, keep: bool = False) -> dict:
    """SyncTrainer (Stage II offsets, or Stage III syncability) on the tiny
    model: its learning rate against base_learning_rate, and, under its DDP
    wrapper on this rank's rows, the loss and trainable gradients of one
    forward / backward and one sync_train_step on its optimizer and
    schedule."""
    from synchformer_tpu_torch.models.presets import build_tiny_synchformer
    from synchformer_tpu_torch.train.stage_sync import SyncTrainer
    from synchformer_tpu_torch.train.step import sync_train_step
    from synchformer_tpu_torch.utils.convert import load_numpy_state_dict

    out = {}
    for name, case in inp["sync_cases"].items():
        model = build_tiny_synchformer(inp["n_segments"], syncability=case["syncability"],
                                       dropout=0.0, drop_path_rate=0.0)
        load_numpy_state_dict(model, case["sd"])
        tr = SyncTrainer(case["cfg"], device="cpu", model=model)
        vis, aud = _rows(inp["vis"], pdist), _rows(inp["aud"], pdist)
        targets = _rows(torch.as_tensor(case["targets"]), pdist).long()
        loss, _ = tr.net(vis, aud, targets, "kernel", deterministic=False,
                         generator=torch.Generator(), extractors_deterministic=True)
        loss.backward()
        res = {"loss": pdist.all_reduce_mean(loss.detach()).item(), "grads": _grads(model),
               "lr": [tr.schedule(s) for s in range(8)]}
        metrics = sync_train_step(tr.net, tr.optimizer, tr.schedule, 0, vis, aud, targets,
                                  torch.Generator(), "kernel", tr.max_clip_norm)
        res["metrics"] = {k: float(v) for k, v in metrics.items()}
        res["params"] = tr.trainable_state_dict()
        if keep:
            res["trainer"] = tr
        out[name] = res
    return out


def checkpoint_case(inp, pdist) -> dict:
    """Stage I fit at world 2: run a (1 epoch), its resume to 2 epochs and run
    c (2 epochs straight); the calls to CheckpointManager's writer on this
    rank; a run whose exp_name is unset (the name is rank 0's)."""
    from synchformer_tpu_torch.data.datasets import SyntheticAV
    from synchformer_tpu_torch.train.stage_clip import AVCLIPTrainer
    from synchformer_tpu_torch.utils.checkpoint import CheckpointManager

    writes = []
    write = CheckpointManager._write
    CheckpointManager._write = lambda self, *a: (writes.append(a[:2]), write(self, *a))[1]

    def fit(exp, epochs, **training):
        cfg = copy.deepcopy(inp["fit_cfg"])
        cfg["logging"]["exp_name"] = exp
        cfg["training"].update(training)
        tr = AVCLIPTrainer(cfg, device="cpu")
        tr.fit(SyntheticAV("train", n_clips=8), SyntheticAV("valid", n_clips=4),
               num_workers=1, max_epochs=epochs, decode_backend="synthetic")
        return tr

    def snap(tr):
        return {"model": _state(tr.model), "opt": copy.deepcopy(tr.optimizer.state_dict()),
                "step": tr.step, "gens": (tr.generator.get_state(),
                                          tr.aug_generator.get_state())}

    out = {"a": snap(fit("a", 1))}
    out["resumed"] = snap(fit("a", 2, resume="latest"))
    out["straight"] = snap(fit("c", 2))
    tr = fit(None, 1)
    out["unnamed"] = tr.logger is None and str(tr.logdir)
    out["writes"] = writes
    return out


def tp_sync_step(inp, pdist) -> dict:
    """sync_step on the (n_data x model_parallel) grid of inp's
    ``model_parallel``: its results with the gradients and parameters
    whole, each rank's layout (_layout), for one sharded weight read as
    the kernels read it (a whole fc2 of the video tower) its contiguity,
    dtype and 16-byte alignment, and whether the trainer's whole state
    (trainable_state_dict, optimizer_state_dict) loads back unchanged."""
    from synchformer_tpu_torch.parallel import tensor as ptensor

    cases = {name: dict(case, cfg=dict(case["cfg"], training=dict(
        case["cfg"]["training"], model_parallel=inp["model_parallel"])))
        for name, case in inp["sync_cases"].items()}
    out = sync_step(dict(inp, sync_cases=cases), pdist, keep=True)
    for name, res in out.items():
        tr = res.pop("trainer")
        res["layout"] = _layout(tr.model, tr.optimizer)
        w2 = tr.model.vfeat_extractor.blocks[0].mlp.fc2.weight
        res["gathered"] = {"contiguous": w2.is_contiguous(), "dtype": str(w2.dtype),
                           "aligned": w2.data_ptr() % 16 == 0, "shape": tuple(w2.shape),
                           "sharded": "vfeat_extractor.blocks.0.mlp.fc2.weight"
                           in ptensor.sharded_names(tr.model)}
        before = {n: p.detach().clone() for n, p in tr.model.named_parameters()}
        moments = copy.deepcopy(tr.optimizer.state_dict()["state"])
        tr.load_trainable(tr.trainable_state_dict())
        ptensor.load_optimizer_state_dict(tr.optimizer, tr.model,
                                          ptensor.optimizer_state_dict(tr.optimizer, tr.model))
        res["round_trip"] = all(torch.equal(p, before[n]) for n, p in
                                tr.model.named_parameters()) and all(
            torch.equal(torch.as_tensor(v), torch.as_tensor(moments[i][k]))
            for i, st in tr.optimizer.state_dict()["state"].items() for k, v in st.items())
    return out


def tp_eval_metrics(inp, pdist) -> dict:
    """eval_metrics_case's world-1 reference on the unsharded model (a
    trainer at model_parallel 1: no collective), then SyncTrainer's valid
    phase on inp's ``model_parallel`` grid over the same clips."""
    cfg = copy.deepcopy(inp["sync_cfg"])
    ref = eval_metrics_case(dict(inp, sync_cfg=cfg), pdist)["world1"]
    cfg["training"]["model_parallel"] = inp["model_parallel"]
    got = eval_metrics_case(dict(inp, sync_cfg=cfg), pdist)
    return {**got, "world1": ref}


def tp_avclip_step(inp, pdist) -> dict:
    """avclip_step on inp['avclip'] (its own inputs and model_parallel)."""
    return avclip_step(inp["avclip"], pdist)


def tp_moco_step(inp, pdist) -> dict:
    """moco_step on inp['moco'] (its own inputs and model_parallel)."""
    return moco_step(inp["moco"], pdist)


def tp_fit_case(inp, pdist) -> dict:
    """Stage I fit on inp's ``model_parallel`` grid: run 'tp' for one epoch
    (saved: whole tensors); a resume of inp's world-1 run 'w1' (one epoch,
    written by the test process) to two epochs on this grid, its state just
    after the resume and at its end. Every snapshot is whole."""
    from synchformer_tpu_torch.data.datasets import SyntheticAV
    from synchformer_tpu_torch.parallel import tensor as ptensor
    from synchformer_tpu_torch.train.stage_clip import AVCLIPTrainer

    def trainer(exp, **training):
        cfg = copy.deepcopy(inp["fit_cfg"])
        cfg["logging"]["exp_name"] = exp
        cfg["training"].update(model_parallel=inp["model_parallel"], **training)
        return AVCLIPTrainer(cfg, device="cpu")

    def fit(tr, epochs):
        tr.fit(SyntheticAV("train", n_clips=8), SyntheticAV("valid", n_clips=4),
               num_workers=1, max_epochs=epochs, decode_backend="synthetic")
        return tr

    def snap(tr):
        return {"model": _state(tr.model),
                "opt": copy.deepcopy(ptensor.optimizer_state_dict(tr.optimizer, tr.model)),
                "step": tr.step, "layout": _layout(tr.model, tr.optimizer)}

    # a fit to max_epochs 1 from a resume after epoch 0 trains nothing:
    # its state is the resumed one
    return {"tp": snap(fit(trainer("tp"), 1)),
            "w1_resumed": snap(fit(trainer("w1", resume="latest"), 1)),
            "w1_continued": snap(fit(trainer("w1", resume="latest"), 2))}


def legacy_bn_tower(inp, pdist) -> dict:
    """ResNet18AudioFeatures in training under DDP on this rank's rows of
    inp['aud'], its loss n_data x sum(features * cotangent) over its rows
    (DDP's mean over the ranks then gives world 1's gradient of the sum over
    the batch): the features, every gradient, the running statistics."""
    from synchformer_tpu_torch.models.resnet_audio import ResNet18AudioFeatures
    from synchformer_tpu_torch.utils.convert import load_numpy_state_dict

    tower = ResNet18AudioFeatures()
    load_numpy_state_dict(tower, inp["resnet_sd"])
    net = pdist.wrap_ddp(tower, "cpu")
    feats = net(_rows(inp["aud"], pdist), "kernel", False, torch.Generator())
    ((feats * _rows(inp["cot"], pdist)).sum() * pdist.n_data()).backward()
    return {"feats": feats.detach(), "grads": _grads(tower),
            "stats": {k: v.clone() for k, v in tower.state_dict().items() if "running" in k}}


def legacy_sync_step(inp, pdist) -> dict:
    """SyncTrainer over the legacy Synchformer with is_trainable towers
    (global batch inp['vis'] / inp['aud'], half a rank): one sync_train_step
    on this rank's rows under DDP; the metrics and the trainable state after
    it (parameters and the towers' running statistics)."""
    from synchformer_tpu_torch.train.stage_sync import SyncTrainer
    from synchformer_tpu_torch.train.step import sync_train_step

    tr = SyncTrainer(inp["legacy_cfg"], device="cpu")
    vis, aud = _rows(inp["vis"], pdist), _rows(inp["aud"], pdist)
    targets = _rows(torch.as_tensor(inp["targets"]), pdist).long()
    metrics = sync_train_step(tr.net, tr.optimizer, tr.schedule, 0, vis, aud, targets,
                              torch.Generator(), "kernel", tr.max_clip_norm,
                              extractors_deterministic=False)
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "state": {k: v.clone() for k, v in tr.trainable_state_dict().items()}}


SUITES = {
    "avclip": (avclip_step, gathered_infonce, gather_dict_case, sampler_case, eval_metrics_case),
    "moco": (moco_step,),
    "sync": (sync_step,),
    "fit": (checkpoint_case,),
    "tp_sync": (tp_sync_step, tp_eval_metrics),
    "tp_stage1": (tp_avclip_step, tp_moco_step, tp_fit_case),
    "legacy": (legacy_bn_tower, legacy_sync_step),
}


def main() -> None:
    suite, workdir = sys.argv[1], Path(sys.argv[2])
    torch.set_num_threads(1)
    logging.basicConfig(level=logging.WARNING)
    from synchformer_tpu_torch.parallel import dist as pdist

    pdist.init_from_env("cpu")
    try:
        inp = torch.load(workdir / "inputs.pt", weights_only=False)
        out = {case.__name__: case(inp, pdist) for case in SUITES[suite]}
        out["world"], out["rank"] = pdist.world(), pdist.rank()
        torch.save(out, workdir / f"{suite}_rank{pdist.rank()}.pt")
    finally:
        pdist.destroy()


if __name__ == "__main__":
    main()
