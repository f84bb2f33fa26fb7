"""Tensor parallelism (parallel/tensor.py): the port's sharded parameters
against the JAX mesh's param_shardings, and the entry point on a (1 x 2)
grid of ranks.

- The layout, host only: each model built from a shipped config section at
  its published widths on the meta device (sync.yaml, ft_synchability.yaml,
  segment_avclip.yaml with Linear projections, the same section as a
  MultilevelMoCoCLIP with global representations, the legacy sync model on
  its S3D and ResNet-18 towers) shards exactly the port names of the leaves that param_shardings
  shards on an in-process make_mesh(n_data=2, n_model=m), m = 2, 3, 4 (the
  JAX tree from jax.eval_shape of the model's init, each leaf's flag mapped
  to port names by utils/convert.py's converters on zero-stride arrays). At
  m = 3 the GlobalTransformer's 21-way offset head (JAX's LinearBridge)
  divides and is sharded. At m = 2 the sync model shards 234,988,800 of its
  236,869,653 parameters.
- ``python -m synchformer_tpu_torch.main`` on smoke.yaml with
  training.model_parallel=2 in two processes under torchrun's variables on
  the CPU (gloo): both exit 0, and rank 0's checkpoint holds the trainable
  parameters and the optimizer's moments with a model_parallel 1 model's
  names and shapes. At model_parallel 3 the same world of 2 is refused on
  both ranks. The two groups run at once; each has a 60 s timeout and its
  spawn 110 s.
"""
import copy
import functools
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_dist_worker as worker

from synchformer_tpu_torch.config.core import load_config
from synchformer_tpu_torch.models import presets
from synchformer_tpu_torch.parallel.tensor import sharded_entries
from synchformer_tpu_torch.registry import instantiate_from_config
from synchformer_tpu_torch.train.state import SYNC_TRAINABLE_KEYS
from synchformer_tpu_torch.utils import convert

torch.set_num_threads(2)

CONFIGS = Path(__file__).resolve().parents[1] / "synchformer_tpu" / "config" / "configs"
SMOKE = "synchformer_tpu/config/configs/smoke.yaml"
D = 768


def _section(name: str) -> dict:
    return load_config(str(CONFIGS / f"{name}.yaml")).to_dict()["model"]


def _avclip_linear() -> dict:
    node = _section("segment_avclip")
    lin = {"target": "torch.nn.Linear", "params": {"in_features": D, "out_features": D}}
    node["params"].update(aproj=lin, vproj=lin)
    return node


def _moco() -> dict:
    node = _avclip_linear()
    node["target"] = "synchformer_tpu.models.moco_clip.MultilevelMoCoCLIP"
    node["params"].pop("gather_for_loss")
    node["params"].update(queue_size=8, momentum=0.995)
    for tower in ("afeat_extractor", "vfeat_extractor"):
        node["params"][tower]["params"]["add_global_repr"] = True
    return node


MODELS = {
    "sync": (lambda: _section("sync"), convert.state_dict_from_jax),
    "ft_synchability": (lambda: _section("ft_synchability"), convert.state_dict_from_jax),
    "avclip_linear": (_avclip_linear, convert.avclip_state_dict_from_jax),
    "moco": (_moco, convert.moco_state_dict_from_jax),
    "legacy": (lambda: presets.legacy_sync_model(14), convert.state_dict_from_jax),
}


@functools.lru_cache(maxsize=None)
def _models(name: str):
    """(JAX variables' shapes, the port model on the meta device) of one
    config node."""
    from synchformer_tpu.registry import instantiate_from_config as jax_instantiate

    make, _ = MODELS[name]
    tree = jax.eval_shape(jax_instantiate(copy.deepcopy(make())).init, jax.random.PRNGKey(0),
                          jnp.zeros((1, 1, 16, 224, 224, 3)), jnp.zeros((1, 1, 66, 128)))
    return tree, instantiate_from_config(make(), device="meta")


def _zeros(tree):
    return jax.tree.map(lambda s: np.broadcast_to(np.zeros((), np.float32), s.shape), tree)


@pytest.mark.parametrize("n_model", [2, 3, 4])
@pytest.mark.parametrize("name", list(MODELS))
def test_sharded_set_equals_param_shardings(name, n_model):
    """The port's sharded parameters (sharded_entries) are exactly the port
    names of the leaves param_shardings shards on a (2 x n_model) mesh."""
    from synchformer_tpu.parallel.mesh import MODEL_AXIS, make_mesh, param_shardings

    tree, port = _models(name)
    shardings = param_shardings(tree["params"], make_mesh(n_data=2, n_model=n_model))
    flags = jax.tree.map(lambda s, sh: np.broadcast_to(np.float32(MODEL_AXIS in tuple(sh.spec)),
                                                       s.shape), tree["params"], shardings)
    variables = {"params": flags, **({"batch_stats": _zeros(tree["batch_stats"])}
                                     if "batch_stats" in tree else {})}
    sd = MODELS[name][1](variables if name == "legacy" else flags)
    want = {k for k, v in sd.items() if np.ndim(v) and v[(0,) * np.ndim(v)] > 0}
    got = {f"{path}.{p}" if path else p for path, _, p in sharded_entries(port, n_model)}
    assert got == want
    assert got and set(sd) == set(port.state_dict())
    off_head = {k for k in got if ".off_head." in k}
    assert bool(off_head) == (n_model == 3 and name in ("sync", "legacy"))
    if name == "sync" and n_model == 2:
        params = dict(port.named_parameters())
        assert sum(p.numel() for p in params.values()) == 236_869_653
        assert sum(params[k].numel() for k in got) == 234_988_800


@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    """The entry point at model_parallel 2 and at 3 over two ranks, at once."""
    logs = {mp: tmp_path_factory.mktemp(f"tp_cli_{mp}") for mp in (2, 3)}
    groups = {mp: worker.spawn(lambda r, mp=mp: [
        sys.executable, "-m", "synchformer_tpu_torch.main", f"config={SMOKE}", "device=cpu",
        f"training.model_parallel={mp}", "training.num_epochs=1", "training.num_workers=1",
        "data.dataset.params.n_clips=8", f"logging.logdir={logs[mp]}"], 2) for mp in (2, 3)}
    return {mp: (worker.wait(procs), logs[mp]) for mp, procs in groups.items()}


def test_main_trains_at_model_parallel_2(cli):
    """Both ranks exit 0; rank 0's latest checkpoint holds the trainable
    parameters and the Adam moments under a model_parallel 1 model's names
    and shapes, finite."""
    outs, logdir = cli[2]
    for r, (code, _, err) in enumerate(outs):
        assert code == 0, f"rank {r}: {err[-3000:]}"
    (run,) = [p for p in logdir.iterdir() if p.is_dir()]
    payload = torch.load(run / "ckpts" / "latest" / "0.pt", weights_only=True)
    model = instantiate_from_config(load_config(SMOKE).to_dict()["model"], device="meta")
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()
            if k.split(".", 1)[0] in SYNC_TRAINABLE_KEYS}
    assert {k: tuple(v.shape) for k, v in payload["trainable"].items()} == want
    assert all(torch.isfinite(v).all() for v in payload["trainable"].values())
    trainable = [v for k, v in model.named_parameters() if k.split(".", 1)[0]
                 in SYNC_TRAINABLE_KEYS]
    state = payload["opt_state"]["state"]
    assert len(state) == len(trainable)
    for i, p in enumerate(trainable):
        for key in ("exp_avg", "exp_avg_sq"):
            assert tuple(state[i][key].shape) == tuple(p.shape), (i, key)


def test_main_refuses_a_world_that_does_not_split(cli):
    """training.model_parallel 3 over two ranks fails on both, naming the
    split."""
    outs, _ = cli[3]
    for r, (code, _, err) in enumerate(outs):
        assert code != 0, f"rank {r} accepted model_parallel 3 at world 2"
        assert "world 2 does not split into model_parallel 3" in err, err[-2000:]
