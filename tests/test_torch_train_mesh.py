"""The port's trainer over a (data, model) layout of ranks against the JAX
package's trainer on the same mesh, on the CPU.

JAX's ``ContrastiveTrainer`` runs on ``make_train_mesh`` (2, 1), (1, 2)
and (2, 2) over the virtual CPU devices; the port's on 2, 2 and 4 gloo
ranks in child processes (``tests/torch_mh_child.py``, one
``spawn_ranks`` run a layout, each with its own timeout).  Both start
from the same weights (``test_torch_train.py``'s seeded tiny encoder,
mapped with ``params_from_flax``) and take 3 clipped steps (``clip_norm``
0.05, under the gradient's norm; warm-up 2) on a 7-pair batch, which a
data axis of 2 pads by cycling to 8 (one clone row, masked).

Bars, ``test_torch_train.py``'s float32 ones: losses within 1e-5 and
accuracies equal at every step; every parameter within 2e-5 after the 3
steps, the attention key biases within 1.5 x the learning rate (their
true gradient is 0, so they move only by Adam-normalised rounding noise).
Replicated parameters are bit-identical across ranks.
"""

import threading

import jax
import numpy as np
import pytest
import torch

from modular_rag_system_tpu.models.default_ckpt import _flatten, _unflatten
from modular_rag_system_tpu.models.encoder import MiniLMEncoder as JaxEncoder
from modular_rag_system_tpu.models.train import ContrastiveTrainer as JaxTrainer
from modular_rag_system_tpu.models.train import param_spec as jax_param_spec
from modular_rag_system_tpu.parallel.mesh import make_train_mesh as jax_train_mesh
from modular_rag_system_tpu_torch.models.default_ckpt import params_from_flax
from modular_rag_system_tpu_torch.models.encoder import MiniLMEncoder
from modular_rag_system_tpu_torch.models.train import (
    ContrastiveTrainer,
    param_spec,
    shard_params,
)
from modular_rag_system_tpu_torch.parallel.mesh import make_train_mesh
from modular_rag_system_tpu_torch.parallel.mh_check import spawn_ranks
from tests import torch_mh_child as child
from tests.conftest import cpu_mesh_devices

LAYOUTS = [(2, 1), (1, 2), (2, 2)]
REPO = str(__import__("pathlib").Path(__file__).resolve().parents[1])


def _tol(name):
    return 1.5 * child.LR if name.endswith("attn.key.bias") else 2e-5


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Per layout: the port's per-rank reports and JAX's (loss, acc)
    steps, parameters after them and the next step's loss."""
    root = tmp_path_factory.mktemp("train_mesh")
    flat = child.seeded_flat()
    errors = []

    def port(D, M):
        try:
            spawn_ranks(["-m", "tests.torch_mh_child", "train", str(D), str(M),
                         str(root / f"{D}x{M}")], D * M, timeout=120, cwd=REPO)
        except RuntimeError as e:
            errors.append(e)

    for D, M in LAYOUTS:
        (root / f"{D}x{M}").mkdir()
    threads = [threading.Thread(target=port, args=layout) for layout in LAYOUTS]
    for t in threads:
        t.start()
    out = {}
    for D, M in LAYOUTS:  # JAX meanwhile, in this process
        jt = JaxTrainer(JaxEncoder(**child.ARCH, dtype="float32", params=_unflatten(flat)),
                        jax_train_mesh(D, M, devices=cpu_mesh_devices(D * M)),
                        learning_rate=child.LR, clip_norm=child.CLIP,
                        warmup_steps=child.WARMUP)
        steps = [jt.step(child.QS, child.PS) for _ in range(child.STEPS)]
        params = params_from_flax(_flatten(jax.tree.map(np.asarray, jt.params)))
        out[(D, M)] = {"jax_steps": steps, "jax_params": params,
                       "jax_next": jt.step(child.QS, child.PS)}
    for t in threads:
        t.join(timeout=150)
        assert not t.is_alive()
    if errors:
        raise errors[0]
    for D, M in LAYOUTS:
        out[(D, M)]["ranks"] = [torch.load(root / f"{D}x{M}" / f"rank{r}.pt",
                                           weights_only=False) for r in range(D * M)]
        out[(D, M)]["ckpt"] = root / f"{D}x{M}" / "ckpt.pt"
    return out


def _full(reports, M):
    """Full tensors from data row 0's model ranks, by ``param_spec``."""
    row = [r for r in reports if r["cell"][0] == 0]
    assert [r["cell"][1] for r in row] == list(range(M))
    return {k: (v if param_spec(k) is None else
                torch.cat([r["params"][k] for r in row], dim=param_spec(k)))
            for k, v in row[0]["params"].items()}


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda l: f"{l[0]}x{l[1]}")
def test_steps_match_jax(runs, layout):
    run = runs[layout]
    for report in run["ranks"]:
        for (jl, ja), (pl, pa) in zip(run["jax_steps"], report["steps"]):
            assert abs(pl - jl) <= 1e-5 and pa == ja, (pl, jl, pa, ja)
        jl, ja = run["jax_next"]
        pl, pa = report["next_step"]
        assert abs(pl - jl) <= 1e-5 and pa == ja, (pl, jl, pa, ja)


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda l: f"{l[0]}x{l[1]}")
def test_parameters_match_jax(runs, layout):
    run = runs[layout]
    full, jp = _full(run["ranks"], layout[1]), run["jax_params"]
    assert set(full) == set(jp)
    for k in jp:
        torch.testing.assert_close(full[k], jp[k], rtol=0, atol=_tol(k), msg=k)


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda l: f"{l[0]}x{l[1]}")
def test_ranks_hold_consistent_parameters(runs, layout):
    # replicated tensors bit-identical on every rank; a split tensor's
    # part bit-identical across the data ranks that hold it
    reports = runs[layout]["ranks"]
    for a in reports:
        for b in reports:
            for k, v in a["params"].items():
                if param_spec(k) is None or a["cell"][1] == b["cell"][1]:
                    assert torch.equal(v, b["params"][k]), (a["cell"], b["cell"], k)


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda l: f"{l[0]}x{l[1]}")
def test_sync_encoder_publishes_full_weights(runs, layout):
    full = _full(runs[layout]["ranks"], layout[1])
    for report in runs[layout]["ranks"]:
        for k, v in full.items():
            assert torch.equal(report["published"][k], v), k


def test_split_axes_match_jax_param_spec():
    """For every flax leaf, JAX ``param_spec``'s model axis, followed
    through ``params_from_flax``: a leaf whose values are their index
    along that axis lands in one port tensor, which must vary along
    exactly the dim the port's ``param_spec`` splits; and each model
    rank's chunk (``shard_params``) holds exactly the indices JAX's shard
    of that axis holds, so heads split whole."""
    flat = child.seeded_flat()
    M = 2
    for key, leaf in flat.items():
        path = [jax.tree_util.DictKey(k) for k in key.split("/")]
        spec = tuple(jax_param_spec(path, leaf))
        axis = spec.index("model") if "model" in spec else None
        marker = {k: np.zeros_like(v) for k, v in flat.items()}
        if axis is None:
            marker[key] = np.ones_like(leaf)
        else:
            shape = [1] * leaf.ndim
            shape[axis] = leaf.shape[axis]
            marker[key] = np.broadcast_to(
                np.arange(1, leaf.shape[axis] + 1, dtype=np.float32).reshape(shape),
                leaf.shape).copy()
        port = params_from_flax(marker)
        (name,) = [k for k, v in port.items() if v.abs().sum() > 0]
        if axis is None:
            assert param_spec(name) is None, (key, name)
            continue
        t = port[name]
        varies = [d for d in range(t.dim()) if t.shape[d] > 1
                  and not torch.equal(t, t.select(d, 0).unsqueeze(d).expand_as(t))]
        assert varies == [param_spec(name)], (key, name, varies, param_spec(name))
        n = leaf.shape[axis]
        for m in range(M):
            got = set(shard_params({name: t}, M, m)[name].unique().tolist())
            assert got == set(range(m * n // M + 1, (m + 1) * n // M + 1)), (key, m)


def test_checkpoint_from_a_layout_restores_on_one_device(runs):
    """A checkpoint written on (1, 2) (full tensors, rank 0) restores into
    the one-device trainer, whose next step matches the layout's."""
    run = runs[(1, 2)]
    one = ContrastiveTrainer(MiniLMEncoder(**child.ARCH, dtype="float32", device="cpu",
                                           seed=1), learning_rate=child.LR,
                             clip_norm=child.CLIP, warmup_steps=child.WARMUP)
    one.restore_checkpoint(str(run["ckpt"]))
    assert one.step_count == child.STEPS
    for k, v in _full(run["ranks"], 2).items():
        assert torch.equal(one.params[k].detach(), v), k
    loss, acc = one.step(child.QS, child.PS)
    pl, pa = run["ranks"][0]["next_step"]
    assert abs(loss - pl) <= 1e-5 and acc == pa


def test_make_train_mesh_without_a_group():
    mesh = make_train_mesh(1, 1)
    assert (mesh.data_index, mesh.model_index, mesh.shape) == (0, 0, {"data": 1, "model": 1})
    with pytest.raises(ValueError, match="2x1 > 1"):
        make_train_mesh(2, 1)
    # a 1 x 1 layout is the one-device trainer, step for step
    enc = MiniLMEncoder(**child.ARCH, dtype="float32", device="cpu")
    a = ContrastiveTrainer(enc, learning_rate=child.LR)
    b = ContrastiveTrainer(enc, mesh, learning_rate=child.LR)
    for _ in range(2):
        assert a.step(child.QS, child.PS) == b.step(child.QS, child.PS)
    for k, p in a.params.items():
        assert torch.equal(p, b.params[k]), k
