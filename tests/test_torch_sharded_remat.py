"""The train step's checkpoint on DTensors (``parallel.sharding.checkpoint``,
reached from ``models.lm._remat``): each remat region keeps its residuals
split over ``model`` on the sequence, as JAX's partitioned step does.

Two-layer reduced configs at f32: a dense one whose query rows split
(SmolLM's 15 / 5 heads), a parallel block (Command R+'s family: 12 / 4
heads, SwiGLU, untied), and Mamba2.  On four ``gloo`` ranks (a subprocess;
the worker imports no JAX) over ``(data 2, model 2)`` and ``(data 1, model
4)`` meshes, under ``remat="full"`` and ``"dots"``, the loss and every
parameter's gradient equal the one-process plain step's at relative L2
1e-5, and JAX's ``value_and_grad`` at the parity contract's bars (loss rtol
1e-6, gradients rtol 1e-4).  On a ``fake`` (data 1, model 4) mesh of
``meta`` shards traced with ``analysis.cost.trace_cost``, no storage the
forward makes and the loss's graph still holds has the local batch's full
sequence at width ``d_model`` a layer: a cut of four layers holds as many
as a cut of two."""

import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import lm as jax_lm  # noqa: E402
from repro_torch._tree import flatten  # noqa: E402
from repro_torch.analysis import cost  # noqa: E402
from repro_torch.launch import dryrun, shapes  # noqa: E402
from repro_torch.models import common, lm  # noqa: E402
from repro_torch.parallel import sharding  # noqa: E402
from test_torch_train import GRAD, SSD_GRAD, _arch, few_threads  # noqa: E402,F401
from test_torch_train_grads import _seeded_tree  # noqa: E402

#: tag -> (arch, reduce factor, overrides); the vocabularies keep each CE
#: layout: 1024 and 1000 split over ``model``, 1001 splits the rows
CASES = {"dense": ("smollm-360m", 8, dict(num_layers=2, n_heads=15, n_kv_heads=5,
                                          head_dim=8, vocab=1024)),
         "parallel": ("command-r-plus-104b", 64, dict(num_layers=2, n_heads=12,
                                                      n_kv_heads=4, vocab=1000)),
         "ssm": ("mamba2-370m", 8, dict(num_layers=2, vocab=1001))}
MESHES = ((2, 2), (1, 4))
POLICIES = ("full", "dots")
B, S = 2, 64
REL_L2 = 1e-5

#: the worker: each case's seeded parameters (the JAX layout, from the
#: test's ``.npz``) as DTensors of real values over each mesh, the loss
#: and every gradient under each policy, and the same step on plain
#: tensors in one process; rank 0 writes them whole and prints each sharded
#: step's largest relative L2 error against the plain one
GLOO_WORKER = """
import dataclasses, json, socket, sys

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

CASES, MESHES, POLICIES = CASES_, MESHES_, POLICIES_


def unflat(flat, prefix):
    tree = {}
    for key, v in flat.items():
        if key.startswith(prefix):
            node = tree
            *path, last = key[len(prefix):].split("/")
            for p in path:
                node = node.setdefault(p, {})
            node[last] = v
    return tree


def worker(rank, port, inp, out_path):
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=4)
    torch.set_num_threads(1)
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch import convert
    from repro_torch._tree import flatten
    from repro_torch.configs import get_config
    from repro_torch.kernels.ops import register_sharding_rules
    from repro_torch.launch.train import reduce_config
    from repro_torch.models import common, lm
    from repro_torch.parallel import sharding
    from repro_torch.parallel.sharding import NamedSharding, ShardingCtx, logical_to_spec

    register_sharding_rules()
    data = dict(np.load(inp))
    res = {}
    for shape in MESHES:
        dm = DeviceMesh("cpu", torch.arange(4).reshape(shape), mesh_dim_names=("data", "model"))
        mesh = sharding.make_mesh_compat(shape, ("data", "model"), devices=["cpu"] * 4)
        ctx = ShardingCtx(mesh=mesh, mode="train")

        def place(t, axes):
            sh = NamedSharding(mesh, logical_to_spec(axes, tuple(t.shape), mesh, "train"))
            return distribute_tensor(t, dm, sharding.to_placements(sh))

        for tag, (arch, factor, over) in CASES.items():
            tree = unflat(data, tag + "/p/")
            for policy in POLICIES:
                cfg = dataclasses.replace(reduce_config(get_config(arch), factor),
                                          dtype="float32", remat=policy, **over).validate()
                specs = common.spec_leaves(lm.model_specs(cfg))
                flat, unflatten = flatten(convert.lm_params_from_numpy(tree, cfg, device="cpu"))
                xs = [place(t, s.axes).requires_grad_() for t, (_, s) in zip(flat, specs)]
                with implicit_replication():
                    batch = {k: place(torch.from_numpy(data[f"{tag}/b/{k}"]), ("batch", None))
                             for k in ("tokens", "labels")}
                    loss, _ = lm.loss_fn(cfg, unflatten(xs), batch, ctx)
                    grads = torch.autograd.grad(loss, xs)
                key = f"{tag} {shape} {policy}"
                res[key + " loss"] = loss.full_tensor().detach().numpy()
                for (name, _), g in zip(specs, grads):
                    res[f"{key} {name}"] = g.full_tensor().numpy()
                if shape == MESHES[0]:
                    xs = [t.requires_grad_() for t in flat]
                    batch = {k: torch.from_numpy(data[f"{tag}/b/{k}"])
                             for k in ("tokens", "labels")}
                    loss, _ = lm.loss_fn(cfg, unflatten(xs), batch)
                    res[f"{tag} plain {policy} loss"] = loss.detach().numpy()
                    for (name, _), g in zip(specs, torch.autograd.grad(loss, xs)):
                        res[f"{tag} plain {policy} {name}"] = g.numpy()
    if rank == 0:
        np.savez(out_path, **res)
        for key in (f"{t} {m} {p} " for t in CASES for m in MESHES for p in POLICIES):
            ref = key.split()[0] + " plain " + key.split()[-1] + " "
            print("REL", key, max(np.linalg.norm(v - res[ref + k[len(key):]])
                                  / max(np.linalg.norm(res[ref + k[len(key):]]), 1e-30)
                                  for k, v in res.items() if k.startswith(key)), flush=True)
    dist.destroy_process_group()


if __name__ == "__main__":
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    mp.spawn(worker, args=(port, sys.argv[1], sys.argv[2]), nprocs=4, join=True)
""".replace("CASES_", repr(CASES)).replace("MESHES_", repr(MESHES)).replace(
    "POLICIES_", repr(POLICIES))


def _case(tag: str):
    """``(jax config, port config, the seeded tree, the batch)`` of a case."""
    arch, factor, over = CASES[tag]
    jcfg, cfg = _arch(arch, factor, remat="none", **over)
    tree = _seeded_tree(jcfg, cfg, seed=5)
    rng = np.random.default_rng(6)
    labels = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    labels[0, :5] = -100
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32), "labels": labels}
    return jcfg, cfg, tree, batch


def _flat_tree(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_tree(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v, dtype=np.float32)
    return out


@pytest.fixture(scope="module")
def gloo_steps(tmp_path_factory):
    """The worker's losses and gradients, run once on four ranks."""
    tmp = tmp_path_factory.mktemp("gloo_remat")
    inp = {}
    for tag in CASES:
        _, _, tree, batch = _case(tag)
        inp.update({f"{tag}/p/{k}": v for k, v in _flat_tree(tree).items()})
        inp.update({f"{tag}/b/{k}": v for k, v in batch.items()})
    np.savez(tmp / "in.npz", **inp)
    (tmp / "worker.py").write_text(GLOO_WORKER)
    src = pathlib.Path(__file__).resolve().parents[1] / "src"
    run = subprocess.run([sys.executable, str(tmp / "worker.py"), str(tmp / "in.npz"),
                          str(tmp / "out.npz")], capture_output=True, text=True, timeout=600,
                         env={**os.environ, "PYTHONPATH": str(src)})
    assert run.returncode == 0, run.stderr[-4000:]
    return dict(np.load(tmp / "out.npz"))


@pytest.fixture(scope="module")
def jax_steps():
    """Each case's loss and gradients by JAX's ``value_and_grad``, by
    parameter name."""
    out = {}
    for tag in CASES:
        jcfg, cfg, tree, batch = _case(tag)
        names = [n for n, _ in common.spec_leaves(lm.model_specs(cfg))]
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        (loss, _), grads = jax.jit(jax.value_and_grad(
            lambda p: jax_lm.loss_fn(jcfg, p, jb), has_aux=True))(
                jax.tree.map(jnp.asarray, tree))
        out[tag] = (float(loss), dict(zip(names, map(np.asarray, jax.tree.leaves(grads)),
                                          strict=True)))
    return out


def _rel(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("tag", list(CASES))
def test_sharded_checkpoint_matches_plain_and_jax(gloo_steps, jax_steps, tag, mesh, policy):
    """The sharded step's loss and every gradient against the plain step
    at relative L2 1e-5 and against JAX's at the parity contract's bars."""
    key, plain = f"{tag} {mesh} {policy}", f"{tag} plain {policy}"
    loss, plain_loss = float(gloo_steps[key + " loss"]), float(gloo_steps[plain + " loss"])
    jax_loss, jax_grads = jax_steps[tag]
    assert abs(loss - plain_loss) <= REL_L2 * abs(plain_loss), (loss, plain_loss)
    np.testing.assert_allclose(loss, jax_loss, rtol=1e-6)
    bar = SSD_GRAD if tag == "ssm" else GRAD
    for name, want in jax_grads.items():
        got = gloo_steps[f"{key} {name}"]
        assert _rel(got, gloo_steps[f"{plain} {name}"]) <= REL_L2, name
        np.testing.assert_allclose(got, want, **bar, err_msg=name)


def _kept_full_rows(cfg, layers: int, monkeypatch) -> int:
    """How many storages the forward of ``cfg`` cut to ``layers`` makes on
    a ``fake`` (data 1, model 4) mesh of ``meta`` shards that the loss's
    graph still holds and that hold ``[batch, S, d_model]`` (``model`` 4
    splits no channel dim to ``d_model``: Mamba2's inner width is 2 d)."""
    from torch.distributed.tensor.experimental import implicit_replication

    cfg = dataclasses.replace(cfg, num_layers=layers)
    mesh = sharding.abstract_mesh_compat((1, 4), ("data", "model"))
    ctx = sharding.ShardingCtx(mesh=mesh, mode="train")
    b, s = 8, 256
    made = []
    real = cost._CostMode._track

    def track(self, outs, op):
        for t in outs:
            st = t.untyped_storage()
            made.append((weakref.ref(st), st.nbytes() // t.element_size(),
                         t.shape[-1] if t.dim() else 0))
        real(self, outs, op)

    monkeypatch.setattr(cost._CostMode, "_track", track)
    try:
        parts = dryrun.step_parts(cfg, shapes.ShapeSpec("t", "train", s, b), mesh, "train")
        p, _, batch = (dryrun.place_args(a, sh) for a, sh in zip(parts["args"], parts["shards"]))
        flat, unflatten = flatten(p)
        xs = [x.requires_grad_() for x in flat]
        with implicit_replication():
            traced = cost.trace_cost(lambda: lm.loss_fn(cfg, unflatten(xs), batch, ctx)[0])
        rows = b * s * cfg.d_model
        held = [ref for ref, n, width in made
                if ref() is not None and n == rows and width == cfg.d_model]
        assert traced["out"].grad_fn is not None
        return len(held)
    finally:
        sharding.close_fake_world()


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("tag", list(CASES))
def test_no_full_sequence_residual_kept_a_layer(monkeypatch, tag, policy):
    """After the forward, the storages holding the local batch's full
    sequence at width ``d_model`` do not grow with the depth: each region
    keeps its input and its products' outputs split over ``model``."""
    _, cfg, _, _ = _case(tag)
    cfg = dataclasses.replace(cfg, remat=policy)
    two, four = (_kept_full_rows(cfg, n, monkeypatch) for n in (2, 4))
    assert four == two, (two, four)
