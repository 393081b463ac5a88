"""The sharded cross-entropy operator (``parallel.sharding.nll_sum``,
reached from ``models.common.nll_sum`` on DTensor logits) in both of the
CE's layouts: logits split on their vocabulary over ``model``, and split
on their rows where ``model`` does not divide the vocabulary.  On four
``gloo`` ranks (a subprocess; the worker imports no JAX) the mean loss and
its logits gradient equal ``torch.nn.functional.cross_entropy`` on plain
tensors and JAX's ``repro.models.common.cross_entropy`` on the same inputs
(loss rtol 1e-6, gradient rtol 1e-4, f32), and the gradient leaves in the
logits' own placements.  On a ``fake`` (data 2, model 4) mesh of ``meta``
shards the backward issues no collective and allocates no storage beyond
the device's f32 shard of the logits.  Small widths."""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis.cost import trace_cost  # noqa: E402
from repro_torch.models import common  # noqa: E402
from repro_torch.parallel import sharding  # noqa: E402
from repro_torch.parallel.sharding import P, NamedSharding  # noqa: E402

#: (layout, vocabulary, logical axes of the logits [B, C, V]): 64 splits
#: over ``model`` 4 and 2; 51 splits over neither, so the rows do
LAYOUTS = [("vocab", 64, ("batch", None, "vocab")),
           ("rows", 51, ("batch", "attn_q_seq", None))]
B, C = 2, 16
LOSS_RTOL, GRAD_RTOL = 1e-6, 1e-4

#: the worker: for each (data, model) mesh of four ``gloo`` ranks and each
#: layout, seeded logits and labels (a quarter ignored), the mean CE and
#: its logits gradient on DTensors; rank 0 writes inputs and results
GLOO_WORKER = """
import json, socket, sys

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

LAYOUTS, B, C = LAYOUTS_, B_, C_


def worker(rank, port, out_path):
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=4)
    torch.set_num_threads(1)
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.models import common
    from repro_torch.parallel import sharding
    from repro_torch.parallel.sharding import NamedSharding, logical_to_spec

    res = {}
    for shape in ((1, 4), (2, 2)):
        dm = DeviceMesh("cpu", torch.arange(4).reshape(shape), mesh_dim_names=("data", "model"))
        mesh = sharding.make_mesh_compat(shape, ("data", "model"), devices=["cpu"] * 4)

        def place(t, axes):
            sh = NamedSharding(mesh, logical_to_spec(axes, tuple(t.shape), mesh, "train"))
            return distribute_tensor(t, dm, sharding.to_placements(sh))

        for i, (layout, vocab, axes) in enumerate(LAYOUTS):
            rng = np.random.default_rng(11 + i)
            logits = (3 * rng.standard_normal((B, C, vocab))).astype(np.float32)
            labels = rng.integers(0, vocab, (B, C))
            labels[rng.random((B, C)) < 0.25] = -100
            x = place(torch.from_numpy(logits), axes).requires_grad_()
            y = place(torch.from_numpy(labels), axes[:2])
            with implicit_replication():
                loss, n = common.cross_entropy(x, y)
                (grad,) = torch.autograd.grad(loss, x)
            res[f"{shape} {layout}"] = {
                "logits": logits.tolist(), "labels": labels.tolist(),
                "loss": float(loss.full_tensor()), "count": int(n.full_tensor()),
                "grad": grad.full_tensor().tolist(),
                "placements": [str(x.placements), str(grad.placements)]}
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump(res, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    mp.spawn(worker, args=(port, sys.argv[1]), nprocs=4, join=True)
""".replace("LAYOUTS_", repr(LAYOUTS)).replace("B_", repr(B)).replace("C_", repr(C))


@pytest.fixture(scope="module")
def gloo_ce(tmp_path_factory):
    """The worker's results, run once in a subprocess of four ranks."""
    tmp = tmp_path_factory.mktemp("gloo_ce")
    script = tmp / "worker.py"
    script.write_text(GLOO_WORKER)
    src = pathlib.Path(__file__).resolve().parents[1] / "src"
    out = tmp / "out.json"
    run = subprocess.run([sys.executable, str(script), str(out)], capture_output=True,
                         text=True, timeout=300, env={**os.environ, "PYTHONPATH": str(src)})
    assert run.returncode == 0, run.stderr[-4000:]
    return json.loads(out.read_text())


def _plain(logits: np.ndarray, labels: np.ndarray):
    """``F.cross_entropy``'s mean loss and its logits gradient."""
    x = torch.from_numpy(logits).requires_grad_()
    loss = torch.nn.functional.cross_entropy(x.reshape(-1, x.shape[-1]),
                                             torch.from_numpy(labels).reshape(-1),
                                             ignore_index=-100)
    (grad,) = torch.autograd.grad(loss, x)
    return float(loss.detach()), grad.numpy()


def _jax(logits: np.ndarray, labels: np.ndarray):
    """JAX's ``cross_entropy`` and its logits gradient."""
    import jax
    import jax.numpy as jnp

    from repro.models.common import cross_entropy

    loss, grad = jax.value_and_grad(lambda x: cross_entropy(x, jnp.asarray(labels))[0])(
        jnp.asarray(logits))
    return float(loss), np.asarray(grad)


CASES = [f"{shape} {layout}" for shape in ((1, 4), (2, 2)) for layout, _, _ in LAYOUTS]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("ref", ["torch", "jax"])
def test_sharded_ce_on_four_gloo_ranks_matches_plain_and_jax(gloo_ce, case, ref):
    """The split mean loss and logits gradient against ``ref``'s on the
    same inputs; the gradient split as the logits are (on the vocabulary,
    ``Shard(dim=2)``, or the rows, ``Shard(dim=1)``, over ``model``)."""
    row = gloo_ce[case]
    logits = np.asarray(row["logits"], dtype=np.float32)
    labels = np.asarray(row["labels"], dtype=np.int64)
    loss, grad = (_plain if ref == "torch" else _jax)(logits, labels)
    assert row["count"] == int((labels != -100).sum())
    np.testing.assert_allclose(row["loss"], loss, rtol=LOSS_RTOL, atol=0)
    np.testing.assert_allclose(np.asarray(row["grad"], dtype=np.float32), grad,
                               rtol=GRAD_RTOL, atol=0)
    x_pl, g_pl = row["placements"]
    assert x_pl == g_pl, row["placements"]
    assert x_pl.endswith("Shard(dim=2))" if "vocab" in case else "Shard(dim=1))"), x_pl


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])  # tracecheck: disable=TC005 — bf16 LM logits
def test_plain_nll_sum_is_the_plain_ops(dtype):
    """On plain tensors ``nll_sum`` is ``logsumexp`` and ``gather`` as
    before the operator, bit for bit, and the sum is ``F.cross_entropy``'s
    summed form within float32 rounding."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 8, 40)).astype(np.float32)).to(dtype)
    y = torch.from_numpy(rng.integers(0, 40, (2, 8)))
    y[0, :3] = -100
    total, n = common.nll_sum(x, y)
    xf = x.float()
    want = ((torch.logsumexp(xf, -1) - torch.gather(xf, -1, y.clamp(min=0)[..., None])[..., 0])
            * (y != -100)).sum()
    assert torch.equal(total, want) and int(n) == 13
    ref = torch.nn.functional.cross_entropy(xf.reshape(-1, 40), y.reshape(-1),
                                            reduction="sum")
    torch.testing.assert_close(total, ref, rtol=1e-6, atol=0)


MESH = (2, 4)


@pytest.mark.parametrize("layout, vocab, axes", LAYOUTS)
def test_sharded_ce_backward_stays_on_the_shard(layout, vocab, axes):
    """On a ``fake`` (data 2, model 4) mesh of ``meta`` shards, bf16 logits
    ``[8, 64, V]``: the forward's collectives (the vocabulary split's row
    max and its sums) are counted, the backward issues none, its gradient
    keeps the logits' placements and no storage it allocates exceeds the
    device's f32 shard of the logits."""
    vocab *= 5
    mesh = sharding.abstract_mesh_compat(MESH, ("data", "model"))
    spec = sharding.logical_to_spec(axes, (8, 64, vocab), mesh, "train")
    try:
        x = sharding.distribute(torch.empty((8, 64, vocab), dtype=torch.bfloat16,  # tracecheck: disable=TC005 — bf16 LM logits
                                            device="meta"), NamedSharding(mesh, spec))
        y = sharding.distribute(torch.zeros((8, 64), dtype=torch.long, device="meta"),
                                NamedSharding(mesh, P(*spec[:2])))
        x.requires_grad_()
        fwd = trace_cost(lambda: common.nll_sum(x, y)[0])
        bwd = trace_cost(lambda: torch.autograd.grad(fwd["out"], x))
    finally:
        sharding.close_fake_world()
    shard = 8 * 64 * vocab // 8 * 4
    (grad,) = bwd["out"]
    assert grad.placements == x.placements
    assert bwd["collective_counts"] == {}, bwd["collective_counts"]
    assert 0 < bwd["largest_alloc"]["bytes"] <= shard, bwd["largest_alloc"]
    assert fwd["largest_alloc"]["bytes"] <= shard, fwd["largest_alloc"]
    assert fwd["collective_counts"] == ({"all-reduce": 2} if layout == "vocab" else {})
