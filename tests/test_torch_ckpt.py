"""The port's checkpoints and restart loop against the JAX package.

Checkpoints are one file format for both packages: a codec byte, then the
MessagePack of the state tree.  A file written by either package restores
in the other, bfloat16 leaves included, and for the same payload the two
packages write the same bytes.  Training continues from a restored file
as it does in the JAX package.  ``run_with_restarts`` mirrors
``tests/test_runtime_infra.py``.
"""

import dataclasses
import functools
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import ckpt as jax_ckpt  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.data.tokens import DataConfig as JaxDataConfig  # noqa: E402
from repro.data.tokens import TokenPipeline as JaxTokenPipeline  # noqa: E402
from repro.launch import steps as jax_steps  # noqa: E402
from repro.launch.train import reduce_config as jax_reduce_config  # noqa: E402
from repro.optim import adamw as jax_adamw  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch._tree import leaves  # noqa: E402
from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.train import reduce_config  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from test_torch_train import few_threads, np_params  # noqa: E402,F401
from repro_torch.runtime.fault import (  # noqa: E402
    FailureInjector,
    FaultConfig,
    SimulatedFailure,
    _rehydrate,
    run_with_restarts,
)


#: the checkpoint's bf16 leaves (LM weights and moments, not twin math)
BF16 = torch.bfloat16  # tracecheck: disable=TC005 — bf16 LM leaves through the checkpoint
JAX_BF16 = jnp.bfloat16  # tracecheck: disable=TC005 — bf16 LM leaves through the checkpoint


def _t(a):
    return torch.from_numpy(np.array(a))


def _bits(x) -> np.ndarray:
    """The raw bits of a leaf (a torch tensor, a JAX or numpy array)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        x = (x.view(torch.int16) if x.dtype == BF16 else x).numpy()
    return np.asarray(x).reshape(-1).view(np.uint8)


def _same_bits(a, b) -> bool:
    return np.array_equal(_bits(a).ravel(), _bits(b).ravel())


def _configs(dtype):
    kw = dict(dtype=dtype, num_layers=2, remat="none")
    jcfg = dataclasses.replace(jax_reduce_config(jax_get_config("smollm-360m"), 8), **kw)
    cfg = dataclasses.replace(reduce_config(get_config("smollm-360m"), 8), **kw)
    return jcfg.validate(), cfg.validate()


#: bfloat16 moments: the checkpoint holds bf16 leaves while the model trains
#: in float32, where the two packages' losses agree to rtol 1e-4
OPT = adamw.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=8, moment_dtype="bfloat16")
JAX_OPT = jax_adamw.AdamWConfig(**dataclasses.asdict(OPT))


def _jax_state(jcfg, seed=0):
    jp = np_params(jcfg, seed, dtype=jnp.dtype(jcfg.dtype))
    return {"params": jp, "opt": jax_adamw.init_opt_state(jp, JAX_OPT)}


def _port_template(cfg):
    from repro_torch.models.common import init_params
    p = init_params(steps.param_specs_for(cfg), torch.Generator().manual_seed(99),
                    getattr(torch, cfg.dtype), "cpu")
    return {"params": p, "opt": adamw.init_opt_state(p, OPT)}


@functools.cache
def _jax_step(jcfg):
    """The JAX package's jitted train step, compiled once per config."""
    return jax.jit(jax_steps.make_train_step(jcfg, JAX_OPT))


def _jax_steps(jcfg, state, first, n, pipe):
    jstep = _jax_step(jcfg)
    losses = []
    for i in range(first, first + n):
        p, o, m = jstep(state["params"], state["opt"], pipe.global_batch(i))
        state = {"params": p, "opt": o}
        losses.append(float(m["loss"]))
    return state, losses


def _port_steps(cfg, state, first, n, pipe):
    step = steps.make_train_step(cfg, OPT)
    losses = []
    for i in range(first, first + n):
        p, o, m = step(state["params"], state["opt"],
                       {k: _t(v) for k, v in pipe.global_batch(i).items()})
        state = {"params": p, "opt": o}
        losses.append(float(m["loss"]))
    return state, losses


def _assert_same_state(port, jax_state):
    got, want = leaves(port), jax.tree.leaves(jax_state)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert tuple(a.shape) == tuple(np.shape(b))
        assert str(a.dtype).removeprefix("torch.") == str(np.asarray(b).dtype)
        assert _same_bits(a, b)


def test_jax_checkpoint_restores_in_the_port_and_trains_on(tmp_path):
    """Two JAX steps, saved by the JAX package (bf16 moments); the port
    restores every leaf bit for bit onto its own template and two more
    steps give the JAX package's losses at rtol 1e-4."""
    jcfg, cfg = _configs("float32")
    pipe = JaxTokenPipeline(JaxDataConfig(cfg.vocab, 32, 2, seed=1))
    state, _ = _jax_steps(jcfg, _jax_state(jcfg), 0, 2, pipe)
    jax_ckpt.save(str(tmp_path), 2, state)
    step, got = ckpt.restore_as_torch(str(tmp_path), _port_template(cfg))
    assert step == 2 and int(got["opt"].step) == 2
    assert isinstance(got["opt"], adamw.OptState)
    assert got["opt"].mu["embed"].dtype == BF16
    _assert_same_state(got, state)
    _, want = _jax_steps(jcfg, state, 2, 2, pipe)
    _, losses = _port_steps(cfg, got, 2, 2, pipe)
    np.testing.assert_allclose(losses, want, rtol=1e-4)


def test_port_checkpoint_restores_in_jax_and_trains_on(tmp_path):
    """The mirror: two port steps from converted JAX weights, saved by the
    port; the JAX package restores it (``restore_as_jax`` onto its
    template) bit for bit and trains on with the port's losses."""
    jcfg, cfg = _configs("float32")
    pipe = JaxTokenPipeline(JaxDataConfig(cfg.vocab, 32, 2, seed=2))
    js = _jax_state(jcfg, seed=3)
    params = convert.lm_params_from_numpy(jax.tree.map(np.asarray, js["params"]), cfg,
                                          device="cpu")
    state, _ = _port_steps(cfg, {"params": params, "opt": adamw.init_opt_state(params, OPT)},
                           0, 2, pipe)
    ckpt.save(str(tmp_path), 2, state)
    step, host = jax_ckpt.restore(str(tmp_path))
    assert step == 2 and np.asarray(host["opt"][1]["embed"]).dtype.name == "bfloat16"
    _, back = jax_ckpt.restore_as_jax(str(tmp_path), js)
    _assert_same_state(state, back)
    _, want = _port_steps(cfg, state, 2, 2, pipe)
    _, losses = _jax_steps(jcfg, back, 2, 2, pipe)
    np.testing.assert_allclose(losses, want, rtol=1e-4)


def test_both_packages_write_the_same_bytes(tmp_path):
    """bf16 parameters, bf16 moments, the int32 step: the JAX package's
    state and its port carried over with ``convert`` are one payload, and
    the two files are equal byte for byte; each package reads the other's
    file back bit for bit."""
    jcfg, cfg = _configs("bfloat16")
    js = _jax_state(jcfg, seed=4)
    js["opt"] = js["opt"]._replace(
        step=jnp.asarray(7, jnp.int32),
        mu=jax.tree.map(lambda p: (p * 0.5).astype(JAX_BF16), js["params"]))
    tree = jax.tree.map(np.asarray, js)
    params = convert.lm_params_from_numpy(tree["params"], cfg, device="cpu")
    port = {"params": params,
            "opt": convert.opt_state_from_numpy(tree["opt"], params, device="cpu")}
    _assert_same_state(port, js)
    a = jax_ckpt.save(str(tmp_path / "jax"), 7, js)
    b = ckpt.save(str(tmp_path / "port"), 7, port)
    assert open(a, "rb").read() == open(b, "rb").read()
    _, from_jax = ckpt.restore_as_torch(str(tmp_path / "jax"), port)
    _assert_same_state(from_jax, js)
    _, from_port = jax_ckpt.restore_as_jax(str(tmp_path / "port"), js)
    _assert_same_state(port, from_port)


def test_opt_state_from_numpy_takes_the_jax_state():
    jcfg, cfg = _configs("float32")
    js = _jax_state(jcfg)
    tree = jax.tree.map(np.asarray, js)
    params = convert.lm_params_from_numpy(tree["params"], cfg, device="cpu")
    opt = convert.opt_state_from_numpy(tree["opt"], params, device="cpu")
    assert opt.step.dtype == torch.int32 and int(opt.step) == 0
    _assert_same_state(opt, js["opt"])
    with pytest.raises(ValueError, match="layout"):
        convert.opt_state_from_numpy(tree["opt"], {"w": torch.zeros(3)}, device="cpu")


def test_restore_keeps_dtypes_and_casts_to_the_template(tmp_path):
    state = {"b": torch.arange(6, dtype=BF16).reshape(2, 3),
             "a": (np.arange(3, dtype=np.int64), 2.5, "tag"),
             "f": torch.tensor(1.25, dtype=torch.float64)}
    ckpt.save(str(tmp_path), 1, state)
    _, host = ckpt.restore(str(tmp_path))
    assert host["b"].dtype == BF16 and _same_bits(host["b"], state["b"])
    assert host["a"][0].dtype == torch.int64 and host["a"][1:] == [2.5, "tag"]
    like = {"b": torch.zeros(2, 3).requires_grad_(), "a": (np.zeros(3, np.int32), 0.0, ""),
            "f": torch.zeros((), dtype=torch.float32)}
    _, got = ckpt.restore_as_torch(str(tmp_path), like)
    assert got["b"].dtype == torch.float32 and got["b"].requires_grad
    assert got["a"][0].dtype == np.int32 and isinstance(got["a"], tuple)
    assert float(got["f"]) == 1.25 and got["f"].dtype == torch.float32
    with pytest.raises(ValueError, match="template leaf"):
        ckpt.restore_as_torch(str(tmp_path), {**like, "b": torch.zeros(3, 2)})
    with pytest.raises(ValueError, match="leaves"):
        ckpt.restore_as_torch(str(tmp_path), {"b": like["b"]})


def test_checkpoint_gc_keeps_latest(tmp_path):
    for s in range(6):
        ckpt.save(str(tmp_path), s, {"v": np.array([s])}, keep=2)
    assert ckpt.latest_step(str(tmp_path)) == 5
    assert sorted(os.listdir(tmp_path)) == ["ckpt_00000004.mpz", "ckpt_00000005.mpz"]
    step, state = ckpt.restore(str(tmp_path))
    assert step == 5 and int(state["v"][0]) == 5
    assert ckpt.latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "none"))


def test_an_interrupted_write_leaves_the_last_good_checkpoint(tmp_path, monkeypatch):
    """A crash after the blob is written but before it is published (the
    rename) leaves the previous checkpoint the latest, whole."""
    ckpt.save(str(tmp_path), 3, {"v": torch.tensor([3.0])})

    def crash(src, dst):
        raise OSError("node lost before the rename")

    monkeypatch.setattr(ckpt.os, "replace", crash)
    with pytest.raises(OSError, match="rename"):
        ckpt.save(str(tmp_path), 4, {"v": torch.tensor([4.0])})
    monkeypatch.undo()
    assert ckpt.latest_step(str(tmp_path)) == 3
    assert any(f.endswith(".tmp") for f in os.listdir(tmp_path))
    _, state = ckpt.restore(str(tmp_path))
    assert float(state["v"][0]) == 3.0


def test_run_with_restarts_resumes(tmp_path):
    calls = []

    def make_state():
        return {"x": np.zeros((1,), np.float32)}

    def step_fn(state, step):
        calls.append(step)
        return {"x": state["x"] + 1}, float(state["x"][0])

    rep = run_with_restarts(
        total_steps=20,
        make_state=make_state,
        step_fn=step_fn,
        fault_cfg=FaultConfig(ckpt_dir=str(tmp_path), ckpt_every=5),
        injector=FailureInjector(fail_at_steps=(7, 13)),
    )
    assert rep.steps_done == 20
    assert rep.restarts == 2
    assert rep.restored_from == [5, 10]
    # state continuity: steps 5 and 10 re-executed after the crashes;
    # the failing step itself never ran before the crash (check precedes it)
    assert calls.count(5) == 2 and calls.count(10) == 2
    assert calls.count(13) == 1
    assert rep.losses[-1] == 19.0 and rep.checkpoints == 4     # 5, 10, 15, 20


def test_run_with_restarts_gives_up_after_max_restarts(tmp_path):
    with pytest.raises(SimulatedFailure, match="step 2"):
        run_with_restarts(
            total_steps=5, make_state=lambda: {"x": np.zeros(1)},
            step_fn=lambda s, i: (s, 0.0),
            fault_cfg=FaultConfig(ckpt_dir=str(tmp_path), ckpt_every=10, max_restarts=1),
            injector=FailureInjector(fail_at_steps=(1, 2)))


def test_rehydrate_takes_the_templates_dtypes_and_devices():
    template = {"p": torch.zeros(2, dtype=BF16), "n": np.zeros(2, np.float32),
                "opt": adamw.OptState(torch.zeros((), dtype=torch.int32),
                                      {"p": torch.zeros(2)}, {"p": torch.zeros(2)})}
    host = {"p": torch.tensor([1.5, 2.0]), "n": torch.tensor([3.0, 4.0], dtype=torch.float64),
            "opt": [torch.tensor(5, dtype=torch.int64), {"p": torch.ones(2)},
                    {"p": torch.ones(2)}]}
    got = _rehydrate(template, host)
    assert got["p"].dtype == BF16 and got["p"].tolist() == [1.5, 2.0]
    assert got["n"].dtype == np.float32 and isinstance(got["opt"], adamw.OptState)
    assert got["opt"].step.dtype == torch.int32 and int(got["opt"].step) == 5
    with pytest.raises(ValueError, match="structure"):
        _rehydrate(template, {"p": host["p"]})
