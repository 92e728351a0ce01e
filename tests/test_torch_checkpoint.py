"""The port's checkpointing (``checkpoint/checkpoint.py``) and fault-tolerant
runtime (``runtime/ft.py``) against the JAX package's on the CPU: the file
format both ways, keep-N, the async save of a tree changed in place right
after, WeightFields, restores into a train state that must match, restart
equivalence and straggler flagging as ``tests/test_substrate.py`` holds
JAX's, the train CLI killed by ``--fail-at-step`` and restarted, and a JAX
train state continued by the port.

Tolerances: checkpoints, restarts and the CLI bit for bit (a restarted run
repeats the uninterrupted one's arithmetic); the JAX state continued two
steps by the port against JAX's own continuation, fp32: loss and nll 1e-5
relative and grad norm 5e-5 each step, the params after within 1e-3 of the
continuation's update max-abs (a grad within rounding of 0 can flip an
element's AdamW step, so the elements compared are those
``_clear_of_zero`` keeps at both steps).
"""
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpoint import Checkpointer as JaxCheckpointer
from repro.configs import get_config as jax_get_config
from repro.core.stencil import WeightField as JaxWeightField
from repro.data.synthetic import DataConfig as JaxDataConfig
from repro.data.synthetic import token_batch as jax_token_batch
from repro.models.model_zoo import build as jax_build
from repro.optim import adamw as JA
from repro.train.train_step import loss_fn as jax_loss_fn
from repro.train.train_step import make_train_step as jax_make_train_step
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config
from repro_torch.core.stencil import WeightField
from repro_torch.data.synthetic import DataConfig, token_batch
from repro_torch.launch.train import main as train_main
from repro_torch.models.convert import (from_jax_params, from_jax_state,
                                        to_jax_tree)
from repro_torch.models.model_zoo import build
from repro_torch.optim import adamw as TA
from repro_torch.runtime import (FTConfig, InjectedFailure, StepStats,
                                 run_training)
from repro_torch.train.train_step import (init_train_state, make_train_step,
                                          value_and_grad)
from test_torch_lm_families import _clear_of_zero, _f32, _tree_by_path

RNG = np.random.default_rng(26)
ARCH = "qwen3-0.6b"


def _tree():
    return {"a": {"b": torch.arange(5, dtype=torch.float32),
                  "c": torch.from_numpy(RNG.standard_normal((3, 4))
                                        .astype(np.float32))},
            "h": torch.ones(2, 3, dtype=torch.bfloat16) / 3,
            "list": [torch.zeros(2), torch.full((1,), 7.0)],
            "step": torch.tensor(7, dtype=torch.int32)}


def _files(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


# -- the checkpointer ----------------------------------------------------------

def test_roundtrip(tmp_path):
    ck = Checkpointer(str(tmp_path))
    tree = _tree()
    ck.save(7, tree)
    step, back = ck.restore_latest()
    assert step == 7
    np.testing.assert_array_equal(back["a"]["b"], tree["a"]["b"].numpy())
    np.testing.assert_array_equal(back["a"]["c"], tree["a"]["c"].numpy())
    assert back["h"].dtype == np.float32     # bf16 kept exactly, as fp32
    np.testing.assert_array_equal(back["h"], tree["h"].float().numpy())
    np.testing.assert_array_equal(back["list"]["1"], [7.0])
    assert back["step"].dtype == np.int32 and int(back["step"]) == 7
    # On a device: tensors there.
    _, on_dev = ck.restore_latest(device="cpu")
    assert isinstance(on_dev["a"]["c"], torch.Tensor)
    assert torch.equal(on_dev["a"]["c"], tree["a"]["c"])
    assert sorted(os.listdir(tmp_path)) == ["ckpt_00000007.npz",
                                            "manifest.json"]


def test_keep_n(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        ck.save(s, {"x": torch.zeros(1)})
    files = [f for f in os.listdir(tmp_path) if f.endswith(".npz")]
    assert sorted(files) == ["ckpt_00000003.npz", "ckpt_00000004.npz"]
    assert ck.latest_step() == 4


def test_async_save(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, {"x": torch.ones(3)}, blocking=False)
    ck.wait()
    assert ck.latest_step() == 1
    assert [e["op"] for e in ck.events] == ["save"]
    assert ck.events[0]["bytes"] == 12 and "write_s" in ck.events[0]


def test_async_save_holds_the_values_before_an_in_place_update(tmp_path):
    """The port's train state changes in place: ``save`` returns with host
    copies taken, so an update right after it does not reach the file, on
    the CPU where ``Tensor.numpy()`` would be a view."""
    ck = Checkpointer(str(tmp_path))
    big = torch.from_numpy(RNG.standard_normal((512, 1024))
                           .astype(np.float32))
    tree = {"p": big, "m": torch.zeros(512, 1024), "step": torch.tensor(3)}
    want = {k: v.clone() for k, v in tree.items()}
    ck.save(3, tree, blocking=False)
    with torch.no_grad():
        tree["p"].add_(1.0)
        tree["m"].fill_(5.0)
        tree["step"].add_(1)
    ck.wait()
    got = _files(tmp_path / "ckpt_00000003.npz")
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v.numpy())


def test_weight_field_round_trip_bitwise(tmp_path):
    tree = {"spec_fields": WeightField(RNG.random((5, 6))),
            "nested": {"wf": WeightField(RNG.random((3, 3))),
                       "plain": np.arange(4, dtype=np.float32)},
            "scalar": np.float32(2.5)}
    ck = Checkpointer(str(tmp_path))
    ck.save(1, tree)
    assert "spec_fields%wf" in _files(tmp_path / "ckpt_00000001.npz")
    step, back = ck.restore_latest()
    assert step == 1
    for got, want in ((back["spec_fields"], tree["spec_fields"]),
                      (back["nested"]["wf"], tree["nested"]["wf"])):
        assert isinstance(got, WeightField) and got == want
        np.testing.assert_array_equal(got.array, want.array)
    np.testing.assert_array_equal(back["nested"]["plain"],
                                  tree["nested"]["plain"])
    assert float(back["scalar"]) == 2.5


def test_a_file_written_by_jax_restores_in_the_port(tmp_path):
    jtree = {"params": {"w": jnp.asarray(RNG.standard_normal((4, 6)),
                                         jnp.float32),
                        "layers": [jnp.arange(3, dtype=jnp.float32),
                                   jnp.ones((2, 2))]},
             "wf": JaxWeightField(RNG.random((3, 5)).astype(np.float32)),
             "step": jnp.asarray(5, jnp.int32)}
    JaxCheckpointer(str(tmp_path)).save(5, jtree)
    step, back = Checkpointer(str(tmp_path)).restore_latest()
    assert step == 5
    want = {"/".join(map(str, path)): np.asarray(v) for path, v in
            _paths(jax.tree.map(np.asarray, {**jtree, "wf": None}))}
    got = {"/".join(map(str, path)): v for path, v in _paths(
        {**back, "wf": None})}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
        assert got[k].dtype == want[k].dtype, k
    assert isinstance(back["wf"], WeightField)
    np.testing.assert_array_equal(back["wf"].array,
                                  np.asarray(jtree["wf"].values))


def test_a_file_written_by_the_port_restores_in_jax(tmp_path):
    tree = _tree()
    Checkpointer(str(tmp_path)).save(2, {**tree,
                                         "wf": WeightField(np.eye(3))})
    step, back = JaxCheckpointer(str(tmp_path)).restore_latest()
    assert step == 2
    np.testing.assert_array_equal(back["a"]["c"], tree["a"]["c"].numpy())
    assert isinstance(back["wf"], JaxWeightField)
    np.testing.assert_array_equal(np.asarray(back["wf"].values), np.eye(3))


def test_the_same_numpy_tree_gives_the_same_keys_in_both(tmp_path):
    tree = {"params": {"embed": RNG.standard_normal((8, 4)).astype(
                np.float32),
                "layers": {"attn": {"wq": np.ones((2, 4, 4), np.float32)}}},
            "m": [np.zeros(3, np.float32), (np.ones(2, np.float32),)],
            "step": np.int32(4)}
    Checkpointer(str(tmp_path / "t")).save(4, tree)
    JaxCheckpointer(str(tmp_path / "j")).save(4, tree)
    t, j = (_files(tmp_path / d / "ckpt_00000004.npz") for d in "tj")
    assert sorted(t) == sorted(j) == sorted(
        ["params/embed", "params/layers/attn/wq", "m/0", "m/1/0", "step"])
    for k in t:
        np.testing.assert_array_equal(t[k], j[k])
    assert (open(tmp_path / "t" / "manifest.json").read()
            == open(tmp_path / "j" / "manifest.json").read())


@pytest.mark.parametrize("fault", ["extra_key", "missing_key", "shape"])
def test_restore_into_a_tree_that_differs_raises(tmp_path, fault):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, {"a": {"w": torch.zeros(2, 3), "b": torch.zeros(3)},
                "step": torch.tensor(1)})
    into = {"a": {"w": torch.ones(2, 3), "b": torch.ones(3)},
            "step": torch.tensor(0)}
    if fault == "extra_key":
        into["a"]["c"] = torch.ones(1)
        match = "'a/c' of the tree restored into is not in the checkpoint"
    elif fault == "missing_key":
        del into["a"]["b"]
        match = "'a/b' is in the checkpoint but not in the tree"
    else:
        into["a"]["w"] = torch.ones(3, 2)
        match = r"'a/w' has shape \(2, 3\) in the checkpoint and \(3, 2\)"
    with pytest.raises(ValueError, match=match):
        ck.restore(1, into=into)


def test_restore_into_a_train_state_keeps_the_model_sharing_it(tmp_path):
    cfg = get_config(ARCH, smoke=True)
    gen = torch.Generator().manual_seed(1)
    saved = init_train_state(build(cfg, device="cpu", dtype=torch.float32,
                                   generator=gen))
    with torch.no_grad():
        for v in saved["m"].values():
            v.normal_(generator=gen)
    saved["step"] = torch.tensor(3, dtype=torch.int32)
    ck = Checkpointer(str(tmp_path))
    ck.save(3, saved)
    model = build(cfg, device="cpu", dtype=torch.float32,
                  generator=torch.Generator().manual_seed(2))
    state = init_train_state(model)
    ptrs = {n: p.data_ptr() for n, p in model.named_parameters()}
    step, back = ck.restore_latest(into=state)
    assert step == 3 and back is state and int(state["step"]) == 3
    for name, p in model.named_parameters():
        assert p.data_ptr() == ptrs[name] == state["params"][name].data_ptr()
        assert torch.equal(p, saved["params"][name]), name
        assert torch.equal(state["m"][name], saved["m"][name]), name
    assert [e["op"] for e in ck.events] == ["save", "restore"]


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, (*prefix, k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, (*prefix, i))
    elif tree is not None:
        yield prefix, tree


# -- the runtime ---------------------------------------------------------------

def _setup(tmp_path, fail_at=None):
    def train_step(state, batch):
        w = state["w"] - 0.1 * batch
        return {"w": w, "step": state["step"] + 1}, {"loss": torch.sum(w * w)}

    def init():
        return {"w": torch.ones(4), "step": torch.tensor(0)}

    def batch_for(step):
        return torch.full((4,), float(step % 3))

    ft = FTConfig(checkpoint_dir=str(tmp_path), checkpoint_every=3,
                  async_save=False, fail_at_step=fail_at)
    return train_step, init, batch_for, ft


def test_restart_equivalence(tmp_path):
    step, init, batch_for, ft = _setup(tmp_path, fail_at=7)
    with pytest.raises(InjectedFailure, match="step 7"):
        run_training(step, init, batch_for, 10, ft)
    state, stats = run_training(step, init, batch_for, 10,
                                _setup(tmp_path)[3])
    assert [s.step for s in stats] == [6, 7, 8, 9]   # resumed from 6
    ref_state, ref_stats = run_training(step, init, batch_for, 10,
                                        _setup(str(tmp_path) + "_ref")[3])
    assert torch.equal(state["w"], ref_state["w"])
    assert int(state["step"]) == int(ref_state["step"]) == 10
    assert stats[-1].metrics == ref_stats[-1].metrics
    assert isinstance(stats[0], StepStats)


def test_straggler_flagging(tmp_path):
    calls = {"n": 0}

    def train_step(state, batch):
        calls["n"] += 1
        if calls["n"] == 8:
            time.sleep(0.25)
        return state, {"loss": torch.zeros(())}

    ft = FTConfig(checkpoint_dir=str(tmp_path), checkpoint_every=100,
                  async_save=False, straggler_factor=3.0)
    _, stats = run_training(train_step, lambda: {"w": torch.zeros(1)},
                            lambda s: torch.zeros(1), 10, ft)
    assert stats[7].step == 7 and stats[7].is_straggler


def test_without_a_checkpoint_dir_nothing_is_written(tmp_path):
    step, init, batch_for, _ = _setup(tmp_path)
    state, stats = run_training(step, init, batch_for, 4,
                                FTConfig(checkpoint_dir=None))
    assert len(stats) == 4 and int(state["step"]) == 4
    assert os.listdir(tmp_path) == []


# -- the train CLI ----------------------------------------------------------------

def _cli(tmp_path, sub, *extra):
    return train_main(["--arch", ARCH, "--smoke", "--device", "cpu",
                       "--steps", "6", "--global-batch", "2",
                       "--seq-len", "16", "--checkpoint-every", "3",
                       "--checkpoint-dir", str(tmp_path / sub), *extra])


def _final_loss(out):
    return [ln for ln in out.splitlines() if ln.startswith("final loss ")]


def test_cli_killed_and_restarted_ends_on_the_uninterrupted_run(tmp_path,
                                                                capsys):
    with pytest.raises(InjectedFailure, match="step 4"):
        _cli(tmp_path, "a", "--fail-at-step", "4")
    killed = capsys.readouterr().out
    assert "step     4 loss=" in killed and "step     5" not in killed
    assert sorted(os.listdir(tmp_path / "a")) == ["ckpt_00000003.npz",
                                                  "manifest.json"]
    assert _cli(tmp_path, "a") == 0
    restarted = capsys.readouterr().out
    assert "resumed from step 3" in restarted
    assert "checkpoint restore step 3" in restarted
    assert "step     4 loss=" in restarted and "step     3" not in restarted
    assert _cli(tmp_path, "b") == 0
    whole = capsys.readouterr().out
    assert "resumed" not in whole and "step     1 loss=" in whole
    assert _final_loss(restarted) == _final_loss(whole) != []
    a, b = (_files(tmp_path / d / "ckpt_00000006.npz") for d in "ab")
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    # A run that finds its last step checkpointed trains no more.
    assert _cli(tmp_path, "b") == 0
    assert "resumed from step 6" in capsys.readouterr().out


# -- a JAX train state continued by the port --------------------------------------

def test_a_jax_train_state_continues_in_the_port(tmp_path):
    """Two fp32 JAX steps of qwen3-0.6b's smoke config, saved by JAX's
    Checkpointer; the port restores the file, carries it into its train
    state (``convert.from_jax_state``) and takes two more steps, held
    against JAX's own continuation from the same state."""
    jcfg = jax_get_config(ARCH, smoke=True)
    cfg = get_config(ARCH, smoke=True)
    api = jax_build(jcfg)
    opt = dict(total_steps=10, warmup_steps=2)
    jstep = jax.jit(jax_make_train_step(api, None, JA.AdamWConfig(**opt),
                                        compute_dtype=jnp.float32))
    jgrad = jax.jit(jax.value_and_grad(
        lambda p, b: jax_loss_fn(api, p, b, None, jnp.float32),
        has_aux=True))
    B, S = 2, 24
    data = (cfg.vocab_size, S, B)
    jstate = JA.init_state(api.init(jax.random.PRNGKey(0), jnp.float32))
    for i in range(2):
        jstate, _ = jstep(jstate, jax_token_batch(JaxDataConfig(*data), i))
    JaxCheckpointer(str(tmp_path)).save(2, jstate)
    step, tree = Checkpointer(str(tmp_path)).restore_latest()
    assert step == 2 and int(tree["step"]) == 2
    model = from_jax_params(cfg, tree["params"], device="cpu",
                            dtype=torch.float32)
    tstate = from_jax_state(model, tree)
    p2 = jax.tree.map(np.asarray, jstate["params"])
    tstep = make_train_step(model, TA.AdamWConfig(**opt), torch.float32)
    keep = None
    for i in range(2, 4):
        jb = jax_token_batch(JaxDataConfig(*data), i)
        tb = token_batch(DataConfig(*data), i, device="cpu")
        _, jg = jgrad(jstate["params"], jb)
        _, _, tg = value_and_grad(model, tstate["params"], tb)
        big = jax.tree.map(_clear_of_zero, jg, to_jax_tree(cfg, tg))
        keep = big if keep is None else jax.tree.map(np.logical_and, keep,
                                                     big)
        jstate, jm = jstep(jstate, jb)
        tstate, tm = tstep(tstate, tb)
        assert int(tstate["step"]) == i + 1
        assert float(tm["lr"]) == float(jm["lr"])
        for key, tol in (("loss", 1e-5), ("nll", 1e-5), ("grad_norm", 5e-5)):
            assert abs(float(tm[key]) / float(jm[key]) - 1) <= tol, (i, key)
    ours = _tree_by_path(to_jax_tree(cfg, tstate["params"]))
    starts, masks = _tree_by_path(p2), _tree_by_path(keep)
    compared = 0
    for path, a in _tree_by_path(jstate["params"]).items():
        want, got = _f32(a) - starts[path], ours[path] - starts[path]
        mask = masks[path]
        if mask.any():
            compared += int(mask.sum())
            err = np.abs(got - want)[mask].max() / np.abs(want).max()
            assert err <= 1e-3, (path, err)
    assert compared >= 0.1 * sum(np.size(p) for p in starts.values())


# -- the examples ------------------------------------------------------------------

def _example(name):
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "examples", name)
    spec = importlib.util.spec_from_file_location(name[:-3], path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_train_lm_example_on_the_cpu_resumes(tmp_path, capsys):
    ex = _example("torch_train_lm.py")
    argv = ["--device", "cpu", "--steps", "4", "--global-batch", "2",
            "--seq-len", "16", "--checkpoint-dir", str(tmp_path)]
    assert ex.main(argv) == 0
    first = capsys.readouterr().out
    assert "final loss " in first and "checkpoint save step 4" in first
    assert ex.main([*argv[:2], "--steps", "6", *argv[4:]]) == 0
    assert "resumed from step 4" in capsys.readouterr().out


def test_learned_stencil_example_round_trip_on_the_cpu(capsys):
    """JAX's CI run of its example (--smoke --steps 80 --assert-decreasing):
    the checkpoint round trip gives the identical next-step loss, and the
    loss falls 10x."""
    ex = _example("torch_learned_stencil.py")
    assert ex.main(["--smoke", "--device", "cpu", "--steps", "80",
                    "--assert-decreasing"]) == 0
    out = capsys.readouterr().out
    assert "step   40  checkpoint round-trip OK (loss identical" in out
    assert "x down from" in out
