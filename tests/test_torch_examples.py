"""The port's last three examples (``examples/torch_quickstart.py``,
``torch_multigrid.py``, ``torch_serve_lm.py``; the JAX package's
quickstart, multigrid and serve_lm) at their smallest sizes with
``--device cpu``, in-process, on one torch thread."""
import importlib.util
import os

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _example(name):
    path = os.path.join(REPO, "examples", name)
    spec = importlib.util.spec_from_file_location(name[:-3], path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def test_quickstart_encodings_agree_and_converge():
    out = _example("torch_quickstart.py").main(
        ["--device", "cpu", "--grid", "16", "--iters", "4"])
    assert out["max_err"] <= 1e-5
    assert out["converged"]


def test_multigrid_converges_and_agrees():
    out = _example("torch_multigrid.py").main(["--device", "cpu",
                                               "--grid", "16"])
    assert out["jacobi"].converged and out["multigrid"].converged
    assert out["heterogeneous"].converged
    assert out["agreement"] <= 1e-4
    assert max(out["errors"].values()) <= 1e-5


@pytest.mark.parametrize("arch", ("qwen3-0.6b", "mamba2-370m"))
def test_serve_lm_generates(arch):
    ids = _example("torch_serve_lm.py").main(
        ["--device", "cpu", "--arch", arch, "--batch", "2",
         "--prompt-len", "8", "--tokens", "3"])
    assert ids.shape == (2, 4)
