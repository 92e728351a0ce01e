"""The PyTorch port stands alone: no JAX and nothing of the JAX package at
run time, and no quiet fallback to the CPU when the card is missing."""
import ast
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.core import laplace_jacobi, solve

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "src", "repro_torch")


def _imported_modules(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_jax_or_repro_import_anywhere_in_the_port():
    files = [os.path.join(d, f) for d, _, fs in os.walk(PKG) for f in fs
             if f.endswith((".py", ".cu"))]
    assert len(files) >= 40, files
    for module in ("kernels/stencil3d.py", "kernels/dense_stencil.py",
                   "kernels/flash_attention.py",
                   "kernels/flash_attention_bwd.py", "configs/base.py",
                   "configs/qwen3_0_6b.py", "models/layers.py",
                   "models/attention.py", "models/mlp.py",
                   "models/transformer.py", "models/model_zoo.py",
                   "models/convert.py", "train/serve_step.py",
                   "launch/serve.py", "train/loss.py", "train/train_step.py",
                   "optim/adamw.py", "data/synthetic.py", "launch/train.py",
                   "csrc/flash_attention_bwd.cu", "core/autotune.py",
                   "core/multigrid.py", "core/plan_cache.py",
                   "serve/__init__.py", "serve/engine.py",
                   "core/adjoint.py", "models/solver_layer.py",
                   "configs/learned_stencil.py", "configs/jacobi.py",
                   "core/conv1d.py", "models/ssm.py",
                   "configs/mamba2_370m.py", "configs/zamba2_1_2b.py",
                   "models/moe.py", "configs/qwen3_moe_30b_a3b.py",
                   "configs/moonshot_v1_16b_a3b.py", "models/encdec.py",
                   "configs/qwen2_vl_2b.py", "configs/whisper_tiny.py",
                   "configs/nemotron_4_15b.py", "configs/glm4_9b.py",
                   "configs/phi3_medium_14b.py", "checkpoint/__init__.py",
                   "checkpoint/checkpoint.py", "runtime/__init__.py",
                   "runtime/ft.py", "parallel/__init__.py",
                   "parallel/halo.py", "core/distributed.py",
                   "parallel/sharding.py", "parallel/pipeline.py",
                   "launch/mesh.py", "launch/specs.py", "launch/hlo_cost.py",
                   "launch/dryrun.py", "launch/dryrun_pp.py",
                   "launch/sweep.py"):
        assert os.path.join(PKG, *module.split("/")) in files, module
    bad = []
    for path in (f for f in files if f.endswith(".py")):
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib", "repro"):
                bad.append((os.path.relpath(path, REPO), mod))
    assert not bad, bad


def test_port_imports_and_solves_with_jax_blocked():
    code = textwrap.dedent(f"""
        import sys
        sys.modules["jax"] = None       # any import of jax now fails
        sys.modules["repro"] = None
        sys.path.insert(0, {os.path.join(REPO, 'src')!r})
        import numpy as np
        import repro_torch.core, repro_torch.kernels
        import repro_torch.kernels.dense_stencil
        import repro_torch.kernels.stencil3d
        from repro_torch.core import laplace_jacobi, solve
        r = solve(laplace_jacobi(2), np.zeros((16, 16), np.float32),
                  backend="cuda_fused", bc=1.0, rtol=1e-4, check_every=8,
                  max_iters=2000, device="cpu")
        r3 = solve(laplace_jacobi(3), np.zeros((4, 8, 8), np.float32),
                   backend="cuda", bc=1.0, rtol=1e-4, check_every=8,
                   max_iters=2000, device="cpu")
        assert r3.converged
        import asyncio
        from repro_torch.core import Multigrid, PlanCache, autotune
        from repro_torch.serve import ServingEngine
        mg = Multigrid(laplace_jacobi(2), (17, 17), bc=1.0, device="cpu")
        assert mg.solve(np.zeros((17, 17), np.float32)).converged
        table = {os.path.join(REPO, "TUNED_stencil_cuda.json")!r}
        assert autotune.check_table_file(table) == []

        async def serve_two():
            async with ServingEngine(PlanCache(device="cpu")) as eng:
                return await asyncio.gather(*(eng.submit(
                    laplace_jacobi(2), np.zeros((12, 12), np.float32),
                    bc=1.0, rtol=1e-4) for _ in range(2)))
        assert all(r.converged for r in asyncio.run(serve_two()))
        import torch
        from repro_torch.kernels import dense_jacobi_kernel
        dense_jacobi_kernel(torch.zeros(2, 4, 4), torch.eye(16),
                            iterations=2)
        import repro_torch.launch.serve
        import repro_torch.models.convert
        from repro_torch.configs import get_config
        from repro_torch.models.model_zoo import build
        from repro_torch.train.serve_step import greedy_generate
        model = build(get_config("qwen3-0.6b", smoke=True), device="cpu",
                      dtype=torch.float32)
        prompts = torch.zeros(2, 8, dtype=torch.long)
        toks = greedy_generate(model, dict(tokens=prompts), steps=3,
                               max_len=12)
        assert toks.shape == (2, 3)
        from repro_torch.launch.train import train
        tr = train(get_config("qwen3-0.6b", smoke=True), steps=1,
                   global_batch=2, seq_len=8, device="cpu")
        assert tr["steps"][0]["loss"] > 0
        for arch in ("mamba2-370m", "zamba2-1.2b"):
            lm = build(get_config(arch, smoke=True), device="cpu",
                       dtype=torch.float32)
            assert greedy_generate(lm, dict(tokens=prompts), steps=2,
                                   max_len=11).shape == (2, 2)
            tr = train(get_config(arch, smoke=True), steps=1,
                       global_batch=2, seq_len=8, device="cpu")
            assert tr["steps"][0]["loss"] > 0
        from repro_torch.launch.serve import serve
        for arch in ("qwen2-vl-2b", "whisper-tiny"):
            served = serve(get_config(arch, smoke=True), batch=2,
                           prompt_len=8, tokens=2, device="cpu",
                           dtype=torch.float32)
            assert served["generated"].shape == (2, 3)
            tr = train(get_config(arch, smoke=True), steps=1,
                       global_batch=2, seq_len=8, device="cpu")
            assert tr["steps"][0]["loss"] > 0
        import os, tempfile
        from repro_torch.checkpoint import Checkpointer
        from repro_torch.runtime import InjectedFailure
        with tempfile.TemporaryDirectory() as ckdir:
            for arch in ("nemotron-4-15b", "glm4-9b", "phi3-medium-14b"):
                try:
                    train(get_config(arch, smoke=True), steps=2,
                          global_batch=2, seq_len=8, device="cpu",
                          checkpoint_dir=os.path.join(ckdir, arch),
                          checkpoint_every=1, fail_at_step=1)
                except InjectedFailure:
                    pass
                tr = train(get_config(arch, smoke=True), steps=2,
                           global_batch=2, seq_len=8, device="cpu",
                           checkpoint_dir=os.path.join(ckdir, arch))
                assert tr["start_step"] == 1 and len(tr["steps"]) == 1
                assert Checkpointer(os.path.join(ckdir, arch)
                                    ).latest_step() == 2
        from repro_torch.core import (implicit_solve, set_default_plan_cache,
                                      heterogeneous_jacobi)
        set_default_plan_cache(PlanCache(device="cpu"))
        spec = heterogeneous_jacobi(np.ones((8, 8)))
        f = torch.tensor(spec.field_stack(), requires_grad=True)
        x = implicit_solve(spec, torch.zeros(8, 8), fields=f,
                           source=torch.ones(8, 8), rtol=1e-5)
        (gf,) = torch.autograd.grad(x.sum(), f)
        assert gf.shape == f.shape
        from repro_torch.optim.adamw import AdamWConfig
        from repro_torch.train.train_step import (init_train_state,
                                                  make_train_step)
        layer = build(get_config("learned-stencil", smoke=True),
                      device="cpu")
        step = make_train_step(layer, AdamWConfig(lr=1e-2))
        batch = dict(source=torch.ones(2, 12, 14),
                     target=torch.zeros(2, 12, 14))
        _, met = step(init_train_state(layer), batch)
        assert float(met["loss"]) > 0
        assert "jax" not in [m.split(".")[0] for m in sys.modules
                             if sys.modules[m] is not None]
        print(r.converged, r.iterations)
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    converged, iters = out.stdout.split()
    assert converged == "True" and int(iters) > 0


LM_DISTRIBUTION = ("repro_torch.parallel.sharding",
                   "repro_torch.parallel.pipeline", "repro_torch.launch.mesh")


def test_lm_distribution_modules_import_no_process_group():
    """One process drives every shard: the sharder, the pipeline and the
    meshes import neither the JAX package nor ``torch.distributed``, in
    their source or at run time."""
    for mod in LM_DISTRIBUTION:
        path = os.path.join(REPO, "src", *mod.split(".")) + ".py"
        for name in _imported_modules(path):
            assert name.split(".")[0] not in ("jax", "jaxlib", "repro"), (
                mod, name)
            assert not name.startswith("torch.distributed"), (mod, name)
    code = textwrap.dedent(f"""
        import sys
        sys.modules["jax"] = None
        sys.modules["repro"] = None
        sys.path.insert(0, {os.path.join(REPO, 'src')!r})
        import torch
        before = set(m for m in sys.modules if m.startswith(
            "torch.distributed"))
        import {", ".join(LM_DISTRIBUTION)}
        from repro_torch.launch.mesh import make_host_mesh
        from repro_torch.parallel.sharding import Sharder, shard, gather
        mesh = make_host_mesh(4, devices=["cpu"] * 8)
        x = torch.arange(32.0).reshape(8, 4)
        spec = Sharder(mesh).spec(("vocab", "embed"), (8, 4))
        assert torch.equal(gather(shard(x, spec, mesh), spec, mesh), x)
        loaded = sorted(m for m in sys.modules if sys.modules[m] is not None
                        and (m.split(".")[0] in ("jax", "jaxlib", "repro")
                             or m.startswith("torch.distributed")
                             and m not in before))
        print(loaded)
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    assert out.stdout.strip() == "[]", out.stdout


def test_adjoint_and_solver_layer_load_no_jax():
    code = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {os.path.join(REPO, 'src')!r})
        import repro_torch.core.adjoint, repro_torch.models.solver_layer
        loaded = sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "jaxlib", "repro"))
        print(loaded)
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    assert out.stdout.strip() == "[]", out.stdout


def test_default_device_is_the_card_and_never_falls_back():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device exists: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        solve(laplace_jacobi(2), np.zeros((8, 8), np.float32), bc=1.0)
    # The differentiable solve's default cache is the card's too.
    from repro_torch.core import implicit_solve, set_default_plan_cache
    old = set_default_plan_cache(None)
    try:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            implicit_solve(laplace_jacobi(2), np.zeros((8, 8), np.float32))
    finally:
        set_default_plan_cache(old)
