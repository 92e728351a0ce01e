"""JAX's 512-device dry-run cell (``tests/test_launch.py``'s
``test_smoke_cell_compiles_multipod[train_4k]``) through the port's
``launch.dryrun.run_cell`` on ``meta``: qwen3-0.6b's smoke config, a train
step of 256 x 4096 tokens on the 2 x 16 x 16 mesh, its data replicas
collapsed (3 of 32 traced, ``launch.dryrun.count_collapsed``); and the
collapse held against the trace of every shard (``count_step``), key by
key, on the 16 x 16 mesh's smoke train and decode cells (the
``decode_32k`` cell at 512 shards is in ``tests/test_torch_launch.py``)."""
import pytest
import torch

from repro_torch.launch.dryrun import (count_collapsed, count_step,
                                       native_meta_kernels, run_cell)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import make_cell, make_sharder


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def test_smoke_train_cell_on_the_multipod_mesh():
    rec = run_cell("qwen3-0.6b", "train_4k", True, "", smoke=True)
    assert rec["status"] == "OK" and rec["n_devices"] == 512
    assert rec["replicas_counted"] == "collapsed over pod+data"
    assert rec["hlo_cost"]["flops"] > 0
    assert rec["memory_analysis"]["temp_size_in_bytes"] > 0
    # the ZeRO-1 train state: every shard holds a slice of the masters
    assert 0 < rec["memory_analysis"]["argument_size_in_bytes"]
    # K7 in each layer's forward and recompute, K8/K9 in its backward:
    # the counted flops exceed the 6·N·D of the useful work
    assert rec["hlo_cost"]["flops"] * 512 > rec["model_flops"]
    coll = rec["hlo_cost"]["collectives"]
    assert coll["all-reduce"]["count"] > 0


@pytest.mark.parametrize("arch,shape", [("qwen3-0.6b", "train_4k"),
                                        ("glm4-9b", "decode_32k")])
def test_collapsed_count_equals_every_shards_trace(arch, shape):
    """The one- and two-replica traces extrapolated to 16 replicas give
    the trace of all 256 shards: flops, hbm_bytes and every collective's
    count and bytes, exactly."""
    with native_meta_kernels():
        cell = make_cell(arch, shape, smoke=True)
        sharder = make_sharder(cell, make_production_mesh(
            devices=["meta"] * 256))
        full, _ = count_step(cell, sharder)
        cut, _ = count_collapsed(cell, sharder)
    assert cut == full
    assert full["flops"] > 0 and full["collective_bytes_total"] > 0
