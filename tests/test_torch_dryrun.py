"""JAX's 512-device dry-run cell (``tests/test_launch.py``'s
``test_smoke_cell_compiles_multipod[train_4k]``) through the port's
``launch.dryrun.run_cell`` on ``meta``: qwen3-0.6b's smoke config, a train
step of 256 x 4096 tokens on the 2 x 16 x 16 mesh, every shard traced and
counted (about 45 s on one core, so it has this file to itself; the
``decode_32k`` cell is in ``tests/test_torch_launch.py``)."""
import torch

from repro_torch.launch.dryrun import run_cell


def test_smoke_train_cell_on_the_multipod_mesh():
    torch.set_num_threads(1)
    rec = run_cell("qwen3-0.6b", "train_4k", True, "", smoke=True)
    assert rec["status"] == "OK" and rec["n_devices"] == 512
    assert rec["hlo_cost"]["flops"] > 0
    assert rec["memory_analysis"]["temp_size_in_bytes"] > 0
    # the ZeRO-1 train state: every shard holds a slice of the masters
    assert 0 < rec["memory_analysis"]["argument_size_in_bytes"]
    # K7 in each layer's forward and recompute, K8/K9 in its backward:
    # the counted flops exceed the 6·N·D of the useful work
    assert rec["hlo_cost"]["flops"] * 512 > rec["model_flops"]
    coll = rec["hlo_cost"]["collectives"]
    assert coll["all-reduce"]["count"] > 0
