"""Input stand-ins and shardings for every (arch x shape) cell — the port of
the JAX package's ``launch/specs.py``.

Nothing here allocates: a JAX ``ShapeDtypeStruct`` is an empty ``meta``
tensor of its shape and type, the parameter and optimiser trees come from
the declarative tables (``param_table``) in JAX's layout (layer lists
stacked), and a ``NamedSharding`` is the port's ``PartitionSpec`` from
``Sharder.spec`` (``opt_spec``, ZeRO-1, for the train state's params, m
and v).  The cell's model is built on ``meta`` by default: shapes, no
storage, nothing drawn.

The step functions are the port's (``make_train_step``,
``make_prefill_step``, ``make_decode_step`` with ``kv_len = seq - 1``),
with the attention the port serves and trains with: ``attn_impl="flash"``
(K7 forward, K8/K9 backward; on ``meta`` their cost only).  They take
their arguments in the port's layout (the train state by parameter name, a
sharded decode's cache as ``Sharded`` pieces): ``step_args`` builds those.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig, get_config
from repro_torch.models import layers
from repro_torch.models.model_zoo import build
from repro_torch.models.transformer import StackedModel
from repro_torch.parallel.sharding import (PartitionSpec, Sharder,
                                           tree_specs)

# The assigned LM shape set (seq_len, global_batch, kind).
SHAPES: dict[str, dict] = {
    "train_4k": {"kind": "train", "seq": 4096, "batch": 256},
    "prefill_32k": {"kind": "prefill", "seq": 32768, "batch": 32},
    "decode_32k": {"kind": "decode", "seq": 32768, "batch": 128},
    "long_500k": {"kind": "decode", "seq": 524288, "batch": 1},
}

# long_500k needs a sub-quadratic path: run only for SSM/hybrid archs
# (attention-free state or periodic attention); skip for pure full-attention
# archs per the assignment (recorded as SKIP rows in the roofline table).
LONG_CONTEXT_FAMILIES = ("ssm", "hybrid")


def cell_is_applicable(cfg: ModelConfig, shape_name: str) -> tuple[bool, str]:
    if shape_name == "long_500k" and cfg.family not in LONG_CONTEXT_FAMILIES:
        return False, (
            f"{cfg.family} is full-attention; 500k-token decode has no "
            "sub-quadratic path (DESIGN §4)"
        )
    return True, ""


@dataclasses.dataclass(frozen=True)
class Cell:
    """JAX's ``Cell``; ``model`` (the port's ``ModelApi``) holds the
    masters (fp32) of a train cell and the served weights (``dtype``) of
    the others."""

    arch: str
    shape_name: str
    cfg: ModelConfig
    model: StackedModel
    kind: str
    seq: int
    batch: int


def make_cell(arch: str, shape_name: str, smoke: bool = False, *,
              device="meta", dtype: torch.dtype = torch.bfloat16) -> Cell:
    cfg = dataclasses.replace(get_config(arch, smoke=smoke),
                              attn_impl="flash")
    sh = SHAPES[shape_name]
    model_dtype = torch.float32 if sh["kind"] == "train" else dtype
    return Cell(arch=arch, shape_name=shape_name, cfg=cfg,
                model=build(cfg, device=device, dtype=model_dtype),
                kind=sh["kind"], seq=sh["seq"], batch=sh["batch"])


def make_sharder(cell: Cell, mesh) -> Sharder:
    data_ways = mesh.shape["data"] * (mesh.shape["pod"]
                                      if "pod" in mesh.axis_names else 1)
    return Sharder(
        mesh=mesh,
        profile=cell.cfg.sharding_profile,
        state_over_data=cell.batch < data_ways,
    )


def _struct(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _batch_specs(cell: Cell, dtype=torch.bfloat16) -> dict:
    cfg, B, S = cell.cfg, cell.batch, cell.seq
    batch: dict = {
        "tokens": (_struct((B, S), torch.int32), ("batch", "seq")),
    }
    if cell.kind == "train":
        batch["labels"] = (_struct((B, S), torch.int32), ("batch", "seq"))
    if cfg.family == "encdec":
        batch["enc_frames"] = (
            _struct((B, cfg.enc_len, cfg.d_model), dtype),
            ("batch", "enc_seq", "embed"),
        )
    if cfg.family == "vlm":
        batch["vision_embeds"] = (
            _struct((B, cfg.n_vision_tokens, cfg.d_model), dtype),
            ("batch", "patches", "embed"),
        )
        batch["positions"] = (
            _struct((3, B, S), torch.int32), (None, "batch", "seq"),
        )
    return batch


def split_specs(tagged) -> tuple[dict, dict]:
    """Split {name: (struct, dims)} into (structs, dims)."""
    structs = {k: v[0] for k, v in tagged.items()}
    dims = {k: v[1] for k, v in tagged.items()}
    return structs, dims


def param_shapes(model: StackedModel, dtype: torch.dtype) -> dict:
    """The parameters' meta stand-ins in JAX's layout (JAX's
    ``api.shapes(dtype)``; a leaf that pins its type keeps it)."""
    return layers.param_shapes(model.param_table(model.cfg), dtype)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def cache_shapes(model: StackedModel, batch: int, seq: int) -> dict:
    """The decode cache's meta stand-ins in the model's type, the SSD
    state fp32 (JAX's ``api.cache_shapes``)."""
    return _map(lambda sd: _struct(*sd), model.cache_shapes(batch, seq))


def input_specs(cell: Cell, dtype=torch.bfloat16):
    """Returns (args_structs, args_dims) trees for the cell's step fn, in
    JAX's layout.

    train  : (state, batch)
    prefill: (params, batch)
    decode : (params, token, cache)
    """
    model = cell.model
    if cell.kind == "train":
        from repro_torch.train.train_step import state_dims, state_shapes
        batch_structs, batch_dims = split_specs(_batch_specs(cell, dtype))
        return ((state_shapes(model), batch_structs),
                (state_dims(model), batch_dims))

    params_structs = param_shapes(model, dtype)
    params_dims = model.dims()

    if cell.kind == "prefill":
        batch_structs, batch_dims = split_specs(_batch_specs(cell, dtype))
        return ((params_structs, batch_structs), (params_dims, batch_dims))

    # decode: one token against a cache of size seq (filled to seq-1)
    token = _struct((cell.batch,), torch.int32)
    cache_structs = cache_shapes(model, cell.batch, cell.seq)
    cache_dims = model.cache_dims()
    return ((params_structs, token, cache_structs),
            (params_dims, ("batch",), cache_dims))


def _shapes(tree):
    return _map(lambda t: tuple(t.shape), tree)


def input_shardings(cell: Cell, sharder: Sharder, structs, dims):
    """``PartitionSpec``s for the cell's step args (JAX's
    ``NamedSharding``s, by the same rules).

    Train-state tensors (fp32 master params, AdamW m/v) get the ZeRO-1 spec
    (additionally sharded over the data axes); everything else follows the
    logical-dims rules.
    """
    if cell.kind != "train":
        return tuple(struct_specs(sharder, d, s)
                     for d, s in zip(dims, structs))
    (state, batch), (state_dims, batch_dims) = structs, dims
    zero1 = {k: tree_specs(sharder, state_dims[k], _shapes(state[k]),
                           opt=True) for k in ("params", "m", "v")}
    zero1["step"] = PartitionSpec()
    return (zero1, struct_specs(sharder, batch_dims, batch))


def struct_specs(sharder: Sharder, dims, structs):
    """The ``PartitionSpec`` of each stand-in of a tree, by its dims."""
    if isinstance(structs, torch.Tensor):
        return sharder.spec(tuple(dims), tuple(structs.shape))
    return {k: struct_specs(sharder, dims[k], structs[k]) for k in structs}


def make_step_fn(cell: Cell, sharder: Sharder | None):
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.serve_step import (make_decode_step,
                                              make_prefill_step)
    from repro_torch.train.train_step import make_train_step

    if cell.kind == "train":
        return make_train_step(cell.model, AdamWConfig(), sharder=sharder)
    if cell.kind == "prefill":
        return make_prefill_step(cell.model, cell.seq, sharder=sharder)
    return make_decode_step(cell.model, cell.seq - 1, sharder=sharder)


def step_args(cell: Cell, sharder: Sharder | None, dtype=torch.bfloat16,
              fill=None) -> tuple:
    """The step function's arguments in the port's layout, on the model's
    device: train (the state by parameter name, the batch); prefill (the
    batch,); decode (the token, the cache: the family's ``Sharded`` pieces
    under a sharder of more than one shard, else the model's tree).
    ``fill``: None leaves the tensors empty (``meta``: no storage), else
    ``fill(tensor)`` writes each (a seeded draw on a real device)."""
    from repro_torch.train.train_step import init_train_state

    model = cell.model
    dev = model.device

    def made(t: torch.Tensor) -> torch.Tensor:
        out = torch.empty(t.shape, dtype=t.dtype, device=dev)
        if fill is not None:
            fill(out)
        return out

    if cell.kind == "decode":
        token = made(_struct((cell.batch,), torch.int32))
        run = model.sharded(sharder)
        cache = (run._cache(cell.batch, cell.seq) if run is not None
                 else model.init_cache(cell.batch, cell.seq))
        return token, cache
    batch = {k: made(v[0]) for k, v in _batch_specs(cell, dtype).items()}
    if cell.kind == "prefill":
        return (batch,)
    return init_train_state(model), batch
