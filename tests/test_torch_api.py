"""The port covers the JAX package's public API: one case per module of
``src/repro``.

Each case reads the JAX module's source with ``ast`` (JAX is never
imported here) and takes its public surface: every top-level function,
class and assigned name (and every name of ``__all__``), every public
method, property and field of its classes, and every parameter name of
each function and method (``__init__`` and ``__call__`` included).  The
port's module of the same path must hold each of them, found by
``hasattr`` and ``inspect.signature`` so that aliases count.

Where the port keeps a name elsewhere, ``COUNTERPART`` names the place;
where a name or parameter is TPU- or JAX-only, ``ALLOWED`` gives the
reason.  An entry of either map that no longer matches a gap (the JAX
name is gone, or the port now has it where JAX does) fails the test, so
the maps cannot rot.

Keys: ``"path:Qual.name"`` a name of the module at ``path`` (relative to
the package root), ``"path:Qual(param)"`` one parameter of it, and
``"(param)"`` a parameter wherever the JAX package has it.  A
``COUNTERPART`` target is ``"path:Qual.name"`` in the port, or
``"path:Qual(param)"`` where JAX's field is the port's constructor
argument (an attribute of the instance, not of the class).
"""
import ast
import dataclasses
import importlib
import inspect
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_ROOT = os.path.join(REPO, "src", "repro")

# JAX's functional model API is the port's modules: parameters live in the
# nn.Module, and JAX's free functions of (cfg, params, ...) are methods.
COUNTERPART: dict[str, str] = {
    "core/plan.py:DeviceProfile.pallas_native":
        "core/plan.py:DeviceProfile.kernels_native",
    "launch/specs.py:Cell.api": "launch/specs.py:Cell.model",
    "models/encdec.py:encode": "models/encdec.py:EncDec.encode",
    "models/encdec.py:decode_train": "models/encdec.py:EncDec.decode_train",
    "models/encdec.py:encdec_cache_shapes":
        "models/encdec.py:EncDec.cache_shapes",
    "models/encdec.py:encdec_cache_dims": "models/encdec.py:EncDec.cache_dims",
    "models/encdec.py:encdec_prefill": "models/encdec.py:EncDec.prefill",
    "models/encdec.py:encdec_decode_step":
        "models/encdec.py:EncDec.decode_step",
    "models/model_zoo.py:ModelApi": "models/transformer.py:Transformer",
    "models/model_zoo.py:ModelApi.cfg":
        "models/transformer.py:Transformer.__init__(cfg)",
    "models/model_zoo.py:ModelApi.table":
        "models/transformer.py:Transformer.param_table",
    "models/model_zoo.py:ModelApi.init":
        "models/transformer.py:Transformer.init_weights",
    "models/model_zoo.py:ModelApi.shapes": "launch/specs.py:param_shapes",
    "models/solver_layer.py:solver_forward":
        "models/solver_layer.py:SolverLayer.forward",
    "models/solver_layer.py:build_solver_api":
        "models/solver_layer.py:SolverLayer",
    "models/transformer.py:init_model": "models/model_zoo.py:build",
    "models/transformer.py:model_dims":
        "models/transformer.py:StackedModel.dims",
    "models/transformer.py:model_shapes": "launch/specs.py:param_shapes",
    "models/transformer.py:attn_apply":
        "models/transformer.py:Attention.forward",
    "models/transformer.py:attn_decode_apply":
        "models/transformer.py:Attention.decode",
    "models/transformer.py:dense_block":
        "models/transformer.py:DenseBlock.forward",
    "models/transformer.py:mamba_block":
        "models/transformer.py:MambaBlock.forward",
    "models/transformer.py:forward": "models/transformer.py:Transformer.forward",
    "models/transformer.py:logits_from_hidden":
        "models/transformer.py:StackedModel.logits",
    "models/transformer.py:cache_shapes":
        "models/transformer.py:Transformer.cache_shapes",
    "models/transformer.py:cache_dims":
        "models/transformer.py:Transformer.cache_dims",
    "models/transformer.py:init_cache":
        "models/transformer.py:StackedModel.init_cache",
    "models/transformer.py:prefill": "models/transformer.py:Transformer.prefill",
    "models/transformer.py:decode_step":
        "models/transformer.py:Transformer.decode_step",
    "parallel/sharding.py:tree_shardings": "parallel/sharding.py:tree_specs",
    "train/train_step.py:cast_tree": "train/train_step.py:load_params",
}

MODULE_SHARDS = ("a block's sharded run is its model's shard program "
                 "(model.sharded(sharder)), not a sharder passed down")
MODEL_DTYPE = "the cache takes the model's type (Transformer(cfg, dtype=))"
NAMED_SHARDING = ("a jax.sharding.NamedSharding; the port places shards "
                  "itself and describes them by PartitionSpec")
HLO_TEXT = ("parses XLA's HLO text; the port counts a traced run "
            "(launch/hlo_cost.analyze(fn, *args))")

ALLOWED: dict[str, str] = {
    # parameters, wherever the JAX package has them
    "(interpret)": "Pallas's interpret mode; a CUDA kernel has none (on "
                   "the CPU a wrapper runs its plain version)",
    "(device_kind)": "JAX's device-profile key; the port's device= (a "
                     "torch.device) picks the profile and the tuned key",
    "(block_h)": "a Pallas BlockSpec's row tile; the CUDA kernels pick "
                 "their own tiles",
    "(block_x)": "a Pallas BlockSpec's X tile; the CUDA kernels pick "
                 "their own tiles",
    "(bm)": "the Pallas matmul's row tile; K5 picks its own tiles",
    "(bn)": "the Pallas matmul's column tile; K5 picks its own tiles",
    "(bk)": "the Pallas matmul's depth tile; K5 picks its own tiles",
    "(key)": "a JAX PRNG key; the port draws from a torch.Generator "
             "(generator=), and a model is drawn when it is built",
    "(api)": "JAX's functional ModelApi; the port passes the model "
             "module (model)",
    "(params)": "the parameters live in the nn.Module",
    "(params_f32)": "the fp32 masters live in the master model "
                    "(init_train_state)",
    "(cfg)": "an LM module holds its ModelConfig (self.cfg)",
    "(p)": "a block's parameters are its module's own",
    "(shardings)": NAMED_SHARDING,
    "(state_shardings)": NAMED_SHARDING,
    # names and parameters of one function
    "core/autotune.py:BLOCK_H_CANDIDATES":
        "Pallas row tiles to sweep; the CUDA kernels pick their own",
    "core/boundary.py:DirichletBC.set_boundary(x)":
        "positional; the port's alias of apply_mask_trick names it out",
    "kernels/tiling.py:tpu_compiler_params": "Mosaic's compiler params",
    "kernels/tiling.py:default_interpret": "Pallas's interpret mode",
    "kernels/tiling.py:shift2d": "a Pallas kernel body's shifted read",
    "kernels/tiling.py:halo_block_spec": "a Pallas BlockSpec",
    "launch/dryrun.py:parse_collectives": HLO_TEXT,
    "launch/hlo_cost.py:Instr": HLO_TEXT,
    "launch/hlo_cost.py:parse_module": HLO_TEXT,
    "launch/hlo_cost.py:analyze(text)": HLO_TEXT,
    "models/encdec.py:encode(sharder)": MODULE_SHARDS,
    "models/encdec.py:decode_train(sharder)": MODULE_SHARDS,
    "models/encdec.py:encdec_cache_shapes(dtype)": MODEL_DTYPE,
    "models/mlp.py:mlp_apply(sharder)": MODULE_SHARDS,
    "models/moe.py:moe_apply(sharder)":
        "the sharded MoE layer is moe.moe_sharded",
    "models/ssm.py:mamba2_apply(sharder)":
        "the sharded mixer is ssm.mamba2_sharded",
    "models/solver_layer.py:solver_forward(sharder)":
        "JAX's sharder only hints the source's layout (Sharder.constrain); "
        "the port runs the solver family unsharded",
    "models/solver_layer.py:solver_loss_fn(sharder)":
        "JAX's sharder only hints the source's layout (Sharder.constrain); "
        "the port runs the solver family unsharded",
    "models/solver_layer.py:solver_loss_fn(compute_dtype)":
        "JAX accepts and drops it: the solve runs fp32",
    "models/transformer.py:attn_apply(sharder)": MODULE_SHARDS,
    "models/transformer.py:attn_decode_apply(sharder)": MODULE_SHARDS,
    "models/transformer.py:attn_decode_apply(cache)":
        "the cache comes as its two tensors, k_cache and v_cache",
    "models/transformer.py:dense_block(sharder)": MODULE_SHARDS,
    "models/transformer.py:dense_block(mode)":
        "JAX's mode switch is the block's method: forward or decode",
    "models/transformer.py:dense_block(cache)":
        "DenseBlock.decode takes the cache as k_cache and v_cache",
    "models/transformer.py:dense_block(kv_len)": "DenseBlock.decode's",
    "models/transformer.py:mamba_block(sharder)": MODULE_SHARDS,
    "models/transformer.py:mamba_block(mode)":
        "JAX's mode switch is the block's method: forward, prefill or "
        "decode",
    "models/transformer.py:mamba_block(cache)": "MambaBlock.decode's",
    "models/transformer.py:cache_shapes(dtype)": MODEL_DTYPE,
    "models/transformer.py:init_cache(dtype)": MODEL_DTYPE,
    "models/transformer.py:prefill(dtype)": MODEL_DTYPE,
    "parallel/halo.py:shard_map_compat": "jax.shard_map across versions",
    "parallel/halo.py:exchange_1d(xl)":
        "one shard's block under shard_map; the port takes every tile",
    "parallel/halo.py:exchange_1d(axis_name)": "a shard_map axis name",
    "parallel/halo.py:exchange_1d(n)": "the shard count: len(tiles)",
    "parallel/halo.py:exchange_halo_2d(xl)":
        "one shard's block under shard_map; the port takes every tile",
    "parallel/halo.py:exchange_halo_2d(row_axis)":
        "a shard_map axis name; the port takes the extent, n_row",
    "parallel/halo.py:exchange_halo_2d(col_axis)":
        "a shard_map axis name; the port takes the extent, n_col",
    "parallel/sharding.py:Sharder.sharding": NAMED_SHARDING,
    "parallel/sharding.py:Sharder.opt_sharding": NAMED_SHARDING,
    "parallel/sharding.py:Sharder.constrain":
        "jax.lax.with_sharding_constraint, a layout hint to XLA",
    "train/train_step.py:cast_tree(tree)":
        "the masters come by name (params) into the compute model",
    "train/train_step.py:cast_tree(dtype)": "the compute model's type",
    "train/train_step.py:make_train_step(loss)":
        "no caller passes one: the loss is the family's, JAX's default",
    "train/train_step.py:loss_fn(compute_dtype)":
        "the loss runs on the compute model, already in that type "
        "(compute_model, load_params)",
}

MODULES = sorted(
    os.path.relpath(os.path.join(d, f), JAX_ROOT).replace(os.sep, "/")
    for d, _, fs in os.walk(JAX_ROOT) for f in fs if f.endswith(".py"))


def _params(fn: ast.FunctionDef) -> list[str]:
    a = fn.args
    return [p.arg for p in a.posonlyargs + a.args + a.kwonlyargs
            if p.arg not in ("self", "cls")]


def _public(name: str) -> bool:
    return not name.startswith("_")


def _assigned(node) -> list[str]:
    targets = node.targets if isinstance(node, ast.Assign) else [node.target]
    return [n.id for t in targets for n in ast.walk(t)
            if isinstance(n, ast.Name)]


def jax_surface(rel: str) -> dict[str, list[str] | None]:
    """{qualified name: its parameter names, or None for a non-function}
    of the JAX module ``rel``."""
    tree = ast.parse(open(os.path.join(JAX_ROOT, rel)).read(), filename=rel)
    out: dict[str, list[str] | None] = {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if _public(node.name):
                out[node.name] = _params(node)
        elif isinstance(node, ast.ClassDef) and _public(node.name):
            out[node.name] = None
            for m in node.body:
                if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    if _public(m.name) or m.name in ("__init__", "__call__"):
                        out[f"{node.name}.{m.name}"] = _params(m)
                elif isinstance(m, (ast.Assign, ast.AnnAssign)):
                    for n in _assigned(m):
                        if _public(n):
                            out[f"{node.name}.{n}"] = None
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            names = _assigned(node)
            if names == ["__all__"]:
                for e in node.value.elts:
                    out.setdefault(e.value, None)
            for n in names:
                if _public(n):
                    out.setdefault(n, None)
    return out


def port_module_name(rel: str) -> str:
    parts = rel[:-len(".py")].split("/")
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(["repro_torch", *parts])


_MISSING = object()


def _member(obj, name: str):
    """``obj.name`` by hasattr, or a dataclass field or annotated
    attribute without a class-level value (present, no object)."""
    if hasattr(obj, name):
        return getattr(obj, name)
    if inspect.isclass(obj):
        if dataclasses.is_dataclass(obj) and name in {
                f.name for f in dataclasses.fields(obj)}:
            return None
        for klass in obj.__mro__:
            if name in getattr(klass, "__annotations__", {}):
                return None
    return _MISSING


def _lookup(rel: str, qual: str):
    """The port's object at ``rel:qual``, or _MISSING."""
    obj = importlib.import_module(port_module_name(rel))
    for part in qual.split("."):
        obj = _member(obj, part)
        if obj is _MISSING:
            return _MISSING
    return obj


def _target(target: str):
    """A COUNTERPART target: the port's object, None where it is a
    constructor's parameter, or _MISSING."""
    rel, qual = target.split(":")
    if qual.endswith(")"):
        qual, param = qual[:-1].split("(")
        fn = _lookup(rel, qual)
        return (None if fn is not _MISSING and param in _signature(fn)
                else _MISSING)
    return _lookup(rel, qual)


def _signature(obj) -> set[str]:
    try:
        return set(inspect.signature(obj).parameters)
    except (TypeError, ValueError):
        return set()


def _resolve(rel: str, qual: str, own: bool = True):
    """The port's counterpart of JAX's ``rel:qual``: the COUNTERPART entry
    of the name (unless ``own`` is False) or of its class, else the name
    at the same path."""
    key = f"{rel}:{qual}"
    if own and key in COUNTERPART:
        return _target(COUNTERPART[key])
    if "." in qual:
        owner, name = qual.rsplit(".", 1)
        parent = _resolve(rel, owner)
        return _MISSING if parent in (_MISSING, None) else \
            _member(parent, name)
    return _lookup(rel, qual)


def _gaps(rel: str) -> tuple[list[str], set[str]]:
    """(the names and parameters of ``rel`` that the port lacks without a
    stated reason or that the maps misname, the global parameters of
    ALLOWED that excused a gap)."""
    surface = jax_surface(rel)
    excused: set[str] = set()
    gaps = []
    for qual, params in surface.items():
        key = f"{rel}:{qual}"
        owners = [".".join(qual.split(".")[:i])
                  for i in range(1, qual.count(".") + 1)]
        if any(f"{rel}:{o}" in ALLOWED for o in owners):
            continue                    # its class is JAX-only
        obj = _resolve(rel, qual)
        if key in ALLOWED:
            if obj is not _MISSING:
                gaps.append(f"ALLOWED {key}: the port has it")
            continue
        if obj is _MISSING:
            gaps.append(key)
            continue
        have = _signature(obj) if params else set()
        for p in params or ():
            if p in have:
                if f"{key}({p})" in ALLOWED:
                    gaps.append(f"ALLOWED {key}({p}): the port has it")
            elif f"({p})" in ALLOWED and f"{key}({p})" not in ALLOWED:
                excused.add(f"({p})")
            elif f"{key}({p})" not in ALLOWED:
                gaps.append(f"{key}({p})")
    for key, target in COUNTERPART.items():
        if not key.startswith(rel + ":"):
            continue
        qual = key.split(":", 1)[1]
        if qual not in surface:
            gaps.append(f"COUNTERPART {key}: JAX has no such name")
        elif _target(target) is _MISSING:
            gaps.append(f"COUNTERPART {key}: the port has no {target}")
        elif _resolve(rel, qual, own=False) is not _MISSING:
            gaps.append(f"COUNTERPART {key}: the port has it where JAX "
                        f"does")
    for key in ALLOWED:
        if not key.startswith(rel + ":"):
            continue
        name, _, param = key.split(":", 1)[1].partition("(")
        if name not in surface or (param and param[:-1]
                                   not in (surface[name] or ())):
            gaps.append(f"ALLOWED {key}: JAX has no such name")
    return gaps, excused


@pytest.mark.parametrize("rel", MODULES)
def test_port_has_every_public_name(rel):
    gaps, _ = _gaps(rel)
    assert not gaps, "\n".join(gaps)


def test_maps_name_only_real_gaps():
    """Every global ALLOWED parameter excuses a gap somewhere, and every
    map key names a JAX module."""
    excused: set[str] = set()
    for rel in MODULES:
        excused |= _gaps(rel)[1]
    stale = {k for k in ALLOWED if k.startswith("(")} - excused
    assert not stale, f"ALLOWED parameters no port function lacks: {stale}"
    for key in [*COUNTERPART, *ALLOWED]:
        if not key.startswith("("):
            assert key.split(":")[0] in MODULES, key
    assert all(reason.strip() for reason in ALLOWED.values())


def test_core_all_covers_jax():
    import repro_torch.core as T
    names = jax_surface("core/__init__.py")
    tree = ast.parse(open(os.path.join(JAX_ROOT, "core/__init__.py")).read())
    jax_all = next(n.value for n in tree.body
                   if isinstance(n, ast.Assign)
                   and _assigned(n) == ["__all__"])
    missing = {e.value for e in jax_all.elts} - set(T.__all__)
    assert not missing, missing
    assert set(names) <= set(dir(T)) | set(T.__all__)
