"""The training step — the port of the JAX package's ``train/train_step.py``:
bf16 compute off fp32 master params, the chunked cross-entropy, the AdamW
update, on one device or, given a ``Sharder`` of more than one shard, on a
mesh (``make_train_step(..., sharder=)``).

JAX differentiates ``loss_fn`` through ``cast_tree`` (fp32 master -> bf16
compute copy), so each gradient is the compute-type gradient cast to fp32.
The port does the same in two halves: a module in the compute type (the
"compute model") is loaded from the masters at the start of each step, and
the gradients of its parameters, in the compute type, go to
``optim.adamw.apply_update``, which casts each to fp32 as JAX's update does.
``torch.func.functional_call`` with the bf16 copies as its parameters would
be closer to JAX's form, but the layer checkpoints recompute their forward
in the backward, after ``functional_call`` has put the module's own
parameters back, and would silently differentiate those.

A leaf whose ``ParamDef`` pins its type (the Mamba2 mixer's ``A_log``, ``D``
and ``dt_bias``, the MoE router: fp32) keeps it in the compute model, as
the JAX package's ``init_params`` and ``stack_tables`` keep it in every
model it builds, but holds the master's values rounded through the compute
type: JAX's ``cast_tree`` rounds every leaf, those included.  For the
router that matters: its logits then come from the same numbers as JAX's,
so the same experts are picked and the same tokens dropped.  The pinned
leaves' gradients stay fp32 (JAX rounds them to bf16 on the way back).

Where the compute type is the masters' (fp32 compute), the compute model is
the master model itself and nothing is copied.  A solver-family model
(``models/solver_layer.py``) always trains in fp32 on its masters, with
the steady-state MSE as its loss, whatever ``compute_dtype`` says.

Under a sharder the forward and the loss run shard by shard
(the family's shard program, ``train/loss.sharded_xent``) in one
autograd graph over every shard: each shard's weights are pieces of the
compute model's parameters, so a parameter's gradient is the sum of its
pieces' and replicas' gradients (the mesh axes its spec leaves unused).
The loss is the global token mean.  AdamW then runs on the ``opt_spec``
slices (ZeRO-1: the spec, plus the largest free dim over data), each on
its owner shard's device, and writes them back into the masters, which
the next step's pieces are cut from: the gather.  The grad norm counts
each distinct slice once.  The masters, m and v are held whole on the
model's device; on one card every slice is a view of them.  A mesh of one
shard takes the unsharded path.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.models.layers import param_shapes, rms_norm
from repro_torch.models.model_zoo import batch_inputs
from repro_torch.models.transformer import StackedModel
from repro_torch.optim.adamw import AdamWConfig, apply_update, init_state
from repro_torch.parallel.pipeline import gpipe, split_stages
from repro_torch.train.loss import chunked_xent

MOE_AUX_WEIGHT = 0.01


def loss_fn(model: StackedModel, batch: dict, *, remat: bool = True,
            sharder=None):
    """(loss, {"nll", "aux"}) of ``batch`` ({tokens, labels} and the
    family's inputs, ``model_zoo.batch_inputs``) under the model's own
    parameters, in its type: JAX's chunked cross-entropy over every
    position (a vlm's vision positions too), sharded by ``sharder``."""
    kw = {} if sharder is None else {"sharder": sharder}
    hidden, aux = model(batch["tokens"], remat=remat,
                        **batch_inputs(model.cfg, batch), **kw)
    nll = chunked_xent(model.lm_head, hidden, batch["labels"],
                       sharder=sharder, valid_vocab=model.cfg.vocab_size)
    return nll + MOE_AUX_WEIGHT * aux, {"nll": nll, "aux": aux}


def pipelined_loss_fn(model: StackedModel, batch: dict, mesh, *,
                      n_microbatches: int, stage_axis: str = "stage"):
    """(loss, {"nll", "aux"}) as ``loss_fn`` without remat, with the
    dense layers run as a GPipe pipeline (``parallel.pipeline.gpipe``) of
    ``mesh.shape[stage_axis]`` stages of contiguous layers over
    ``n_microbatches`` microbatches (JAX's pipeline dry-run step,
    ``launch/dryrun_pp.py``, with the model's own loss): the embedding on
    the model's device, the stages on theirs, the final norm and the
    chunked cross-entropy back on the model's.  Each layer's weights are
    its slice of the stacked (n_layers, ...) parameters, so the gradients
    reach the layers' own parameters."""
    cfg = model.cfg
    if cfg.family != "dense":
        raise NotImplementedError(f"{cfg.arch}: the pipeline runs the dense "
                                  f"family's blocks, not {cfg.family}")
    template = model.layers[0]
    names = [n for n, _ in template.named_parameters()]
    stacked = {n: torch.stack([layer.get_parameter(n)
                               for layer in model.layers]) for n in names}
    staged = split_stages(stacked, mesh.shape[stage_axis])
    tokens = batch["tokens"]
    S = tokens.shape[1]

    def stage_fn(p: dict, x: torch.Tensor) -> torch.Tensor:
        pos = torch.arange(S, device=x.device).expand(x.shape[0], S)
        for j in range(p[names[0]].shape[0]):
            x = torch.func.functional_call(
                template, {n: p[n][j] for n in names}, (x, pos))[0]
        return x

    pipe = gpipe(stage_fn, mesh, stage_axis, n_microbatches)
    hidden = rms_norm(pipe(staged, model._embed(tokens)), model.final_norm,
                      cfg.norm_eps)
    nll = chunked_xent(model.lm_head, hidden, batch["labels"],
                       valid_vocab=cfg.vocab_size)
    return nll, {"nll": nll, "aux": torch.zeros((), device=nll.device)}


def compute_model(model: StackedModel,
                  compute_dtype: torch.dtype) -> StackedModel:
    """``model`` itself if it is in ``compute_dtype``, else an empty module
    of its config in that type on its device (leaves that pin their type
    keep it)."""
    if model.dtype == compute_dtype:
        return model
    return type(model)(model.cfg, device=model.device, dtype=compute_dtype)


def _same_memory(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether a and b are one tensor's memory (on ``meta`` too, where
    every data_ptr is 0)."""
    return (a.untyped_storage()._cdata == b.untyped_storage()._cdata
            and a.storage_offset() == b.storage_offset())


@torch.no_grad()
def load_params(compute: StackedModel, params: dict) -> None:
    """Copy the named fp32 masters into the compute model, each cast to the
    compute type (JAX's ``cast_tree``); a pinned leaf keeps its own type
    and holds the rounded values."""
    for name, p in compute.named_parameters():
        src = params[name]
        if _same_memory(p, src):
            continue
        if p.dtype != compute.dtype:
            src = src.to(compute.dtype)
        p.copy_(src)


def value_and_grad(compute: StackedModel, params: dict, batch: dict,
                   loss_of=loss_fn):
    """(loss, its parts, {name: grad in the compute type}) of the masters
    ``params`` on ``batch``, through ``compute``, under ``loss_of(model,
    batch) -> (loss, parts)``."""
    load_params(compute, params)
    names, leaves = zip(*compute.named_parameters())
    loss, parts = loss_of(compute, batch)
    grads = torch.autograd.grad(loss, leaves)
    return (loss.detach(), {k: t.detach() for k, t in parts.items()},
            dict(zip(names, grads)))


def make_train_step(model: StackedModel, opt: AdamWConfig,
                    compute_dtype: torch.dtype = torch.bfloat16, *,
                    sharder=None):
    """train_step(state, batch) -> (state, metrics {loss, nll, aux,
    grad_norm, lr}; a solver layer's {loss, mse, aux, grad_norm, lr}) for
    the masters of ``model``'s config; the state is updated in place
    (``apply_update``).  ``sharder``: run it on its mesh (the module
    docstring); the solver family, which has no sharded execution, raises
    ``NotImplementedError`` on a mesh of more than one shard."""
    if sharder is not None and sharder.trivial:
        sharder = None
    if getattr(model.cfg, "family", None) == "solver":
        if sharder is not None:
            raise NotImplementedError(
                "the solver family has no sharded execution in the port")
        # Convergence thresholds are meaningless in bf16: fp32, no copy.
        from repro_torch.models.solver_layer import solver_loss_fn
        compute, loss_of = model, solver_loss_fn
    else:
        compute = compute_model(model, compute_dtype)
        loss_of = functools.partial(loss_fn, sharder=sharder)
    dims = compute.param_dims_by_name() if sharder is not None else None

    def train_step(state: dict, batch: dict):
        loss, parts, grads = value_and_grad(compute, state["params"], batch,
                                            loss_of)
        state, opt_metrics = apply_update(state, grads, opt, sharder=sharder,
                                          dims=dims)
        return state, {"loss": loss, **parts, **opt_metrics}

    return train_step


def state_dims(model: StackedModel) -> dict:
    """The train state's logical dims in JAX's layout (JAX's
    ``state_dims``): the parameters' for params, m and v, () for the
    step."""
    pdims = model.dims()
    return {"params": pdims, "m": pdims, "v": pdims, "step": ()}


def state_shapes(model: StackedModel) -> dict:
    """The train state's stand-ins in JAX's layout (JAX's
    ``state_shapes``): fp32 params, m and v as empty ``meta`` tensors (a
    leaf that pins its type keeps it in params), an int32 step."""
    params = param_shapes(model.param_table(model.cfg), torch.float32)

    def zeros(tree):
        return {k: zeros(v) if isinstance(v, dict) else
                torch.empty(v.shape, dtype=torch.float32, device="meta")
                for k, v in tree.items()}
    return {"params": params, "m": zeros(params), "v": zeros(params),
            "step": torch.empty((), dtype=torch.int32, device="meta")}


def init_train_state(model: StackedModel) -> dict:
    """The train state of an fp32 master model (``model_zoo.build(cfg,
    dtype=torch.float32)``, or a solver layer): its parameters, shared, and
    fp32 zeros for m and v; the step updates the model in place."""
    if model.dtype != torch.float32:
        raise ValueError(f"the masters must be float32, got {model.dtype}")
    return init_state({n: p.detach() for n, p in model.named_parameters()})
